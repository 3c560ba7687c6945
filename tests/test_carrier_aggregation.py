"""R10 carrier aggregation: RRC SCell configuration (golden-validated
against the reference's generated codec), the MAC Activation/Deactivation
CE, and a 2-CC downlink E2E through the full stack.

The reference supports CA via per-carrier cc_workers
(srsue/src/phy/cc_worker.cc carrier loop, SRSLTE_MAX_CARRIERS=5) and the
RRC scell_to_add_mod_r10 machinery (rrc_asn1.h:27377).
"""

import numpy as np

from srsran_tpu.phy.common import Cell
from srsran_tpu.stack import rrc
from srsran_tpu.stack.asn1 import rrc as asn1
from srsran_tpu.stack.mac_pdu import (
    LCID_SCELL_ACT,
    scell_activation_ce,
    scell_activation_parse,
)

# produced by the reference's own generated codec (rrc_asn1.cc compiled
# with a small driver): RRCConnectionReconfiguration carrying
# sCellToAddModList-r10 through the v890→v920→v1020 extension chain
GOLDEN_ONE_SCELL = bytes.fromhex("2200a50c0101a90044f0")
# + sCellToReleaseList [3], second SCell with n100/an2/extended-PHICH,
# pdsch refSigPwr -10 / p-b 1, and tdd-Config sa1/ssp4
GOLDEN_TWO_SCELLS_RELEASE = bytes.fromhex("2200a70960080d480227831faffff8d6324a00")


class TestScellAsn1:
    def test_golden_one_scell_bit_exact(self):
        v = asn1.DL_DCCH_MESSAGE.from_bytes(GOLDEN_ONE_SCELL)
        assert asn1.DL_DCCH_MESSAGE.to_bytes(v) == GOLDEN_ONE_SCELL
        kind, body = rrc.unpack_dl_dcch(GOLDEN_ONE_SCELL)
        adds, rels = rrc.reconfiguration_scells(body)
        assert kind == "rrc_conn_recfg" and rels == []
        assert len(adds) == 1
        sc = adds[0]
        assert sc["scell_idx"] == 1
        assert sc["cell_identif"] == {"phys_cell_id": 8, "dl_carrier_freq": 3400}
        nul = sc["rr_cfg_common_scell"]["non_ul_cfg"]
        assert nul["dl_bw"] == "n15"
        assert nul["ant_info_common"]["ant_ports_count"] == "an1"
        assert nul["phich_cfg"] == {"phich_dur": "normal", "phich_res": "one"}
        assert nul["pdsch_cfg_common"] == {"ref_sig_pwr": 0, "p_b": 0}

    def test_golden_two_scells_release_bit_exact(self):
        v = asn1.DL_DCCH_MESSAGE.from_bytes(GOLDEN_TWO_SCELLS_RELEASE)
        assert asn1.DL_DCCH_MESSAGE.to_bytes(v) == GOLDEN_TWO_SCELLS_RELEASE
        _, body = rrc.unpack_dl_dcch(GOLDEN_TWO_SCELLS_RELEASE)
        adds, rels = rrc.reconfiguration_scells(body)
        assert rels == [3]
        assert [a["scell_idx"] for a in adds] == [1, 2]
        n2 = adds[1]["rr_cfg_common_scell"]["non_ul_cfg"]
        assert adds[1]["cell_identif"] == {"phys_cell_id": 501, "dl_carrier_freq": 65535}
        assert n2["dl_bw"] == "n100"
        assert n2["pdsch_cfg_common"] == {"ref_sig_pwr": -10, "p_b": 1}
        assert n2["tdd_cfg"] == {"sf_assign": "sa1", "special_sf_patterns": "ssp4"}

    def test_pack_reconfiguration_roundtrip(self):
        msg = rrc.pack_reconfiguration(
            scells=[rrc.make_scell_config(1, 77, 3400, 50, nof_ports=2)],
            scell_release=[2, 4],
        )
        _, body = rrc.unpack_dl_dcch(msg)
        adds, rels = rrc.reconfiguration_scells(body)
        assert rels == [2, 4]
        assert adds[0]["cell_identif"]["phys_cell_id"] == 77
        assert adds[0]["rr_cfg_common_scell"]["non_ul_cfg"]["dl_bw"] == "n50"

    def test_plain_reconfiguration_unchanged(self):
        # no CA content → no extension chain on the wire (golden safety)
        msg = rrc.pack_reconfiguration(drb_id=1, lcid=3, eps_bearer_id=5)
        _, body = rrc.unpack_dl_dcch(msg)
        assert rrc.reconfiguration_scells(body) == ([], [])
        assert "non_crit_ext" not in body


class TestActivationCe:
    def test_roundtrip(self):
        ce = scell_activation_ce({1, 3, 7})
        assert len(ce) == 1 and ce[0] & 1 == 0  # R bit clear
        assert scell_activation_parse(ce) == {1, 3, 7}
        assert scell_activation_parse(scell_activation_ce([])) == set()
        assert LCID_SCELL_ACT == 27


class TestCaE2e:
    def test_two_cc_attach_and_dl_traffic(self):
        """Attach on the PCell, SCell configured via the (golden-validated)
        reconfiguration + activated via the MAC CE, then DL IP traffic is
        served across BOTH carriers — the reference's 2×CA headline path."""
        from srsran_tpu.apps.full_stack import EnbStack, UeStack
        from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
        from srsran_tpu.stack import security as sec
        from srsran_tpu.stack.nas_ue import Usim

        imsi = "001010123456789"
        key = bytes.fromhex("00112233445566778899aabbccddeeff")
        opc = sec.compute_opc(key, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
        pcell = Cell(nof_prb=15, nof_ports=1, id=7)
        scell = Cell(nof_prb=15, nof_ports=1, id=8)
        hss = Hss()
        hss.add_subscriber(Subscriber("ue1", imsi, key, opc, amf=b"\x80\x00", sqn=0))
        spgw = Spgw()
        mme = Mme(hss, spgw)
        enb = EnbStack(pcell, mme, spgw, mcs=5, scell=scell)
        ue = UeStack(pcell, Usim(imsi, key, opc))

        ul = None
        for _ in range(160):
            dl = enb.run_tti(ul)
            assert dl.shape[0] == 2  # (n_cc, sf_len)
            ul = ue.run_tti(dl)
            if ue.scell_active:
                break
        assert ue.nas.state == ue.nas.REGISTERED
        assert ue.scell is not None and ue.scell.id == 8 and ue.scell.nof_prb == 15
        assert ue.scell_active
        assert enb.ues[ue.crnti].scell_state == 2

        # DL traffic: enough packets that both schedulers carry data
        pkts = [bytes([i]) * 80 for i in range(8)]
        for p in pkts:
            spgw.sgi_tx(ue.ue_ip, p)
        for _ in range(60):
            dl = enb.run_tti(ul)
            ul = ue.run_tti(dl)
            if len(ue.ip_rx) >= len(pkts):
                break
        assert sorted(ue.ip_rx) == sorted(pkts)
        assert ue.stats.get("scell_tbs_ok", 0) > 0  # SCell actually carried TBs
        # FDD CA HARQ-ACK multiplexing: the per-CC
        # ACK bits ride ONE PUCCH format-3 resource (pucch_proc.c:60-150;
        # occasions colliding with a PUSCH take the CA UCI-on-PUSCH leg)
        # and the eNB's SCell scheduler runs on REAL decoded feedback
        for i in range(16):
            spgw.sgi_tx(ue.ue_ip, bytes([0x30 + i]) * 80)
        for _ in range(120):
            dl = enb.run_tti(ul)
            ul = ue.run_tti(dl)
        assert ue.stats.get("ca_ack_f3_sent", 0) > 0, (ue.stats, enb.stats)
        assert enb.stats.get("ca_ack_f3_rx", 0) > 0, enb.stats
        assert (enb.stats["ca_ack_f3_rx"]
                + enb.stats.get("ca_ack_pusch_rx", 0)
                >= ue.stats["ca_ack_f3_sent"])


class TestUlCaE2e:
    def test_two_cc_ul_traffic(self):
        """UL carrier aggregation (phy_common.h:56 multi-carrier UL): BSRs
        credit both schedulers, DCI0s ride the SCell PDCCH, the UE
        transmits PUSCH on both carriers, and the eNB's SCell UL decode
        delivers the data — UL throughput is served across 2 CCs."""
        from srsran_tpu.apps.full_stack import EnbStack, UeStack
        from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
        from srsran_tpu.stack import security as sec
        from srsran_tpu.stack.nas_ue import Usim

        imsi = "001010123456789"
        key = bytes.fromhex("00112233445566778899aabbccddeeff")
        opc = sec.compute_opc(key, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
        pcell = Cell(nof_prb=15, nof_ports=1, id=7)
        scell = Cell(nof_prb=15, nof_ports=1, id=8)
        hss = Hss()
        hss.add_subscriber(Subscriber("ue1", imsi, key, opc, amf=b"\x80\x00", sqn=0))
        spgw = Spgw()
        mme = Mme(hss, spgw)
        enb = EnbStack(pcell, mme, spgw, mcs=5, scell=scell, ul_ca=True)
        ue = UeStack(pcell, Usim(imsi, key, opc))

        ul = None
        for _ in range(160):
            dl = enb.run_tti(ul)
            ul = ue.run_tti(dl)
            if ue.scell_active:
                break
        assert ue.scell_active and ue.nas.state == ue.nas.REGISTERED

        # a burst of UL data big enough that one carrier would need many
        # more TTIs — BSR splits it across both
        pkts = [bytes([0x60 + i]) * 120 for i in range(10)]
        for p in pkts:
            ue.send_ip_packet(p)
        for _ in range(120):
            dl = enb.run_tti(ul)
            ul = ue.run_tti(dl)
            if len(spgw.sgi_rx) >= len(pkts):
                break
        got = sorted(pl for _, pl in spgw.sgi_rx)
        assert got == sorted(pkts), f"got {len(got)}/{len(pkts)} UL packets"
        assert enb.stats.get("scell_ul_crc_ok", 0) >= 1, "SCell PUSCH never decoded"
        assert ue.stats.get("scell_pusch_tx", 0) >= 1
