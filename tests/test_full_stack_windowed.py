"""Full-stack E2E on the WINDOWED device data plane.

The windowed engines (`pipeline_window.Windowed*`) as the live PHY under
`apps/full_stack.py` — the reference's sf_worker pipeline role
(`srsenb/src/phy/sf_worker.cc:166`, `srsue/src/phy/cc_worker.cc:214`,
N subframes in flight via `thread_pool.h:46-77`): attach runs on the
host control path, then every data PDSCH/PUSCH subframe flows through
W-TTI windows with HARQ feedback stretched to 4+W on both ends
(`apps/windowed_plane.py` timing contract).
"""

import numpy as np
import pytest

from srsran_tpu.apps.full_stack import EnbStack, UeStack
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.common import Cell
from srsran_tpu.stack import security as sec
from srsran_tpu.stack.nas_ue import Usim

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
W = 4


def _make_link(tm=1, nof_ports=1, nrx=1):
    cell = Cell(nof_prb=15, nof_ports=nof_ports, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5, tm=tm,
                   windowed_phy=True, phy_window=W)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), tm=tm, nrx=nrx,
                 windowed_phy=True, phy_window=W)
    return cell, enb, ue, mme, spgw


@pytest.fixture(scope="module")
def attached():
    cell, enb, ue, mme, spgw = _make_link()
    ul = None
    for tti in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if ue.rrc_state == UeStack.RRC_ACTIVE and enb.rrc_state == EnbStack.RRC_ACTIVE:
            if ue.nas.state == ue.nas.REGISTERED:
                break
    return cell, enb, ue, mme, spgw


def test_attach_completes_windowed(attached):
    cell, enb, ue, mme, spgw = attached
    assert enb.stats["prach_detected"] == 1
    assert ue.nas.state == ue.nas.REGISTERED
    assert IMSI in mme.attached_imsis
    assert ue.cipher_alg == 2 and ue.integ_alg == 2


def test_downlink_ip_traffic_rides_windows(attached):
    cell, enb, ue, mme, spgw = attached
    pkts = [bytes([i]) * 60 for i in range(4)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    ul = None
    win_before = ue._win_dl.stats["ttis"]
    for _ in range(60):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    # the data actually flowed through the windowed engine
    assert ue._win_dl.stats["ttis"] > win_before
    assert ue._win_dl.stats["windows"] >= 1
    ue.ip_rx.clear()


def test_uplink_ip_traffic_rides_windows(attached):
    cell, enb, ue, mme, spgw = attached
    pkts = [bytes([0x40 + i]) * 50 for i in range(3)]
    for p in pkts:
        ue.send_ip_packet(p)
    ul = None
    win_before = enb._win_ul.stats["ttis"]
    for _ in range(80):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(spgw.sgi_rx) >= len(pkts):
            break
    got = [pl for _, pl in spgw.sgi_rx]
    assert got[: len(pkts)] == pkts
    assert enb._win_ul.stats["ttis"] > win_before
    assert enb._win_ul.stats["windows"] >= 1
    spgw.sgi_rx.clear()


def test_windowed_dl_harq_recovers_outage():
    """Cross-window DL HARQ: corrupt the DL link for a stretch so windowed
    decodes fail, then restore — soft-combining retransmissions through the
    plane's device softbuffers must recover the packets."""
    cell, enb, ue, mme, spgw = _make_link()
    ul = None
    for tti in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([0x70 + i]) * 80 for i in range(6)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    rng = np.random.default_rng(5)
    for i in range(30):
        dl = enb.run_tti(ul)
        # noise level where the aggregation-protected PDCCH (host control
        # path) mostly survives but windowed turbo decodes fail
        dl = dl + (1.2 * (rng.standard_normal(dl.shape)
                          + 1j * rng.standard_normal(dl.shape))).astype(np.complex64)
        ul = ue.run_tti(dl)
    for _ in range(100):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    # windowed decodes actually failed and the HARQ chain (device-resident
    # softbuffer carry across windows) recovered every packet
    assert ue._win_dl.stats["crc_ko"] > 0


def test_windowed_tm2_two_port():
    """TM2 (SFBC, 2-port cell) on the windowed diversity scheme."""
    cell, enb, ue, mme, spgw = _make_link(tm=2, nof_ports=2)
    ul = None
    for tti in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([9]) * 40, bytes([8]) * 40]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(60):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    assert ue._win_dl.stats["ttis"] > 0


# well-conditioned 2x2 channel (rank 2) for the MIMO plane
H_RANK2 = np.array([[1.0 + 0.1j, 0.2 - 0.6j],
                    [-0.5 + 0.3j, 0.9 + 0.0j]], np.complex64)


@pytest.mark.parametrize("tm", [3, 4])
def test_windowed_tm34_two_codeword_traffic(tm):
    """TM3/TM4 2-codeword traffic on the windowed MIMO plane
    (WindowedUeDlMimo): RI=2 feedback turns into DCI 2/2A grants whose
    PDSCH pairs decode through W-TTI windows."""
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber

    cell = Cell(nof_prb=15, nof_ports=2, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=8, tm=tm,
                   windowed_phy=True, phy_window=W)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), tm=tm, nrx=2,
                 windowed_phy=True, phy_window=W)
    ul = None

    def step():
        nonlocal ul
        dl = enb.run_tti(ul)  # (2, sf_len) port streams
        rx = np.einsum("rp,pt->rt", H_RANK2, np.asarray(dl)).astype(np.complex64)
        ul = ue.run_tti(rx)

    for _ in range(150):
        step()
        if ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED:
            break
    assert ue.nas.state == ue.nas.REGISTERED

    pkts = [bytes([i]) * 200 for i in range(40)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(300):
        step()
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    # the MIMO windowed engine actually carried subframes
    assert ue._win_dl.mimo and ue._win_dl.stats["ttis"] > 0
