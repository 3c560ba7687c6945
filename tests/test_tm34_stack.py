"""Full-stack TM3/TM4: attach + 2-codeword traffic over a 2x2 channel.

Closes the loop: the UE measures rank from the
CRS estimates, reports RI (and PMI for TM4) as UCI-on-PUSCH, the eNB's
scheduler turns rank-2 reports into DCI 2/2A two-codeword grants, and the
UE decodes both codewords — the reference's 150 Mbps headline
configuration (README.md:47) as an end-to-end procedure.
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

# well-conditioned 2x2 channel (rank 2): the UE should report RI=2
H_RANK2 = np.array([[1.0 + 0.1j, 0.2 - 0.6j],
                    [-0.5 + 0.3j, 0.9 + 0.0j]], np.complex64)


def _core():
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    return Mme(hss, spgw), spgw


@pytest.mark.parametrize("tm", [3, 4])
def test_tm34_attach_and_two_codeword_traffic(tm):
    cell = Cell(nof_prb=15, nof_ports=2, id=7)
    mme, spgw = _core()
    enb = EnbStack(cell, mme, spgw, mcs=8, tm=tm)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), tm=tm, nrx=2)

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
    assert ue.nas.state == ue.nas.REGISTERED, "attach failed under 2x2 channel"

    # DL traffic: enough to span many TTIs → exercises 2-CW grants once
    # the RI=2 report lands; UL chatter keeps PUSCH (and UCI) flowing
    pkts = [bytes([i]) * 200 for i in range(40)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for i in range(300):
        if i % 25 == 0:
            ue.send_ip_packet(b"\x11" * 20)
        step()
        if len(ue.ip_rx) >= len(pkts):
            break
    assert enb.stats.get("ri_rx", 0) >= 1, "RI report must reach the eNB"
    u = next(iter(enb.ues.values()))
    assert u.last_ri == 2, "well-conditioned channel must yield RI=2"
    assert u.crnti in enb.sched.two_cw
    if tm == 4:
        assert enb.stats.get("cqi_rx", 0) >= 1  # PMI rides the CQI report
    # all packets delivered, and two-codeword PDSCH actually carried data
    assert ue.ip_rx[: len(pkts)] == pkts
    assert enb.stats.get("dl_2cw_tx", 0) >= 1, "no DCI 2/2A grant went on air"
    assert ue.stats.get("dl_tbs_ok", 0) > 0
