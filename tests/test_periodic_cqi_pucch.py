"""Periodic CQI/RI on PUCCH format 2 — the standing reporting loop.

The reference keeps link adaptation alive with NO
PUSCH traffic via periodic CQI on PUCCH 2 (`srsue/src/phy/cc_worker.cc:822`
set_uci_periodic_cqi).  Here: an attached-but-idle UE (SR-driven UL, so
no blind grants) reports wideband CQI on its dedicated format-2 resource
every CQI occasion; the eNB decodes it and the scheduler's MCS choice
tracks a degrading channel.
"""

import numpy as np

from srsran_tpu.apps.full_stack import EnbStack, UeStack
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.common import Cell
from srsran_tpu.stack import security as sec
from srsran_tpu.stack.nas_ue import Usim

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


def _attach():
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    # SR-driven UL grants: an idle UE gets NO PUSCH, so the CQI loop must
    # ride PUCCH format 2
    enb = EnbStack(cell, mme, spgw, mcs=20, sr_enabled=True)
    enb.ul_inactivity_timeout = 100000  # keep the idle UE attached
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), sr_enabled=True)
    ul = None
    for tti in range(200):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    return enb, ue, spgw


def _run(enb, ue, n, ul0, scale=1.0, noise=0.0, rng=None):
    ul = ul0
    for _ in range(n):
        dl = enb.run_tti(ul)
        dl = np.asarray(dl) * np.float32(scale)
        if noise:
            dl = (dl + noise * (rng.standard_normal(dl.shape)
                                + 1j * rng.standard_normal(dl.shape))
                  ).astype(np.complex64)
        ul = ue.run_tti(dl)
    return ul


def test_periodic_cqi_on_pucch2_tracks_channel():
    enb, ue, spgw = _attach()
    crnti = ue.crnti
    rng = np.random.default_rng(3)

    # --- clean phase: idle UE, reports ride PUCCH 2 ---
    ul = _run(enb, ue, 80, None)
    assert ue.stats.get("cqi_pucch_sent", 0) >= 5
    assert enb.stats.get("cqi_pucch_rx", 0) >= 5
    cqi_clean = enb.sched.ues[crnti].cqi
    assert cqi_clean >= 10

    # a large DL packet scheduled under the clean CQI uses a high MCS
    spgw.sgi_tx(ue.ue_ip, bytes(1200))
    ul = _run(enb, ue, 12, ul)
    mcs_clean = max(h.mcs for h in enb.sched.ues[crnti].dl_harq)
    assert len(ue.ip_rx) >= 1
    ue.ip_rx.clear()

    # --- degraded phase: attenuate + noise; the PUCCH2 loop reports the
    # drop with NO PUSCH traffic at all ---
    rx_before = enb.stats.get("cqi_pucch_rx", 0)
    ul = _run(enb, ue, 80, ul, scale=0.3, noise=0.08, rng=rng)
    assert enb.stats.get("cqi_pucch_rx", 0) > rx_before
    cqi_bad = enb.sched.ues[crnti].cqi
    assert cqi_bad < cqi_clean

    # the next DL grant adapts down
    spgw.sgi_tx(ue.ue_ip, bytes(1200))
    _run(enb, ue, 12, ul, scale=0.3, noise=0.08, rng=rng)
    mcs_bad = max((h.mcs for h in enb.sched.ues[crnti].dl_harq
                   if h.pdu is not None or h.pending_ack), default=None)
    if mcs_bad is None:
        mcs_bad = max(h.mcs for h in enb.sched.ues[crnti].dl_harq)
    assert mcs_bad < mcs_clean
