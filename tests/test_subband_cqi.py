"""Subband CQI + frequency-selective scheduling (reference:
lib/src/phy/phch/cqi.c:41-118, TS 36.213 §7.2).

E2E: a frequency-selective channel (deep notch over part of the band)
steers the scheduler's PRB placement away from the notch via the
UE's higher-layer-configured subband reports — and measurably beats
wideband-only scheduling on delivered IP packets."""

import numpy as np
import pytest

from srsran_tpu.apps.full_stack import EnbStack, UeStack
from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.phch.uci import (
    CQI_DIFF_LEVEL,
    cqi_diff_encode,
    cqi_f2_subband_pack,
    cqi_f2_subband_unpack,
    cqi_hl_nof_subbands,
    cqi_hl_subband_pack,
    cqi_hl_subband_size,
    cqi_hl_subband_unpack,
    cqi_ue_subband_pack,
    cqi_ue_subband_unpack,
)
from srsran_tpu.stack import security as sec
from srsran_tpu.stack.nas_ue import Usim

IMSI = "001010123456789"
KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))


def test_subband_tables():
    # TS 36.213 Table 7.2.1-3 (cqi.c:608-634)
    assert cqi_hl_subband_size(6) == 0
    assert cqi_hl_subband_size(25) == 4 and cqi_hl_nof_subbands(25) == 7
    assert cqi_hl_subband_size(50) == 6 and cqi_hl_nof_subbands(50) == 9
    assert cqi_hl_subband_size(100) == 8 and cqi_hl_nof_subbands(100) == 13


def test_subband_codecs_roundtrip():
    n = cqi_hl_nof_subbands(25)
    diffs = [cqi_diff_encode(c, 9) for c in (9, 10, 12, 8, 2, 9, 11)]
    bits = cqi_hl_subband_pack(9, diffs)
    assert bits.size == 4 + 2 * n
    wb, out = cqi_hl_subband_unpack(bits, n)
    assert wb == 9 and out == diffs
    # Table 7.2.1-2 semantics: 3 encodes "<= -1"
    assert CQI_DIFF_LEVEL[cqi_diff_encode(2, 9)] == -1
    assert CQI_DIFF_LEVEL[cqi_diff_encode(11, 9)] == 2

    bits2 = cqi_ue_subband_pack(7, 1, 5, 3)
    assert bits2.size == 4 + 2 + 3
    assert cqi_ue_subband_unpack(bits2, 3) == (7, 1, 5)

    bits3 = cqi_f2_subband_pack(12, 2, True)
    assert bits3.size == 6
    assert cqi_f2_subband_unpack(bits3, True) == (12, 2)


def _notch_filter(cell: Cell, prb_lo: int, prb_hi: int, depth: float):
    """Frequency-domain mask attenuating PRBs [prb_lo, prb_hi) — applied
    per subframe on the link samples (a surgical frequency-selective
    channel; EPA-style but deterministic)."""
    n = cell.sf_len
    f = np.fft.fftfreq(n) * cell.symbol_sz  # in subcarrier units
    mask = np.ones(n, np.float32)
    lo = (prb_lo - cell.nof_prb / 2) * 12
    hi = (prb_hi - cell.nof_prb / 2) * 12
    sel = (f >= lo) & (f < hi)
    mask[sel] = depth
    return mask


def _run(subband: bool, n_ttis: int = 900):
    cell = Cell(nof_prb=25, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00",
                                  sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=12, subband_cqi=subband)
    enb.apcqi_interval = 60  # keep the subband reports fresh
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), subband_cqi=subband)
    mask = _notch_filter(cell, 12, 25, 10 ** (-25 / 20.0))
    rng = np.random.default_rng(3)

    def channel(s):
        x = np.fft.ifft(np.fft.fft(s) * mask).astype(np.complex64)
        return x + (0.015 * (rng.standard_normal(len(x))
                             + 1j * rng.standard_normal(len(x)))
                    ).astype(np.complex64)

    ul = None
    for tti in range(200):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(channel(dl))
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    for i in range(2500):  # saturating: more than either run can drain
        spgw.sgi_tx(ue.ue_ip, bytes([i & 0xFF]) * 150)
    allocs = []
    orig = enb.sched.get_dl_sched

    def spy(tti, **kw):
        out = orig(tti, **kw)
        for g in out:
            allocs.append((g.rb_start, g.l_crb))
        return out

    enb.sched.get_dl_sched = spy
    for _ in range(n_ttis):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(channel(dl))
    return enb, ue, allocs


@pytest.fixture(scope="module")
def fs_run():
    return _run(subband=True)


def test_subband_report_sees_the_notch(fs_run):
    enb, ue, _allocs = fs_run
    assert ue.stats.get("sb_cqi_sent", 0) > 0
    sched_ue = enb.sched.ues[ue.crnti]
    assert sched_ue.sb_cqi is not None
    sb = sched_ue.sb_cqi  # 7 subbands of 4 PRBs on 25 PRB
    # the notch covers PRBs 12-24 → subbands 3..6 must read worse
    assert min(sb[3:]) < min(sb[:3]), sb
    assert max(sb[:3]) - min(sb[3:]) >= 1, sb


def test_fs_scheduling_avoids_the_notch(fs_run):
    enb, ue, allocs = fs_run
    late = allocs[len(allocs) // 2:]
    assert late, "no DL allocations recorded"
    # frequency-selective placement keeps the allocation inside the
    # clean PRBs (0..12) for the overwhelming majority of grants
    inside = sum(1 for rb0, l in late if rb0 + l <= 13)
    assert inside >= 0.8 * len(late), (inside, len(late), late[:12])


def _run_two_ue(subband: bool, n_ttis: int = 700):
    """Two UEs with COMPLEMENTARY notches (UE1's upper half dead, UE2's
    lower half dead) — the canonical frequency-selective scheduling
    scenario: per-subband placement gives each UE its clean half, blind
    cursor packing alternates them into their own notches."""
    IMSI2 = "001010123456790"
    cell = Cell(nof_prb=25, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00",
                                  sqn=0))
    hss.add_subscriber(Subscriber("ue2", IMSI2, KEY, OPC, amf=b"\x80\x00",
                                  sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=12, subband_cqi=subband)
    enb.apcqi_interval = 60
    ue1 = UeStack(cell, Usim(IMSI, KEY, OPC), preamble=17,
                  subband_cqi=subband)
    ue2 = UeStack(cell, Usim(IMSI2, KEY, OPC), preamble=23,
                  attach_delay=40, subband_cqi=subband)
    m1 = _notch_filter(cell, 13, 25, 10 ** (-25 / 20.0))
    m2 = _notch_filter(cell, 0, 12, 10 ** (-25 / 20.0))
    rng = np.random.default_rng(9)

    def chan(s, mask):
        x = np.fft.ifft(np.fft.fft(s) * mask).astype(np.complex64)
        return x + (0.015 * (rng.standard_normal(len(x))
                             + 1j * rng.standard_normal(len(x)))
                    ).astype(np.complex64)

    def _sum(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return a + b

    ul1 = ul2 = None
    for _ in range(400):
        dl = enb.run_tti(_sum(ul1, ul2))
        ul1 = ue1.run_tti(chan(dl, m1))
        ul2 = ue2.run_tti(chan(dl, m2))
        if (ue1.nas.state == ue1.nas.REGISTERED
                and ue2.nas.state == ue2.nas.REGISTERED):
            break
    assert ue1.nas.state == ue1.nas.REGISTERED
    assert ue2.nas.state == ue2.nas.REGISTERED
    for i in range(1200):
        spgw.sgi_tx(ue1.ue_ip, bytes([i & 0xFF]) * 150)
        spgw.sgi_tx(ue2.ue_ip, bytes([i & 0xFF]) * 150)
    for _ in range(n_ttis):
        dl = enb.run_tti(_sum(ul1, ul2))
        ul1 = ue1.run_tti(chan(dl, m1))
        ul2 = ue2.run_tti(chan(dl, m2))
    return len(ue1.ip_rx) + len(ue2.ip_rx)


def test_fs_beats_wideband_goodput():
    got_fs = _run_two_ue(subband=True)
    got_wb = _run_two_ue(subband=False)
    # same channels, same offered load: per-subband placement delivers
    # measurably more than blind wideband packing.  (The gap is bounded
    # by honest link adaptation: the wideband CQI already lowers the MCS
    # enough to decode through the notch most of the time — measured
    # ~1.17x here; the assert keeps a seed-robust margin.)
    assert got_fs > 1.10 * max(1, got_wb), (got_fs, got_wb)
    assert got_fs >= got_wb + 100, (got_fs, got_wb)
