"""Randomized MAC scheduler + PDCCH grid property tests.

The reference validates its scheduler with randomized multi-UE
simulations asserting grid/HARQ invariants every TTI
(`srsenb/test/mac/scheduler_test_rand.cc`, `sched_grid_test.cc`).  This
is that harness for this stack: random UE populations, buffer
arrivals, CQI swings and ACK/NACK/DTX feedback, with per-TTI assertions
on PRB disjointness, HARQ state machine legality, CQI-driven MCS caps,
and PDCCH CCE allocation legality across UE + common search spaces.
"""

import numpy as np
import pytest

from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.phch.pdcch import nof_cce, search_space_candidates
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod
from srsran_tpu.stack.mac import CQI_TO_EFFICIENCY, HARQ_RV_SEQ, Scheduler
from srsran_tpu.stack.sched_grid import PdcchGrid, min_cfi_for, uses_common_space


class _Buf:
    """Byte-bucket bearer with the RLC read_pdu/buffer_state surface."""

    def __init__(self):
        self.n = 0

    def buffer_state(self):
        return self.n

    def read_pdu(self, max_bytes):
        if self.n == 0:
            return None
        take = min(self.n, max_bytes)
        self.n -= take
        return bytes(take)


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_invariants_random(seed):
    rng = np.random.default_rng(seed)
    nof_prb = int(rng.choice([15, 25, 50]))
    sched = Scheduler(nof_prb, mcs_max=int(rng.integers(5, 27)))
    n_ues = int(rng.integers(1, 6))
    rntis = [0x46 + i for i in range(n_ues)]
    bufs = {}
    for r in rntis:
        sched.ue_cfg(r)
        bufs[r] = _Buf()
        sched.bearer_ue_cfg(r, 3, bufs[r])

    # ack feedback queue: (due_tti, rnti, pid, ack)
    feedback = []
    ndi_seen: dict[tuple[int, int], tuple] = {}  # (rnti,pid) -> (ndi, tbs)
    inflight: dict[tuple[int, int], int] = {}    # (rnti,pid) -> retx count

    for tti in range(400):
        # random arrivals + CQI swings
        for r in rntis:
            if rng.random() < 0.4:
                bufs[r].n += int(rng.integers(20, 4000))
            if rng.random() < 0.2:
                sched.cqi_info(r, int(rng.integers(1, 16)))
        # deliver due feedback (random delay 4..12 models the windowed
        # plane's stretched HARQ timing)
        for due, r, pid, ack in list(feedback):
            if due <= tti:
                sched.ack_info(r, pid, ack)
                feedback.remove((due, r, pid, ack))
                # the process frees on ACK, or when the NACK exhausted the
                # retransmission budget (DlHarqProc.ack gives the TB up to
                # RLC retransmission — scheduler_harq.cc max_retx)
                if ack or inflight.get((r, pid), 0) > sched.max_retx:
                    inflight.pop((r, pid), None)

        n_re = 120 * nof_prb  # generous PDSCH RE estimate
        grants = sched.get_dl_sched(tti, pdsch_nof_re=n_re)

        # --- invariants ---
        seen_rnti = set()
        occupied = np.zeros(nof_prb, bool)
        for g in grants:
            # one grant per UE per TTI
            assert g.rnti not in seen_rnti
            seen_rnti.add(g.rnti)
            # PRBs inside the band and mutually disjoint
            assert 0 <= g.rb_start and g.rb_start + g.l_crb <= nof_prb
            assert not occupied[g.rb_start : g.rb_start + g.l_crb].any()
            occupied[g.rb_start : g.rb_start + g.l_crb] = True
            key = (g.rnti, g.harq_pid)
            if g.rv == 0 and key not in inflight:
                # new transmission: NDI must differ from the pid's last use
                last = ndi_seen.get(key)
                if last is not None:
                    assert g.ndi != last[0], "NDI did not toggle on new tx"
                ndi_seen[key] = (g.ndi, g.tbs_bits)
                inflight[key] = 1
                # CQI efficiency cap (scheduler_ue.cc alloc_tbs rule)
                if g.mcs > 0:  # the floor MCS is always admissible
                    ue_cqi = sched.ues[g.rnti].cqi
                    eff = (g.tbs_bits + 24) / max(1, n_re * g.l_crb // nof_prb)
                    qm = dl_mcs_to_mod(g.mcs).bits_per_symbol
                    assert eff <= min(CQI_TO_EFFICIENCY[ue_cqi], 0.93 * qm) + 1e-9
            else:
                # retransmission: same pid keeps NDI and TBS, rv follows
                # the redundancy sequence
                last = ndi_seen.get(key)
                assert last is not None, "retx for a pid never transmitted"
                assert g.ndi == last[0] and g.tbs_bits == last[1]
                txc = inflight.get(key, 1)
                assert g.rv == HARQ_RV_SEQ[txc % 4]
                inflight[key] = txc + 1
            # random ACK/NACK/DTX feedback at a random delay
            p = rng.random()
            if p < 0.6:
                feedback.append((tti + int(rng.integers(4, 13)), g.rnti,
                                 g.harq_pid, True))
            elif p < 0.9:
                feedback.append((tti + int(rng.integers(4, 13)), g.rnti,
                                 g.harq_pid, False))
            # else DTX: no feedback ever — the pid must NOT be reused
            # while pending (checked implicitly: a reuse would trip the
            # NDI/TBS assertions above)


@pytest.mark.parametrize("seed", range(6))
def test_pdcch_grid_invariants_random(seed):
    rng = np.random.default_rng(100 + seed)
    cell = Cell(nof_prb=int(rng.choice([15, 25, 50])), nof_ports=1, id=7)
    sf_idx = int(rng.integers(0, 10))
    cfi = int(rng.integers(1, 4))
    grid = PdcchGrid(cell, sf_idx, cfi)
    n = nof_cce(cell, sf_idx, cfi)
    rntis = ([0x46 + i for i in range(int(rng.integers(1, 8)))]
             + [0xFFFF, 0xFFFE, 1 + int(rng.integers(0, 10))])
    rng.shuffle(rntis)
    allocs = []
    for r in rntis:
        loc = grid.alloc(r)
        if loc is None:
            continue  # full control region — legal outcome
        agg, start = loc
        # inside the region
        assert 0 <= start and start + agg <= n
        # from the RNTI's own search space
        cands = search_space_candidates(
            r, sf_idx, n, ue_specific=not uses_common_space(r))
        assert start in cands.get(agg, [])
        # collision-free against every earlier allocation
        for s0, l0 in allocs:
            assert start + agg <= s0 or start >= s0 + l0
        allocs.append((start, agg))


def test_min_cfi_escalates_with_demand():
    """More simultaneous DCIs need a bigger control region — and the
    dry-run allocator finds the smallest CFI that fits (the
    scheduler_grid.cc:154-165 adaptation)."""
    cell = Cell(nof_prb=50, nof_ports=1, id=7)
    light = min_cfi_for(cell, sf_idx=2, demands=[0x46])
    heavy = min_cfi_for(cell, sf_idx=2,
                        demands=[0x46 + i for i in range(8)] + [0xFFFF, 0xFFFE])
    assert light <= heavy
    # every demand actually fits at the returned CFI
    grid = PdcchGrid(cell, 2, heavy)
    fitted = sum(grid.alloc(r) is not None
                 for r in [0x46 + i for i in range(8)] + [0xFFFF, 0xFFFE])
    # the region genuinely cannot host every candidate set at once —
    # the reference drops the excess the same way; most must fit
    assert fitted >= 8


def test_cfi_adaptation_end_to_end():
    """EnbStack(cfi_adapt=True) + a PCFICH-following UE (cfi=None):
    attach and traffic survive per-TTI control-region resizing."""
    from srsran_tpu.apps.full_stack import EnbStack, UeStack
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    IMSI = "001010123456789"
    KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
    OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5, cfi_adapt=True)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC), cfi=None)
    ul = None
    for tti in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([i]) * 60 for i in range(3)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(40):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
