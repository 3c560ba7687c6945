"""Full LTE stack on the windowed CONTROL plane — no per-TTI DSP on the
host at all.

`apps/full_stack.py` + `apps/windowed_plane.py` (rounds 3-4) put the
PDSCH/PUSCH DATA path on windowed device engines but kept the per-TTI
control path (PDCCH render/blind-decode, OFDM, chest, PUCCH) on the
host, which measured ~17 ms/TTI against the reference's 1 ms worker
budget (`srsenb/src/phy/sf_worker.cc:166`).  This module batches the
CONTROL path too (pipeline_ctrl engines): every run_tti does only queue
bookkeeping and byte-level MAC/RLC work; all DSP happens in a handful of
device dispatches per W-TTI window.

Timing contract (the windowed extension of windowed_plane.py's):

* window W (>= 12), feedback delay D = 5W TTIs;
* DCI-0 grants, RAR Msg3, PHICH retransmissions and HARQ ACKs all run
  at +D instead of the TS 36.213 +4 (`ul_grant_delay`/`harq_delay`);
* DL HARQ is SYNCHRONOUS with n_harq = 6W + 32 processes: pid =
  tti % n_harq on BOTH ends (the DCI's 3-bit field carries pid % 8),
  retransmissions ride the pid's own TTI slots — the LTE UL HARQ
  discipline applied DL, because a 3-bit pid cannot span D in-flight TBs;
* simultaneousPUCCH-PUSCH (TS 36.213 r10): UCI always rides PUCCH, so
  every PUSCH is a pure data transport the windowed engines decode.

Pipeline schedule (all windows aligned to absolute TTIs, window j =
TTIs [jW, jW+W)):

  eNB  rows of DL window k+2 staged one per tick through window k and
       rendered in one dispatch at its boundary; UL window m
       FFT-dispatched when its last row arrives (tti mW+W); PUCCH
       realized to host, PUSCH data window chained from the stored grid.
  UE   boundary of window k: dispatch ctrl front-end for window k;
       blind search Viterbi batched and pipelined; data window chained
       from the stored grids; UL rows staged one per tick, two windows
       ahead.  A realization poll fires once the window's arrays are
       computed, or at the W/2-tick contract deadline; device→host copies
       start two ticks after each dispatch.

Single-cell FDD, 1-port, single-codeword, TM1 scope (the serving hot
path; TDD/CA/TM3+/mobility stay on the per-TTI stack).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque

import numpy as np

from ..phy.common import Cell, SIRNTI
from ..phy.enb.enb_dl import DlSched
from ..phy.modem import Mod
from ..phy.phch.dci import Dci0, Dci1A
from ..phy.phch.pdsch import DlGrant
from ..phy.phch.pusch import UlGrant
from ..phy.phch.ra import (
    dl_mcs_to_mod,
    dl_tbs,
    riv_decode,
    tbs_lookup,
    ul_mcs_to_itbs,
    ul_mcs_to_mod,
)
from ..pipeline_ctrl import (
    WindowedEnbUlFrontEnd,
    WindowedUeFrontEnd,
    enb_ctrl_overlay,
    phich_decode_np,
    pucch_format2_decode_np,
    window_blind_search,
)
from ..pipeline_window import WindowedEnbDl, WindowedUeUl, extract_softbuffer
from ..stack.mac import HARQ_RV_SEQ, Scheduler
from .full_stack import (
    FB_DELAY,
    UL_HARQ_MAX_TX,
    EnbStack,
    UeStack,
    _cqi_resource,
    _phich_resource,
    _sr_resource,
    _is_sr_sf,
    cqi_on_pusch,
    cqi_report_is_ri,
)

RD = 4            # dispatch → earliest realization poll distance (TTIs)
RD_COPY = 2       # dispatch → start the async device→host copy (TTIs)


def _pump_q(q, tti, arr_of):
    """Start each pending entry's async device→host copy once, RD_COPY
    ticks after its dispatch, and keep the array for the readiness poll."""
    for e in q:
        if e.get("arr") is None and tti - e["t"] >= RD_COPY:
            e["arr"] = arr_of(e)
            _start_copy(e["arr"])


def _due(e, tti, rd_max: int) -> bool:
    """A pending window realizes once its arrays are computed (from RD
    ticks on), or at the rd_max tick deadline — so the free-running loop
    reads back finished windows without waiting on the device."""
    age = tti - e["t"]
    if age >= rd_max:
        return True
    return age >= RD and e.get("arr") is not None and _ready(e["arr"])


def _ready(tree) -> bool:
    import jax

    return all(getattr(a, "is_ready", lambda: True)()
               for a in jax.tree_util.tree_leaves(tree))


def _start_copy(arr):
    """Kick off the device→host transfer early so the realization poll's
    np.asarray finds the bytes already on the host."""
    try:
        arr.copy_to_host_async()
    except Exception:
        pass


def _on(device):
    if device is None:
        return contextlib.nullcontext()
    import jax

    return jax.default_device(device)


def _pad_dl_grant(cell: Cell) -> DlGrant:
    """Filler row for grant-less TTIs in a fixed-shape window (1 PRB of
    QPSK junk on air; the UE has no DCI for it and ignores the REs)."""
    return DlGrant(prb=(0,), mod=Mod.QPSK, tbs=16, rnti=0)


def _pad_ul_grant() -> UlGrant:
    return UlGrant(prb_start=1, nof_prb=1, mod=Mod.QPSK, tbs=16, rnti=0)


# ==========================================================================
# eNB
# ==========================================================================


class WindowedCtrlEnb(EnbStack):
    """eNB with the whole PHY (control + data, both directions) on
    windowed device engines."""

    def __init__(self, cell: Cell, mme, spgw, ctrl_window: int = 16,
                 phy_device=None, **kw):
        assert ctrl_window >= 12, "pipeline math needs W >= 12"
        assert cell.nof_ports == 1, "windowed control plane: 1-port cells"
        assert kw.get("tdd_cfg") is None, "windowed control plane is FDD"
        super().__init__(cell, mme, spgw, **kw)
        w = ctrl_window
        self.cw = w
        self.harq_delay = 5 * w
        self.ul_grant_delay = 5 * w
        self.simul_pucch_pusch = True
        self.apcqi_interval = 10 ** 9  # aperiodic CQI needs UCI-on-PUSCH
        # inactivity release must outlive the stretched feedback RTT
        # (grant → PUSCH → windowed decode ≈ 2·D; base default is 40)
        self.ul_inactivity_timeout = 6 * self.harq_delay
        self.n_harq_w = 6 * w + 32
        self.sched = Scheduler(cell.nof_prb, mcs_max=self.sched.mcs_max,
                               n_harq=self.n_harq_w, sync_dl_harq=True,
                               max_grants_per_tti=1)
        self.device = phy_device
        with _on(phy_device):
            self._dl_gen = WindowedEnbDl(cell, cfi=self.cfi, w=w,
                                         template="full")
            # 2 edge PRBs per side cover every configured PUCCH resource
            # (n_pucch <= ~28 → PRB index m <= 1); reading back only the
            # edges halves the window's device→host bytes
            self._ul_fe = WindowedEnbUlFrontEnd(cell, w=w, edge_prbs=2)
        # DL render pipeline
        self._dl_disp: dict[int, object] = {}   # window j -> device out
        self._dl_rows: dict[int, np.ndarray] = {}
        # UL pipeline
        self._ul_rows: dict[int, np.ndarray | None] = {}
        self._ul_fe_q: deque = deque()   # (dispatch_tti, first_u, pf)
        self._ul_data_q: deque = deque()  # (dispatch_tti, pending, metas)
        # device link (WindowedDeviceLoopback): baseband stays in HBM;
        # the driver moves whole windows between the stacks
        self.device_link = False
        self._ul_dev_win: dict[int, object] = {}
        self._dl_stage = None
        with _on(phy_device):
            self._dispatch_dl_window(0)
            self._dispatch_dl_window(1)

    # ---- DL: schedule a window ahead, render in one device program.
    # The per-TTI scheduling + overlay render is STAGED across the
    # preceding window's quiet TTIs (row i by tick i) so no single
    # run_tti carries W TTIs of host work; the device dispatch happens
    # at the boundary.  (Feedback any row uses is ready well before its
    # stage tick — see the module timing contract.) ----

    def _sched_dl_row(self, t: int):
        sf = t % 10
        sched = self._sched_dl(t, sf)
        assert sched is not None  # FDD only
        assert len(sched.grants) <= 1, "windowed TX: one grant/TTI"
        if sched.grants:
            g, tb = sched.grants[0]
            payload = np.asarray(tb, np.uint8)
        else:
            g = _pad_dl_grant(self.cell)
            payload = np.zeros(16, np.uint8)
        idx, vals = enb_ctrl_overlay(self.cell, self.cfi, sf, sched,
                                     mib=self.mib, sfn=(t // 10) % 1024)
        return sf, g, payload, idx, vals

    def _dispatch_dl_window(self, j: int):
        w = self.cw
        payloads, grants, sfs, ov_idx, ov_val = [], [], [], [], []
        for t in range(j * w, j * w + w):
            sf, g, payload, idx, vals = self._sched_dl_row(t)
            sfs.append(sf)
            grants.append(g)
            payloads.append(payload)
            ov_idx.append(idx)
            ov_val.append(vals)
        out = self._dl_gen.dispatch_window(
            payloads, sfs, grants,
            overlay=(np.stack(ov_idx), np.stack(ov_val)))
        self._dl_disp[j] = out

    def _dl_stage_tick(self, tti: int):
        w = self.cw
        j = tti // w + 2
        tt = tti % w
        st = self._dl_stage
        if st is None or st["j"] != j:
            st = self._dl_stage = {"j": j, "i": 0, "rows": []}
        while st["i"] < w and st["i"] <= tt:
            st["rows"].append(self._sched_dl_row(j * w + st["i"]))
            st["i"] += 1
        if tt == w - 1:
            rows = st["rows"]
            out = self._dl_gen.dispatch_window(
                [r[2] for r in rows], [r[0] for r in rows],
                [r[1] for r in rows],
                overlay=(np.stack([r[3] for r in rows]),
                         np.stack([r[4] for r in rows])))
            self._dl_disp[j] = out
            self._dl_stage = None

    def _dl_pop(self, tti: int) -> np.ndarray:
        j = tti // self.cw
        if tti not in self._dl_rows:
            out = self._dl_disp.pop(j)
            rows = self._dl_gen.samples(out)   # ONE readback per window
            for i in range(self.cw):
                self._dl_rows[j * self.cw + i] = rows[i]
        return self._dl_rows.pop(tti)

    # ---- UL: FFT window → PUCCH host decode + PUSCH data window ----

    def push_ul_window_dev(self, m: int, rx_dev, prach_rows=None):
        """Device link: receive UL window m as a device (W, nrx, L, 2)
        buffer (host rows never exist); PRACH preambles arrive as the
        rare host side-channel (attach only)."""
        self._ul_dev_win[m] = rx_dev
        if prach_rows:
            for u, row in prach_rows.items():
                self._prach_ingest(u + 1, row)

    def _ul_flush(self, tti: int):
        """Dispatch the UL front-end once window m's last row arrived."""
        w = self.cw
        u_last = tti - 1
        if u_last < 0 or u_last % w != w - 1:
            return
        m = u_last // w
        first = m * w
        if self.device_link:
            dev = self._ul_dev_win.pop(m, None)
            if dev is None:
                return
            samples = dev
        else:
            rows = []
            for u in range(first, first + w):
                r = self._ul_rows.pop(u, None)
                if r is None:
                    r = np.zeros(self.cell.sf_len, np.complex64)
                rows.append(r)
            samples = np.stack(rows)[:, None]
        pf = self._ul_fe.dispatch(samples, [u % 10 for u in
                                            range(first, first + w)])
        self._ul_fe_q.append(dict(t=tti, first=first, pf=pf))

    def _ul_poll(self, tti: int):
        from ..phy.phch.pucch import (PucchConfig, _f1_covers, pucch_f1_prb,
                                      pucch_format1_decode)

        w = self.cw
        rdm = max(RD, (w - 10) // 2)
        _pump_q(self._ul_fe_q, tti, lambda e: e["pf"].edge)
        _pump_q(self._ul_data_q, tti, lambda e: e["p"].packed)
        while self._ul_fe_q and _due(self._ul_fe_q[0], tti, rdm):
            ent = self._ul_fe_q.popleft()
            first, pf = ent["first"], ent["pf"]
            edge, prb_pow = self._ul_fe.realize_pucch(pf)

            def f1_grid(i, u, n_pucch):
                prbs = tuple(
                    pucch_f1_prb(n_pucch, 2 * (u % 10) + sl,
                                 self.cell.nof_prb, 2,
                                 covers=_f1_covers(self.cell))
                    for sl in range(2))
                return self._ul_fe.pucch_prb_grid(edge, i, prbs)

            # HARQ-ACK decodes batched per resource (the saturated
            # single-UE stream uses ONE n_pucch): all the window's
            # format-1 correlations run as one vectorized pass
            from ..pipeline_ctrl import pucch_format1_decode_batch

            window_acks = [self.pending_dl_ack.pop(first + i, [])
                           for i in range(w)]
            jobs: dict[int, list] = {}   # n_pucch -> [(i, rnti, entries)]
            for i, acks in enumerate(window_acks):
                by_rnti: dict[int, list] = {}
                for e in acks:
                    by_rnti.setdefault(e["rnti"], []).append(e)
                for rnti, entries in by_rnti.items():
                    if float(np.max(prb_pow[i])) >= 1e-7:
                        jobs.setdefault(entries[-1]["n_pucch"], []).append(
                            (i, rnti, entries))
                    else:  # DTX: nothing on air
                        for e in entries:
                            self.sched.ack_info(rnti, e["pid"], False)
                            self.stats["dl_nack"] = self.stats.get(
                                "dl_nack", 0) + 1
            for n_pucch, rows in jobs.items():
                g_rows = np.stack([f1_grid(i, first + i, n_pucch)
                                   for i, _r, _e in rows])
                bb, mm = pucch_format1_decode_batch(
                    g_rows, self.cell, n_pucch,
                    [(first + i) % 10 for i, _r, _e in rows], 1)
                for (i, rnti, entries), bit, metric in zip(rows, bb, mm):
                    ack = float(metric) > 0.25 and int(bit[0]) == 1
                    for e in entries:
                        self.sched.ack_info(rnti, e["pid"], ack)
                        key = "dl_ack" if ack else "dl_nack"
                        self.stats[key] = self.stats.get(key, 0) + 1

            # grants indexed BY WINDOW SLOT: dispatch_data row i decodes
            # from slot i's stored grid
            grants = [_pad_ul_grant() for _ in range(w)]
            soft = [None] * w
            metas = []
            for i in range(w):
                u = first + i
                sf = u % 10
                has_energy = float(np.max(prb_pow[i])) >= 1e-7
                acks = window_acks[i]
                # periodic CQI/RI on PUCCH 2 (ack-free occasions only)
                if (cqi_on_pusch(u) and has_energy):
                    ack_rntis = {e["rnti"] for e in acks}
                    for rnti_c, ue_c in self.ues.items():
                        if (ue_c.rrc_state < self.RRC_ACTIVE
                                or rnti_c in ack_rntis):
                            continue
                        cfg2 = PucchConfig(n_pucch=_cqi_resource(rnti_c))
                        nb = 1 if (cqi_report_is_ri(u) and self.tm >= 3) \
                            else 4
                        bits, metric = pucch_format2_decode_np(
                            f1_grid(i, u, cfg2.n_pucch), self.cell, cfg2,
                            sf, nb)
                        if metric <= 0.25:
                            continue
                        cqi = int("".join(str(x) for x in bits[:4]), 2)
                        self.sched.cqi_info(rnti_c, cqi)
                        ue_c.last_cqi_tti = u
                        self.stats["cqi_pucch_rx"] = self.stats.get(
                            "cqi_pucch_rx", 0) + 1
                # SR
                if _is_sr_sf(self.sr_enabled, None, u) and has_energy:
                    for rnti_s, ue_s in self.ues.items():
                        if ue_s.rrc_state < self.RRC_SETUP_SENT:
                            continue
                        cfgs = PucchConfig(n_pucch=_sr_resource(rnti_s))
                        _b, metric = pucch_format1_decode(
                            f1_grid(i, u, cfgs.n_pucch), self.cell, cfgs,
                            sf, 0)
                        if float(metric) > 0.25:
                            self.sched.ul_bsr(rnti_s, 128)
                            self.stats["sr_detected"] = self.stats.get(
                                "sr_detected", 0) + 1
                # PUSCH row — gated on the ALLOCATION's own rx power
                # (enb_ul.c DTX gate: an empty allocation's zero LLRs
                # decode to the valid all-zero codeword)
                pu = self.pending_ul.pop(u, None)
                alloc_ok = False
                if pu is not None:
                    g_ = pu[1]
                    alloc_pow = float(np.mean(
                        prb_pow[i, g_.prb_start: g_.prb_start
                                + g_.nof_prb]))
                    alloc_ok = alloc_pow >= 1e-7
                    ue_ctx = self.ues.get(pu[0])
                    if ue_ctx is not None and alloc_ok:
                        ue_ctx.last_ul_rx_db = 10.0 * np.log10(
                            max(alloc_pow, 1e-12))
                if pu is not None and alloc_ok:
                    rnti, grant = pu
                    hs = self._ul_harq.pop(u, None)
                    sbw, txc = None, 1
                    if hs is not None:
                        sb0, txc0 = hs
                        txc = txc0 + 1
                        if (isinstance(sb0, tuple) and len(sb0) == 2
                                and sb0[0] == "win"):
                            sbw = sb0[1]
                    grants[i] = grant
                    soft[i] = sbw
                    metas.append(dict(row=i, tti=u, rnti=rnti,
                                      grant=grant, tx_count=txc))
                elif pu is not None:
                    # DTX: nothing on the allocation → NACK via completion
                    rnti, grant = pu
                    hs = self._ul_harq.pop(u, None)
                    self._complete_ul_data(dict(
                        tti=u, rnti=rnti, grant=grant, ok=False, tb=None,
                        tx_count=(hs[1] + 1) if hs else 1, soft=None))
            if metas:
                if all(s is None for s in soft):
                    soft = None
                p = self._ul_fe.dispatch_data(pf, grants, softbuffer=soft)
                self._ul_data_q.append(dict(t=tti, p=p, metas=metas))
        while self._ul_data_q and _due(self._ul_data_q[0], tti, rdm):
            ent = self._ul_data_q.popleft()
            p, metas = ent["p"], ent["metas"]
            res = self._ul_fe.results(p)
            for meta in metas:
                tb, ok, _n = res[meta["row"]]
                soft = None if ok else extract_softbuffer(p, meta["row"])
                self._complete_ul_data(dict(
                    tti=meta["tti"], rnti=meta["rnti"],
                    grant=meta["grant"], ok=bool(ok), tb=tb,
                    tx_count=meta["tx_count"],
                    soft=soft))

    def _prach_ingest(self, tti: int, samples: np.ndarray | None):
        """Per-TTI PRACH detection on the raw row (attach phase only —
        copy of the _process_ul PRACH block; rare and host-cheap)."""
        from ..phy.phch.prach import prach_cp_len, prach_detect, prach_nfft

        u = tti - 1
        if samples is None or u % 10 != self.prach_sf:
            return
        cp = prach_cp_len(self.cell)
        win = samples[cp: cp + prach_nfft(self.cell)]
        if (len(win) != prach_nfft(self.cell)
                or np.mean(np.abs(win) ** 2) <= 1e-6):
            return
        with _on(self.device):
            metric, delay, det = [np.asarray(v) for v in prach_detect(
                self.cell, self.prach_cfg, win)]
        known = {ue.rapid for ue in self.ues.values()
                 if ue.rrc_state < self.RRC_CONNECTED}
        for rapid in np.nonzero(det)[0]:
            rapid = int(rapid)
            if rapid in known or any(r[0] == rapid
                                     for r in self.pending_rars):
                continue
            ta = max(0, int(round(float(delay[rapid]))))
            ue = self._new_ue(rapid)
            self.pending_rars.append((rapid, ta, ue.crnti))
            self.stats["prach_detected"] += 1

    def run_tti(self, ul_samples: np.ndarray | None) -> np.ndarray:
        tti = self.tti
        for u in self.ues.values():
            for ent in (u.srb1_rlc, u.drb_rlc):
                if hasattr(ent, "tick"):
                    ent.tick()
        if ul_samples is not None and not self.device_link:
            self._ul_rows[tti - 1] = np.asarray(ul_samples)
        with _on(self.device):
            if not self.device_link:
                self._prach_ingest(tti, ul_samples)
            self._ul_flush(tti)
            self._ul_poll(tti)
        if hasattr(self.mme, "pump_s11"):
            self.mme.pump_s11()
        for ue in list(self.ues.values()):
            if ue.release_at >= 0:
                if tti >= ue.release_at:
                    self._release_ue(ue)
                continue
            if (ue.rrc_state != self.RRC_IDLE
                    and tti - ue.last_ul_ok_tti > self.ul_inactivity_timeout):
                from ..stack import rrc

                self._send_srb1(ue, rrc.pack_conn_release())
                ue.release_at = tti + 15
        self._pump_spgw()
        with _on(self.device):
            dl = None if self.device_link else self._dl_pop(tti)
            self._dl_stage_tick(tti)
        self.tti += 1
        return dl


# ==========================================================================
# UE
# ==========================================================================


class WindowedCtrlUe(UeStack):
    """UE with buffered DL windows, batched blind search, and UL windows
    generated two windows ahead under the stretched-feedback contract."""

    def __init__(self, cell: Cell, usim, ctrl_window: int = 16,
                 phy_device=None, **kw):
        assert ctrl_window >= 12
        assert cell.nof_ports == 1
        kw.setdefault("cfi", 2)
        super().__init__(cell, usim, **kw)
        w = ctrl_window
        self.cw = w
        self.harq_delay = 5 * w
        self.ul_grant_delay = 5 * w
        self.n_harq_w = 6 * w + 32
        self.device = phy_device
        with _on(phy_device):
            self._fe = WindowedUeFrontEnd(cell, cfi=self.cfi, w=w,
                                          scheme="port0", ingest="int16",
                                          max_iterations=self.expert.pdsch_max_its)
            self._ul_gen = WindowedUeUl(cell, w=w)
        self._rx_rows: dict[int, np.ndarray] = {}
        self._fe_q: deque = deque()      # (dispatch_tti, first_t, pf)
        self._data_q: deque = deque()    # (dispatch_tti, pending, metas)
        self._win_soft: dict = {}        # pid -> (ndi, device block)
        self._ul_disp: dict[int, tuple] = {}  # window m -> (out|None, extras)
        self._ul_ready: dict[int, np.ndarray | None] = {}
        self.device_link = False
        self._dl_dev_win: dict[int, object] = {}
        self._vit_q: deque = deque()  # ctrl realized, Viterbi in flight
        self._ul_stage = None
        self._ul_gen_window(0)
        self._ul_gen_window(1)
        self.stats["ctrl_windows"] = 0

    # ---- device link ----

    def push_dl_window_dev(self, j: int, rx_dev):
        """Device link: window j's received baseband as a device
        (W, nrx, L, 2) buffer."""
        self._dl_dev_win[j] = rx_dev

    def pop_ul_window_dev(self, m: int):
        """Device link: hand window m's transmit buffer to the driver —
        (device (W, L, 2) | None, PRACH host rows {tti: row})."""
        out, _emit, extras, _first = self._ul_disp.pop(m)
        return out, extras

    # ---- DL control + data ----

    def _flush_fe(self, tti: int):
        if tti % self.cw != self.cw - 1:
            return
        first = tti - self.cw + 1
        if self.device_link:
            samples = self._dl_dev_win.pop(first // self.cw, None)
            if samples is None:
                return
        else:
            rows = [self._rx_rows.pop(first + i) for i in range(self.cw)]
            samples = np.stack(rows)[:, None]
        pf = self._fe.dispatch(samples, [t % 10 for t in
                                         range(first, first + self.cw)])
        self._fe_q.append(dict(t=tti, first=first, pf=pf))
        self.stats["ctrl_windows"] += 1

    def _poll_fe(self, tti: int):
        w = self.cw
        rdm = max(RD, w // 2 - 2)
        len_1a = Dci1A.nof_bits(self.cell.nof_prb)
        _pump_q(self._fe_q, tti, lambda e: e["pf"].packed)
        _pump_q(self._data_q, tti, lambda e: e["p"].packed)
        while self._fe_q and _due(self._fe_q[0], tti, rdm):
            # ctrl stage: realize the front-end (bytes pre-copied),
            # handle PHICH + metrics, DISPATCH the batched Viterbi; the
            # DCI parse runs two TTIs later so the Viterbi round-trip
            # rides quiet TTIs
            ent = self._fe_q.popleft()
            first, pf = ent["first"], ent["pf"]
            ctrl, rsrp, noise = self._fe.realize(pf)
            # per-TTI measurements → CQI/monitoring state
            snr = np.mean(rsrp) / max(float(np.mean(noise)), 1e-12)
            snr_db = 10.0 * np.log10(max(snr, 1e-12))
            a = self.expert.snr_ema_coeff
            prev = getattr(self, "_dl_snr_db", None)
            self._dl_snr_db = (snr_db if prev is None
                               else (1 - a) * prev + a * snr_db)
            self._dl_rsrp_dbfs = 10.0 * np.log10(
                float(np.mean(rsrp)) + 1e-12)
            # search requests (the _process_dl RNTI set, window-wide)
            reqs = []
            if self.acquire_si and (self.sib1 is None or self.sib2 is None):
                reqs.append((SIRNTI, "1A", len_1a, False))
            if self.rrc_state == self.RRC_WAIT_RAR:
                reqs.append((1 + self.prach_sf, "1A", len_1a, False))
            if self.crnti is not None:
                reqs.append((self.crnti, "1A", len_1a, True))
            sfs = [(first + i) % 10 for i in range(w)]
            from ..pipeline_ctrl import blind_search_dispatch

            vit = blind_search_dispatch(ctrl, self._fe.layout, self.cell,
                                        sfs, [reqs] * w)
            self._vit_q.append(dict(t=tti, first=first, pf=pf, ctrl=ctrl,
                                    sfs=sfs, vit=vit, arr=vit))
        while self._vit_q and _due(self._vit_q[0], tti, rdm):
            from ..pipeline_ctrl import blind_search_collect

            ent = self._vit_q.popleft()
            first, pf, ctrl, sfs, vit = (ent["first"], ent["pf"],
                                         ent["ctrl"], ent["sfs"],
                                         ent["vit"])
            found = blind_search_collect(vit)
            # grants indexed BY WINDOW SLOT (dispatch_data row i reads
            # slot i's stored grid)
            grants = [_pad_dl_grant(self.cell) for _ in range(w)]
            soft = [None] * w
            metas = []
            for i in range(w):
                t = first + i
                # PHICH watch (UL HARQ, stretched chain)
                inflight = self._ul_inflight.pop(t, None)
                if inflight is not None and self.crnti is not None:
                    g_fl, tb_fl, txc = inflight
                    group, n_seq = _phich_resource(self.cell, g_fl)
                    ph = ctrl[i, self._fe.layout.phich[group]]
                    ack, _m = phich_decode_np(ph, self.cell, sfs[i], n_seq)
                    if not ack and txc < UL_HARQ_MAX_TX:
                        import dataclasses as _dc

                        g2 = _dc.replace(g_fl,
                                         rv=HARQ_RV_SEQ[txc % 4])
                        self.pending_retx[t + self.ul_grant_delay] = (
                            g2, tb_fl, txc + 1)
                        self.stats["ul_retx"] = self.stats.get(
                            "ul_retx", 0) + 1
                got_dl = False
                for rnti, fmt, bits, agg, cce in found[i]:
                    if bits[0] == 0 and rnti == self.crnti:
                        # DCI0: UL grant at the stretched delay
                        dci0 = Dci0.unpack(bits, self.cell.nof_prb)
                        self.ul_gain_db = float(np.clip(
                            self.ul_gain_db + (-1, 0, 1, 3)[dci0.tpc],
                            -20.0, 20.0))
                        try:
                            rb0, l_crb = riv_decode(self.cell.nof_prb,
                                                    dci0.riv)
                            g_ul = UlGrant(
                                prb_start=rb0, nof_prb=l_crb,
                                mod=ul_mcs_to_mod(dci0.mcs),
                                tbs=tbs_lookup(ul_mcs_to_itbs(dci0.mcs),
                                               l_crb), rnti=rnti)
                        except (ValueError, IndexError):
                            continue  # CRC-RNTI false positive
                        self.pending_tx[t + self.ul_grant_delay] = g_ul
                        continue
                    if got_dl:
                        continue  # one DL grant per subframe
                    try:
                        dci = Dci1A.unpack(bits, self.cell.nof_prb)
                        rb0, l_crb = riv_decode(self.cell.nof_prb,
                                                dci.riv)
                        if rnti >= 0xFFF4 or rnti <= 0x0042:
                            n_prb_1a = 3 if (dci.tpc & 1) else 2
                            grant = DlGrant(
                                prb=tuple(range(rb0, rb0 + l_crb)),
                                mod=Mod.QPSK,
                                tbs=tbs_lookup(dci.mcs, n_prb_1a),
                                rv=dci.rv, rnti=rnti)
                        else:
                            grant = DlGrant(
                                prb=tuple(range(rb0, rb0 + l_crb)),
                                mod=dl_mcs_to_mod(dci.mcs),
                                tbs=dl_tbs(dci.mcs, l_crb),
                                rv=dci.rv, rnti=rnti)
                    except (ValueError, IndexError):
                        continue  # CRC-RNTI false positive
                    if grant.tbs <= 0:
                        continue
                    got_dl = True
                    pid = t % self.n_harq_w
                    sb = None
                    if rnti == self.crnti:
                        st = self._win_soft.get(pid)
                        if st is not None and st[0] == dci.ndi:
                            sb = st[1]
                    grants[i] = grant
                    soft[i] = sb
                    metas.append(dict(row=i, tti=t, rnti=rnti, dci=dci,
                                      cce=cce, pid=pid))
            if metas:
                if all(s is None for s in soft):
                    soft = None
                p = self._fe.dispatch_data(pf, grants, softbuffer=soft)
                self._data_q.append(dict(t=tti, p=p, metas=metas))
        while self._data_q and _due(self._data_q[0], tti, rdm):
            ent = self._data_q.popleft()
            p, metas = ent["p"], ent["metas"]
            res = self._fe.results(p)
            for meta in metas:
                tb, ok, _n = res[meta["row"]]
                self._complete_row(meta, tb, bool(ok), p)

    def _complete_row(self, meta, tb, ok, p):
        rnti, t = meta["rnti"], meta["tti"]
        if rnti != self.crnti:
            if not ok:
                return
            pdu = np.packbits(np.asarray(tb)).tobytes()
            self.stats["dl_tbs_ok"] += 1
            if rnti == 0xFFFF:
                self._handle_si(pdu)
            elif rnti == 0xFFFE:
                self._handle_paging(pdu)
            else:
                self._handle_rar(t, pdu)
            return
        # C-RNTI: HARQ feedback + dup suppression at the tti-derived pid
        # (_complete_dl_data with the synchronous pid)
        dci, pid = meta["dci"], meta["pid"]
        if ok:
            self._win_soft.pop(pid, None)
        else:
            self._win_soft[pid] = (dci.ndi,
                                   extract_softbuffer(p, meta["row"]))
        last = self._dl_ndi.get(pid)
        is_dup = last is not None and last[0] == dci.ndi and last[1]
        self._dl_ndi[pid] = (dci.ndi, ok or is_dup)
        self.pending_ack.setdefault(t + self.harq_delay, []).append(
            (meta["cce"], 1 if (ok or is_dup) else 0, t))
        if ok and not is_dup:
            self.stats["dl_tbs_ok"] += 1
            self._handle_dl_pdu(np.packbits(np.asarray(tb)).tobytes())

    # ---- UL generation, two windows ahead ----

    def _ul_new_stage(self, m: int):
        w = self.cw
        nsymb = self.cell.nsymb_per_sf
        return {"m": m, "i": 0, "grants": [], "payloads": [], "sfs": [],
                "extras": {}, "live": np.zeros(w, bool),
                "pgrids": np.zeros((w, nsymb, 12), np.complex64),
                "pprb": np.zeros((w, 2), np.int32),
                "has_pucch": np.zeros(w, bool)}

    def _ul_gen_row(self, st: dict):
        """Stage ONE UL row (deadline-aware: the feedback this row needs
        is realized at least a window before its stage tick)."""
        from ..phy.phch.pucch import (PucchConfig, _f1_covers, pucch_f1_prb,
                                      pucch_format1_encode_np,
                                      pucch_format2_encode_np)

        w = self.cw
        i = st["i"]
        st["i"] += 1
        u = st["m"] * w + i
        grants, payloads, sfs = st["grants"], st["payloads"], st["sfs"]
        extras, live = st["extras"], st["live"]
        pgrids, pprb, has_pucch = st["pgrids"], st["pprb"], st["has_pucch"]

        def put_pucch(i, sf, pucch1=None, pucch2=None):
            for item, enc in ((pucch1, pucch_format1_encode_np),
                              (pucch2, pucch_format2_encode_np)):
                if item is None:
                    continue
                cfg, payload = item
                pgrids[i] += enc(self.cell, cfg, sf, payload)
                for slot in range(2):
                    pprb[i, slot] = pucch_f1_prb(
                        cfg.n_pucch, 2 * sf + slot, self.cell.nof_prb,
                        cfg.delta_shift, covers=_f1_covers(self.cell))
                has_pucch[i] = True

        if True:
            sf = u % 10
            # PRACH decision (attach): per the _build_ul gate, committed
            # at generation time (the windowed contract's look-ahead)
            if (self.rrc_state == self.RRC_IDLE and sf == self.prach_sf
                    and u >= self.attach_delay and self._si_ready()
                    and not self.idle_camped):
                from ..phy.ue.ue_ul import ue_prach_send

                self.mac.start_ra(self.preamble)
                self.rrc_state = self.RRC_WAIT_RAR
                self._ra_deadline = u + self.ul_grant_delay + 4 * w
                p = ue_prach_send(self.cell, self.prach_cfg,
                                  self.preamble)
                out = np.zeros(self.cell.sf_len, np.complex64)
                out[: len(p)] = p[: self.cell.sf_len]
                extras[u] = out
                grants.append(_pad_ul_grant())
                payloads.append(np.zeros(16, np.uint8))
                sfs.append(sf)
                return
            if (self.rrc_state == self.RRC_WAIT_RAR
                    and u >= getattr(self, "_ra_deadline", 1 << 62)):
                self.rrc_state = self.RRC_IDLE
            acks = self.pending_ack.pop(u, None)
            grant = self.pending_tx.pop(u, None)
            retx = self.pending_retx.pop(u, None)
            if acks:
                bit = 1 if all(b for _, b, _t in acks) else 0
                put_pucch(i, sf, pucch1=(PucchConfig(n_pucch=acks[-1][0]),
                                         [bit]))
            elif (cqi_on_pusch(u) and self.rrc_state == self.RRC_ACTIVE
                    and grant is None and retx is None):
                cqi = self._report_cqi()
                bits = np.array([int(b) for b in np.binary_repr(cqi, 4)],
                                np.uint8)
                put_pucch(i, sf, pucch2=(
                    PucchConfig(n_pucch=_cqi_resource(self.crnti)), bits))
                self.stats["cqi_pucch_sent"] = self.stats.get(
                    "cqi_pucch_sent", 0) + 1
            elif (_is_sr_sf(self.sr_enabled, None, u)
                    and self.rrc_state >= self.RRC_CONNECTED
                    and self._buffer_state() > 0 and not self.pending_tx):
                put_pucch(i, sf, pucch1=(
                    PucchConfig(n_pucch=_sr_resource(self.crnti)), []))
                self.stats["sr_sent"] = self.stats.get("sr_sent", 0) + 1
            # PUSCH (pure data; UCI rides the parallel PUCCH)
            if retx is not None and grant is None:
                g2, tb_bits, txc = retx
                grants.append(g2)
                payloads.append(np.asarray(tb_bits, np.uint8))
                live[i] = True
                self._ul_inflight[u + self.harq_delay] = (g2, tb_bits,
                                                          txc)
            elif grant is not None:
                mac_pdu = self._build_ul_mac_pdu(grant.tbs // 8)
                tb_bits = np.unpackbits(np.frombuffer(mac_pdu, np.uint8))
                grants.append(grant)
                payloads.append(tb_bits)
                live[i] = True
                self._ul_inflight[u + self.harq_delay] = (grant, tb_bits,
                                                          1)
            else:
                grants.append(_pad_ul_grant())
                payloads.append(np.zeros(16, np.uint8))
            sfs.append(sf)

    def _ul_dispatch_stage(self, st: dict):
        emit = st["live"] | st["has_pucch"]
        if emit.any():
            out = self._ul_gen.dispatch_window(
                st["payloads"], st["sfs"], st["grants"],
                pucch=(st["pprb"], st["pgrids"], st["live"]))
        else:
            out = None
        self._ul_disp[st["m"]] = (out, emit, st["extras"],
                                  st["m"] * self.cw)

    def _ul_gen_window(self, m: int):
        """Generate UL window m in one shot (bootstrap windows)."""
        st = self._ul_new_stage(m)
        while st["i"] < self.cw:
            self._ul_gen_row(st)
        self._ul_dispatch_stage(st)

    def _ul_stage_tick(self, tti: int):
        """Stage UL rows for window tti//W + 2 across this window's
        ticks: row i by tick max(12, i) — the earliest tick at which
        all the feedback row i consumes is guaranteed realized (see the
        staging margins in the contract); dispatch at the boundary."""
        w = self.cw
        m = tti // w + 2
        tt = tti % w
        st = self._ul_stage
        if st is None or st["m"] != m:
            st = self._ul_stage = self._ul_new_stage(m)
        while st["i"] < w and max(12, st["i"]) <= tt:
            self._ul_gen_row(st)
        if tt == w - 1:
            while st["i"] < w:
                self._ul_gen_row(st)
            self._ul_dispatch_stage(st)
            self._ul_stage = None

    def _ul_pop(self, tti: int) -> np.ndarray | None:
        m = tti // self.cw
        if m in self._ul_disp:
            out, emit, extras, first = self._ul_disp.pop(m)
            rows = (WindowedEnbDl.samples(out) if out is not None
                    else np.zeros((self.cw, self.cell.sf_len),
                                  np.complex64))
            gain = np.float32(10.0 ** (self.ul_gain_db / 20.0))
            for i in range(self.cw):
                u = first + i
                row = rows[i] * gain if emit[i] else None
                ex = extras.get(u)
                if ex is not None:
                    row = ex if row is None else row + ex
                if row is not None and self.ta_samples:
                    row = np.roll(row, -self.ta_samples)
                self._ul_ready[u] = row
        return self._ul_ready.pop(tti, None)

    def run_tti(self, dl_samples: np.ndarray | None) -> np.ndarray | None:
        tti = self.tti
        for ent in (self.srb1_rlc, self.drb_rlc):
            if hasattr(ent, "tick"):
                ent.tick()
        if not self.device_link:
            self._rx_rows[tti] = np.asarray(dl_samples)
        with _on(self.device):
            self._flush_fe(tti)
            self._poll_fe(tti)
        if self.gw is not None and self.rrc_state == self.RRC_ACTIVE:
            self.gw.pump_ul(self.send_ip_packet)
        with _on(self.device):
            ul = None if self.device_link else self._ul_pop(tti)
            self._ul_stage_tick(tti)
        self.tti += 1
        return ul


# ==========================================================================
# device-resident loopback — the serving topology: baseband never leaves
# HBM, the host link carries only payload bits, control readbacks and the
# rare PRACH side-channel (the full-stack extension of bench.py's
# window_loopback; cf. the reference's single-host srsenb↔srsue ZMQ link)
# ==========================================================================


class WindowedDeviceLoopback:
    """Drive a WindowedCtrlEnb + WindowedCtrlUe pair over an on-chip
    flat channel + AWGN.  One `step()` = one TTI for both ends."""

    def __init__(self, enb: WindowedCtrlEnb, ue: WindowedCtrlUe,
                 snr_db: float = 30.0, seed: int = 1):
        from ..pipeline_window import _win_channel_fn

        assert enb.cw == ue.cw
        enb.device_link = True
        ue.device_link = True
        self.enb = enb
        self.ue = ue
        self.w = enb.cw
        self._chan = _win_channel_fn()
        self._noise = np.float32(10.0 ** (-snr_db / 20.0))
        self._seed = seed
        self._zeros = None
        self.device = enb.device

    def _channel(self, tx_dev, gain: float, seed: int):
        """(W, L, 2) tx → (W, 1, L, 2) rx with AWGN, on device."""
        import jax.numpy as jnp

        w, L = tx_dev.shape[0], tx_dev.shape[1]
        h = np.array([[gain]], np.complex64)
        h_ri = np.stack([h.real, h.imag], -1).astype(np.float32)
        return self._chan(tx_dev.reshape(w, 1, L, 2), jnp.asarray(h_ri),
                          seed, self._noise)

    def step(self):
        enb, ue, w = self.enb, self.ue, self.w
        tti = enb.tti
        with _on(self.device):
            # UL window m reaches the eNB when its last TTI has aired
            if tti % w == 0 and tti > 0:
                m = tti // w - 1
                out, extras = ue.pop_ul_window_dev(m)
                gain = float(10.0 ** (ue.ul_gain_db / 20.0))
                if out is not None:
                    rx = self._channel(out, gain, self._seed + 2 * tti)
                else:
                    if (self._zeros is None
                            or self._zeros.shape[0] != w):
                        import jax.numpy as jnp

                        self._zeros = jnp.zeros(
                            (w, enb.cell.sf_len, 2), jnp.float32)
                    rx = self._channel(self._zeros, 0.0,
                                       self._seed + 2 * tti)
                enb.push_ul_window_dev(m, rx, prach_rows={
                    u: row for u, row in extras.items()})
            # DL window j reaches the UE at its flush boundary
            if tti % w == w - 1:
                j = tti // w
                tx = enb._dl_disp.pop(j)
                ue.push_dl_window_dev(
                    j, self._channel(tx, 1.0, self._seed + 2 * tti + 1))
        enb.run_tti(None)
        ue.run_tti(None)

    def run(self, n_ttis: int):
        for _ in range(n_ttis):
            self.step()
