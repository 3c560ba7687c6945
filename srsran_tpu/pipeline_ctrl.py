"""Windowed CONTROL-plane engines — the host control path batched onto
the device.

Round 4 measured the full stack at 0.06x realtime with the windowed DATA
plane live: the per-TTI host control path (PDCCH render/blind-decode,
OFDM, chest — `ue_dl.c:383-450`, `enb_dl.c` control half) cost ~17 ms/TTI
against the reference's 1 ms worker budget (`srsenb/src/phy/
sf_worker.cc:166`).  This module batches that control path the same way
round 3 batched the data path:

- `WindowedUeFrontEnd`: ONE device program FFTs + channel-estimates W
  downlink subframes (the shared stage A of `pipeline_window`), equalizes
  the control-region REs (PCFICH + PHICH + PDCCH, MRC or SFBC — the
  nof_rxant combining of `mimo/precoding.c`), and returns them to the
  host in ONE packed readback together with per-TTI RSRP/noise.  The
  (grid, CE, noise) stay ON DEVICE: when the host has parsed the DCIs it
  dispatches the PDSCH data window from the stored grids
  (`WindowedUeDl.dispatch_window_from`) — each subframe is uploaded and
  FFT'd exactly once, the `ue_dl.c:383` discipline at window rate.
- `window_blind_search`: the TS 36.213 §9.1.1 blind search over a WHOLE
  window — candidate LLR extraction in numpy, ONE batched Viterbi per
  DCI length across all (TTI, RNTI, candidate) hypotheses (pdcch.c:
  380-429 batched the §A.6 way), vectorized CRC-RNTI check.
- `WindowedEnbUlFrontEnd`: FFTs W UPLINK subframes in one program and
  extracts the band-edge PUCCH region for host-side format 1/2
  correlation decodes; the stored SC-FDMA grids feed the windowed PUSCH
  decode (`WindowedEnbUl.dispatch_window_from`) — the `enb_ul.c:66-86`
  shared-FFT discipline.
- numpy mirrors of the tiny control decodes (PHICH despread, PUCCH
  format 2 / RM(20,O)) so no per-TTI eager-JAX dispatch survives on the
  control path.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .phy.common import LTE_CRC16, Cell
from .phy.crc import crc_compute_np
from .phy.mimo import predecode_diversity2, predecode_single_mrc
from .phy.phch.pdcch import (
    CCE_BITS,
    _blind_candidates,
    _blind_signs,
    nof_cce,
    pdcch_re_indices,
)
from .pipeline_window import (
    WindowedEnbUl,
    WindowedUeDl,
    _c2ri,
    _quantize_ingest,
    _ri2c,
    _stacker,
    _upload,
)

SQRT2 = np.float32(np.sqrt(2.0))


# --------------------------------------------------------------------------
# control-region RE layout (fixed per (cell, cfi) — values change per TTI,
# positions don't: CRS/PCFICH/PHICH/PDCCH REs are subframe-invariant)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CtrlLayout:
    idx: np.ndarray      # (n_ctrl,) int32 flat RE indices, concatenated
    pcfich: slice        # 16 REs
    phich: tuple         # per-group slice into idx
    pdcch: slice         # n_cce*36 REs in CCE transmit order
    n_cce: int


@lru_cache(maxsize=32)
def ctrl_layout(cell: Cell, cfi: int) -> CtrlLayout:
    from .phy.phch.pcfich import pcfich_re_indices
    from .phy.phch.phich import nof_phich_groups, phich_re_indices

    parts = [np.asarray(pcfich_re_indices(cell), np.int32)]
    sl_pcfich = slice(0, parts[0].size)
    off = parts[0].size
    ph_slices = []
    for g in range(nof_phich_groups(cell)):
        p = np.asarray(phich_re_indices(cell, g), np.int32)
        parts.append(p)
        ph_slices.append(slice(off, off + p.size))
        off += p.size
    n = nof_cce(cell, 0, cfi)
    pd = np.asarray(pdcch_re_indices(cell, 0, cfi)[: n * 36], np.int32)
    parts.append(pd)
    sl_pdcch = slice(off, off + pd.size)
    return CtrlLayout(np.concatenate(parts), sl_pcfich, tuple(ph_slices),
                      sl_pdcch, n)


# --------------------------------------------------------------------------
# UE DL front-end window
# --------------------------------------------------------------------------


def _build_win_fe(nof_ports: int):
    """(grid_ri, ce_ri, noise, ctrl_idx) → (W, 2·n_ctrl + 2) f32 packed
    [ctrl_eq RI | rsrp | noise] — ONE readback realizes a whole window's
    control plane."""

    def one(grid_ri, ce_ri, noise, ctrl_idx):
        grid = _ri2c(grid_ri)        # (nrx, nsymb, nre)
        ce = _ri2c(ce_ri)            # (nrx, P, nsymb, nre)
        nrx = grid.shape[0]
        y = grid.reshape(nrx, -1)[:, ctrl_idx]
        if nof_ports == 1:
            h = ce[:, 0].reshape(nrx, -1)[:, ctrl_idx]
            x, _ = predecode_single_mrc(y, h, noise)
        else:
            h = ce[:, :2].reshape(nrx, 2, -1)[:, :, ctrl_idx]
            x, _ = predecode_diversity2(y, h)
        rsrp = jnp.mean(jnp.abs(ce[:, :nof_ports]) ** 2)
        return jnp.concatenate(
            [_c2ri(x).reshape(-1),
             jnp.stack([rsrp, noise]).astype(jnp.float32)])

    @jax.jit
    def fn(grid_ri, ce_ri, noise, ctrl_idx):
        return jax.vmap(one, in_axes=(0, 0, 0, None))(
            grid_ri, ce_ri, noise, ctrl_idx)

    return fn


@dataclasses.dataclass
class PendingFrontend:
    """One dispatched DL front-end window: device grids + packed ctrl."""

    abc: tuple           # (grid_ri, ce_ri, noise) device arrays
    packed: jnp.ndarray  # (W, 2·n_ctrl + 2) f32
    sf_indices: list


class WindowedUeFrontEnd:
    """UE control+data front-end at window rate (see module docstring).

    Wraps a `WindowedUeDl`: `dispatch` runs stage A + control equalize;
    `realize` is one readback; `dispatch_data` decodes the window's
    grants from the STORED grids (no re-upload / re-FFT)."""

    def __init__(self, cell: Cell, cfi: int = 2, w: int = 32,
                 scheme: str = "port0", ingest: str = "int8",
                 max_iterations: int = 5):
        self.inner = WindowedUeDl(cell, cfi=cfi, w=w, scheme=scheme,
                                  ingest=ingest,
                                  max_iterations=max_iterations)
        self.cell = cell
        self.cfi = cfi
        self.w = w
        self.layout = ctrl_layout(cell, cfi)
        self._idx_dev = jnp.asarray(self.layout.idx)
        self._fe = _build_win_fe(self.inner.nof_ports)

    def dispatch(self, samples, sf_indices) -> PendingFrontend:
        """samples (W, nrx, sf_len) complex64 (or pre-quantized device
        array) → pending front-end."""
        from .pipeline_window import _stack_cached

        inner = self.inner
        samples_q, scale = _quantize_ingest(samples, inner.ingest)
        if not hasattr(inner, "_stackc"):
            inner._stackc = {}
        refs = _stack_cached(inner._stackc, ("refs", tuple(sf_indices)),
                             lambda: [inner._ref(s) for s in sf_indices])
        abc = inner._a(_upload(samples_q), jnp.asarray(scale), refs)
        packed = self._fe(abc[0], abc[1], abc[2], self._idx_dev)
        return PendingFrontend(abc, packed, list(sf_indices))

    def realize(self, pf: PendingFrontend):
        """ONE readback → (ctrl_eq (W, n_ctrl) complex64, rsrp (W,),
        noise (W,))."""
        arr = np.asarray(pf.packed)
        n = self.layout.idx.size
        ctrl = arr[:, : 2 * n].reshape(arr.shape[0], n, 2)
        ctrl = (ctrl[..., 0] + 1j * ctrl[..., 1]).astype(np.complex64)
        return ctrl, arr[:, 2 * n], arr[:, 2 * n + 1]

    def dispatch_data(self, pf: PendingFrontend, grants, softbuffer=None):
        return self.inner.dispatch_window_from(pf.abc, pf.sf_indices,
                                               grants, softbuffer)

    def results(self, p):
        return self.inner.results(p)


# --------------------------------------------------------------------------
# window blind search (host numpy + ONE batched Viterbi per DCI length)
# --------------------------------------------------------------------------


def blind_search_dispatch(ctrl_eq: np.ndarray, layout: CtrlLayout,
                          cell: Cell, sf_indices, searches_per_tti):
    """Phase 1 of the windowed blind search: extract + de-rate-match all
    (TTI, RNTI, candidate) hypotheses and DISPATCH one batched Viterbi
    per DCI length; returns an opaque pending object for
    `blind_search_collect`.  Splitting the phases lets the caller put a
    TTI or two between the dispatch and the readback so the device
    round-trip rides the quiet TTIs."""
    from .phy.fec.conv import viterbi_decode
    from .phy.fec.rate_match import conv_rate_match_rx_np
    from .pipeline_window import _pow2_bucket

    from .phy.fec.rate_match import conv_rate_match_rx_batch_np

    w = len(sf_indices)
    # hypotheses grouped by (viterbi length d, aggregation level): same
    # slice width + same de-rate-match indices → ONE vectorized de-RM
    # per group instead of a scalar scatter per candidate
    raw: dict[tuple, list] = {}   # (d, lvl) -> [(meta, e_slice)]
    for t in range(w):
        reqs = searches_per_tti[t]
        if not reqs:
            continue
        sym = ctrl_eq[t, layout.pdcch]
        llr = np.empty(2 * sym.size, np.float32)  # QPSK demod (modem.py
        llr[0::2] = -SQRT2 * sym.real             # convention: +LLR ⇒ 1)
        llr[1::2] = -SQRT2 * sym.imag
        sf = sf_indices[t]
        for (rnti, fmt, dci_len, ue_sp) in reqs:
            signs = _blind_signs(rnti, sf, cell.id,
                                 CCE_BITS * layout.n_cce)
            ls = llr * signs[: llr.size]
            d = dci_len + 16
            for lvl, starts in _blind_candidates(rnti, sf, layout.n_cce,
                                                 ue_sp):
                for st in starts:
                    raw.setdefault((d, lvl), []).append(
                        ((t, rnti, fmt, dci_len, lvl, st),
                         ls[st * CCE_BITS: (st + lvl) * CCE_BITS]))
    hyps: dict[int, list] = {}   # d -> [(meta, (3, d) llr)]
    for (d, _lvl), group in raw.items():
        dll = conv_rate_match_rx_batch_np(
            np.stack([g[1] for g in group]), d)
        lst = hyps.setdefault(d, [])
        for (meta, _e), row in zip(group, dll):
            lst.append((meta, row))
    pend = []
    for d, entries in hyps.items():
        # pad the hypothesis batch to a pow2 bucket: the count varies
        # per window and every new shape is a (remote) recompile
        nb = _pow2_bucket(len(entries))
        stackb = np.zeros((nb,) + entries[0][1].shape, np.float32)
        for k, e in enumerate(entries):
            stackb[k] = e[1]
        bits_dev = viterbi_decode(jnp.asarray(stackb), d)
        try:
            bits_dev.copy_to_host_async()
        except Exception:
            pass
        pend.append((d, entries, bits_dev))
    return w, pend


@lru_cache(maxsize=16)
def _crc16_gen(nbits: int) -> np.ndarray:
    """(nbits, 16) GF(2) generator: CRC16 of a message = bits @ G mod 2
    (the LTE CRC is zero-initialised, hence linear) — one batched matmul
    checks a whole window's hypotheses."""
    g = np.zeros((nbits, 16), np.uint8)
    for i in range(nbits):
        e = np.zeros(nbits, np.uint8)
        e[i] = 1
        g[i] = crc_compute_np(e, LTE_CRC16)
    return g


def blind_search_collect(pending):
    """Phase 2: realize the Viterbi batches, CRC-RNTI check (batched
    GF(2) matmul), dedup.  Returns per TTI a list of (rnti, fmt,
    dci_bits, agg_level, cce_start), TM-specific formats before the 1A
    fallback (the ue_dl.c format priority)."""
    w, pend = pending
    found: list[list] = [[] for _ in range(w)]
    seen: list[set] = [set() for _ in range(w)]
    for d, entries, bits_dev in pend:
        bits = np.asarray(bits_dev)
        dci_len = entries[0][0][3]
        ne = len(entries)
        calc = (bits[:ne, :dci_len].astype(np.uint8)
                @ _crc16_gen(dci_len)) % 2          # (ne, 16)
        for k, (((t, rnti, fmt, _dl, lvl, st), _), b) in enumerate(
                zip(entries, bits)):
            mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)],
                            np.uint8)
            if not np.array_equal(b[dci_len:d] ^ mask, calc[k]):
                continue
            # one hit per distinct payload: a DCI sent at agg L also
            # CRC-passes at nested/overlapping candidates (the per-TTI
            # path's one-grant loop absorbs these; pdcch.c:420 dedups
            # the same way)
            key = (rnti, b[:dci_len].tobytes())
            if key in seen[t]:
                continue
            seen[t].add(key)
            found[t].append((rnti, fmt, b[:dci_len], lvl, st))
    for t in range(w):
        found[t].sort(key=lambda f: f[1] == "1A")
    return found


def window_blind_search(ctrl_eq: np.ndarray, layout: CtrlLayout,
                        cell: Cell, sf_indices, searches_per_tti):
    """Blind-decode a whole window's PDCCH (synchronous form — the
    dispatch/collect split above is the pipelined one)."""
    return blind_search_collect(blind_search_dispatch(
        ctrl_eq, layout, cell, sf_indices, searches_per_tti))


def phich_decode_np(sym_eq, cell: Cell, sf_idx: int, n_seq: int):
    """numpy mirror of `phch.phich.phich_decode` (12 symbols — the
    per-TTI eager-JAX form costs a device dispatch per watched PID)."""
    from .phy.phch.pcfich import pcfich_cinit
    from .phy.phch.phich import phich_nsf, phich_sequence
    from .phy.sequence import gold_sequence_signs

    nsf = phich_nsf(cell)
    signs = gold_sequence_signs(pcfich_cinit(sf_idx, cell.id), 3 * nsf)
    z = (np.asarray(sym_eq) * signs).reshape(3, nsf)
    corr = np.sum(z * np.conj(phich_sequence(n_seq, nsf)), axis=-1)
    metric = float(np.real(np.sum(corr)))
    return metric < 0, metric


@lru_cache(maxsize=512)
def _f1_refs(cell: Cell, n_pucch: int, delta_shift: int, sf_idx: int):
    """(dmrs_ref, data_ref) (nsymb_sf, 12) complex conj-reference grids
    for PUCCH format 1 on one (resource, subframe) — zero outside each
    part's symbols.  Lets a whole window's ACK decodes run as one
    vectorized correlation."""
    from .phy.phch.pucch import (W3, W4, PucchConfig, _f1_alpha_cover,
                                 _f1_covers, _f1_syms, base_sequence)

    cfg = PucchConfig(n_pucch=n_pucch, delta_shift=delta_shift)
    u = cell.id % 30
    r = base_sequence(u, 12)
    n = np.arange(12)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f1_syms(cell)
    wd = W3 if nsym == 7 else None
    from .phy.phch.pucch import W2

    if wd is None:
        wd = W2
    c = _f1_covers(cell)
    dmrs = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    data = np.zeros((cell.nsymb_per_sf, 12), np.complex64)
    for slot in range(2):
        ns = 2 * sf_idx + slot
        shifts, cover = _f1_alpha_cover(cell, cfg, ns)
        for i, l in enumerate(dmrs_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            dmrs[slot * nsym + l] = (np.exp(1j * alpha * n) * r
                                     * wd[cover % c, i])
        for i, l in enumerate(data_syms):
            alpha = 2 * np.pi * shifts[l] / 12
            data[slot * nsym + l] = (np.exp(1j * alpha * n) * r
                                     * np.float32(W4[cover % c, i]))
    return dmrs, data, len(dmrs_syms), len(data_syms)


def pucch_format1_decode_batch(grids: np.ndarray, cell: Cell,
                               n_pucch: int, sfs, nof_bits: int,
                               delta_shift: int = 2):
    """Vectorized mirror of `pucch_format1_decode` over B subframes on
    ONE resource (the saturated single-UE ACK stream): returns
    (bits (B, nof_bits), metric (B,)) with the same math/thresholds as
    the scalar form."""
    b = grids.shape[0]
    nsym = cell.nsymb_per_slot
    dmrs = np.stack([_f1_refs(cell, n_pucch, delta_shift, s)[0]
                     for s in sfs])
    data = np.stack([_f1_refs(cell, n_pucch, delta_shift, s)[1]
                     for s in sfs])
    n_dmrs = _f1_refs(cell, n_pucch, delta_shift, sfs[0])[2]
    n_data = _f1_refs(cell, n_pucch, delta_shift, sfs[0])[3]
    g = grids.reshape(b, 2, nsym, 12)
    dm = dmrs.reshape(b, 2, nsym, 12)
    da = data.reshape(b, 2, nsym, 12)
    h = (g * np.conj(dm)).sum(axis=(2, 3)) / (n_dmrs * 12)   # (B, 2)
    z = (g * np.conj(da)).sum(axis=3) / 12                   # (B, 2, nsym)
    w = np.conj(h)[:, :, None] / (np.abs(h)[:, :, None] ** 2 + 1e-9)
    mask = (np.abs(da).sum(axis=3) > 0)                      # data syms
    d = (z * w * mask).sum(axis=(1, 2)) / (2 * n_data)
    est = (np.abs(h) ** 2).sum(axis=1)
    metric = est / (np.mean(np.abs(g) ** 2, axis=(1, 2, 3)) + 1e-12)
    if nof_bits == 0:
        return np.zeros((b, 0), np.uint8), metric
    if nof_bits == 1:
        return ((d.real + d.imag) < 0).astype(np.uint8)[:, None], metric
    return np.stack([(d.real < 0), (d.imag < 0)],
                    axis=1).astype(np.uint8), metric


@lru_cache(maxsize=8)
def _rm_codebook_np(o: int, e: int, use20: bool):
    from .phy.phch.uci import _codebook

    return np.asarray(_codebook(o, e, use20), np.float32)


def pucch_format2_decode_np(prb_grid, cell: Cell, cfg, sf_idx: int,
                            nof_bits: int):
    """numpy mirror of `phch.pucch.pucch_format2_decode` — coherent
    despread + RM(20,O) ML correlation, zero device dispatches."""
    from .phy.phch.pucch import _f2_syms, base_sequence, ncs_cell
    from .phy.sequence import gold_sequence

    u = cell.id % 30
    r = np.asarray(base_sequence(u, 12))
    n = np.arange(12)
    ncs = ncs_cell(cell)
    nsym = cell.nsymb_per_slot
    data_syms, dmrs_syms = _f2_syms(cell)
    grid = np.asarray(prb_grid)
    zs = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        h_acc = 0.0
        for l in dmrs_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r
            h_acc = h_acc + np.sum(grid[slot * nsym + l] * np.conj(ref))
        h = h_acc / (len(dmrs_syms) * 12)
        for l in data_syms:
            alpha = 2 * np.pi * ((cfg.n_pucch + ncs[ns, l]) % 12) / 12
            ref = np.exp(1j * alpha * n).astype(np.complex64) * r
            z = np.sum(grid[slot * nsym + l] * np.conj(ref)) / 12
            zs.append(z * np.conj(h) / (np.abs(h) ** 2 + 1e-9))
    d = np.stack(zs)                       # (10,) QPSK symbols
    llr = np.empty(20, np.float32)
    llr[0::2] = -SQRT2 * d.real
    llr[1::2] = -SQRT2 * d.imag
    seq = gold_sequence(
        (((sf_idx * 2 + 1) * (2 * cell.id + 1)) << 9) + cell.id, 20)
    llr = llr * (1.0 - 2.0 * seq).astype(np.float32)
    book = _rm_codebook_np(nof_bits, 20, True)  # (2^o, 20) ±1
    corr = book @ (-llr)
    best = int(np.argmax(corr))
    bits = ((best >> np.arange(nof_bits)) & 1).astype(np.uint8)
    metric = float(np.max(corr) / (np.sum(np.abs(llr)) + 1e-9))
    return bits, metric


# --------------------------------------------------------------------------
# eNB control overlay render (host numpy, heavily cached) — the values the
# device TX window scatters over its template (enb_dl.c control half)
# --------------------------------------------------------------------------


def _qpsk_np(bits: np.ndarray) -> np.ndarray:
    """numpy mirror of `modulate(Mod.QPSK, ...)` (modem.py Gray map)."""
    s = (1.0 - 2.0 * bits.astype(np.float32)) * np.float32(1 / np.sqrt(2))
    return (s[0::2] + 1j * s[1::2]).astype(np.complex64)


@lru_cache(maxsize=32)
def _overlay_layout(cell: Cell, cfi: int):
    from .phy.phch.pbch import pbch_re_indices

    lay = ctrl_layout(cell, cfi)
    pbch_idx = np.asarray(pbch_re_indices(cell), np.int32)
    s = cell.nsymb_per_sf * cell.nof_re_per_symbol
    idx_pad = np.concatenate([lay.idx,
                              np.full(pbch_idx.size, s, np.int32)])
    idx_sf0 = np.concatenate([lay.idx, pbch_idx])
    return lay, idx_pad, idx_sf0


@lru_cache(maxsize=64)
def _pcfich_syms_np(cell: Cell, sf_idx: int, cfi: int) -> np.ndarray:
    from .phy.phch.pcfich import CFI_LEN, cfi_codeword, pcfich_cinit
    from .phy.sequence import gold_sequence

    cw = cfi_codeword(cfi)
    seq = gold_sequence(pcfich_cinit(sf_idx, cell.id), CFI_LEN)
    return _qpsk_np(np.asarray(cw ^ seq, np.uint8))


@lru_cache(maxsize=256)
def _phich_syms_np(cell: Cell, sf_idx: int, n_seq: int,
                   ack: int) -> np.ndarray:
    from .phy.phch.pcfich import pcfich_cinit
    from .phy.phch.phich import phich_encode, phich_nsf
    from .phy.sequence import gold_sequence_signs

    nsf = phich_nsf(cell)
    signs = gold_sequence_signs(pcfich_cinit(sf_idx, cell.id), 3 * nsf)
    return (phich_encode(ack, n_seq, nsf) * signs).astype(np.complex64)


@lru_cache(maxsize=64)
def _pdcch_seq(cell_id: int, sf_idx: int, nbits: int) -> np.ndarray:
    from .phy.phch.pdcch import pdcch_cinit
    from .phy.sequence import gold_sequence

    return np.asarray(
        gold_sequence(pdcch_cinit(0, sf_idx, cell_id), nbits), np.uint8)


@lru_cache(maxsize=4096)
def _dci_coded_np(dci_bits: tuple, rnti: int, agg: int) -> np.ndarray:
    """DCI payload → (72·agg,) coded bits, all numpy (mirror of
    `pdcch.dci_encode_np` minus its jax rate-match dispatch)."""
    from .phy.fec.conv import convcoder_encode_np
    from .phy.fec.rate_match import conv_rm_indices

    b = np.asarray(dci_bits, np.uint8)
    crc = crc_compute_np(b, LTE_CRC16)
    mask = np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)
    coded = convcoder_encode_np(np.concatenate([b, crc ^ mask]))
    flat = coded.reshape(-1)
    return flat[conv_rm_indices(coded.shape[-1], CCE_BITS * agg)]


def enb_ctrl_overlay(cell: Cell, cfi: int, sf_idx: int, sched,
                     mib=None, sfn: int = 0):
    """Render one TTI's control region → (idx (n_ov,), vals (n_ov,)).

    `sched`: an `enb_dl.DlSched` (cfi must equal the engine's; phich =
    [(group, n_seq, ack)], dcis = [(bits, rnti, agg, cce)]).  PBCH rides
    the overlay on subframe 0 (it changes every frame); unused PDCCH REs
    stay 0 — nothing is transmitted on unallocated CCEs, as in
    enb_dl.c.  Single-port cells only (the windowed control plane's
    current scope)."""
    lay, idx_pad, idx_sf0 = _overlay_layout(cell, cfi)
    vals = np.zeros(idx_pad.size, np.complex64)
    vals[lay.pcfich] = _pcfich_syms_np(cell, sf_idx, sched.cfi)
    for group, n_seq, ack in sched.phich:
        vals[lay.phich[group]] += _phich_syms_np(cell, sf_idx, n_seq, ack)
    seq = _pdcch_seq(cell.id, sf_idx, CCE_BITS * lay.n_cce)
    pd = vals[lay.pdcch]
    for dci_bits, rnti, agg, cce in sched.dcis:
        coded = _dci_coded_np(tuple(int(x) for x in dci_bits), rnti, agg)
        scr = coded ^ seq[cce * CCE_BITS: (cce + agg) * CCE_BITS]
        pd[cce * 36: (cce + agg) * 36] = _qpsk_np(scr)
    if sf_idx == 0 and mib is not None:
        import dataclasses as _dc

        from .phy.phch.pbch import pbch_encode_np

        mib = _dc.replace(mib, sfn=sfn)
        vals[lay.idx.size:] = pbch_encode_np(mib, cell, 1)[sfn % 4]
        return idx_sf0, vals
    return idx_pad, vals


# --------------------------------------------------------------------------
# eNB UL front-end window (FFT all W + band-edge PUCCH extraction)
# --------------------------------------------------------------------------


def _build_win_ul_fe(cell: Cell, edge_prbs: int):
    from .phy.ofdm import OfdmConfig, ofdm_rx_sf

    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    e = 12 * edge_prbs
    nre = cell.nof_re_per_symbol

    @jax.jit
    def fn(samples_q, scale):
        def one(s_q, sc):
            grid = ofdm_rx_sf(
                ofdm, _ri2c(s_q.astype(jnp.float32) * sc))  # (nrx,sym,re)
            edge = jnp.concatenate(
                [grid[..., :e], grid[..., nre - e:]], axis=-1)
            # per-PRB mean rx power: the enb_ul.c DTX gate needs the
            # power over each ALLOCATION (an empty allocation's zero
            # LLRs decode to the valid all-zero codeword)
            prb_pow = jnp.mean(
                jnp.abs(grid) ** 2,
                axis=(0, 1)).reshape(cell.nof_prb, 12).mean(axis=-1)
            # MRC-free single-antenna PUCCH view (antenna 0) — the host
            # correlators are per-resource anyway
            packed = jnp.concatenate(
                [_c2ri(edge[0]).reshape(-1), prb_pow])
            return _c2ri(grid), packed

        return jax.vmap(one)(samples_q, scale)

    return fn


@dataclasses.dataclass
class PendingUlFrontend:
    grid_ri: jnp.ndarray   # (W, nrx, nsymb, nre, 2) stored SC-FDMA grids
    edge: jnp.ndarray      # (W, nsymb, 2·12·edge_prbs, 2) f32
    sf_indices: list


class WindowedEnbUlFrontEnd:
    """eNB UL front-end at window rate: FFT W subframes once; PUCCH region
    to the host, PUSCH decode from the stored grids."""

    def __init__(self, cell: Cell, w: int = 32, edge_prbs: int = 4,
                 max_iterations: int = 5, ingest: str = "float32"):
        self.inner = WindowedEnbUl(cell, w=w,
                                   max_iterations=max_iterations,
                                   ingest=ingest)
        self.cell = cell
        self.w = w
        self.edge_prbs = edge_prbs
        self._fe = _build_win_ul_fe(cell, edge_prbs)

    def dispatch(self, samples, sf_indices) -> PendingUlFrontend:
        samples_q, scale = _quantize_ingest(samples, self.inner.ingest)
        grid_ri, edge = self._fe(_upload(samples_q), jnp.asarray(scale))
        return PendingUlFrontend(grid_ri, edge, list(sf_indices))

    def realize_pucch(self, pf: PendingUlFrontend):
        """ONE readback → ((W, nsymb, 2·12·edge_prbs) complex64 band-edge
        REs, (W, nof_prb) per-PRB rx power for the DTX gate)."""
        arr = np.asarray(pf.edge)
        nsym = self.cell.nsymb_per_sf
        e = 24 * self.edge_prbs
        edge_ri = arr[:, : nsym * e * 2].reshape(arr.shape[0], nsym, e, 2)
        edge = (edge_ri[..., 0] + 1j * edge_ri[..., 1]).astype(np.complex64)
        prb_pow = arr[:, nsym * e * 2:]
        return edge, prb_pow

    def pucch_prb_grid(self, edge_np: np.ndarray, t: int,
                       prb_slot: tuple[int, int]) -> np.ndarray:
        """Assemble the (nsymb, 12) PRB-local grid of one PUCCH resource
        from the extracted band edges; prb_slot = (PRB in slot 0, PRB in
        slot 1) — the §5.4.3 band-edge hop."""
        e, npr = self.edge_prbs, self.cell.nof_prb
        nsym = self.cell.nsymb_per_slot
        out = np.zeros((self.cell.nsymb_per_sf, 12), np.complex64)
        for slot, prb in enumerate(prb_slot):
            col = prb * 12 if prb < e else 12 * e + (prb - (npr - e)) * 12
            sl = slice(slot * nsym, (slot + 1) * nsym)
            out[sl] = edge_np[t, sl, col: col + 12]
        return out

    def dispatch_data(self, pf: PendingUlFrontend, grants,
                      softbuffer=None):
        return self.inner.dispatch_window_from(pf.grid_ri, pf.sf_indices,
                                               grants, softbuffer)

    def results(self, p):
        return self.inner.results(p)
