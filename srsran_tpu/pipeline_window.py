"""Windowed dynamic-grant pipeline: W TTIs per dispatch, ONE program set.

The per-TTI dynamic pipeline (`pipeline_dynamic.py`) reaches zero
steady-state recompiles, but each TTI still pays its own dispatches and
host↔device round-trips.  This module amortizes them: a **window** of
W consecutive TTIs is decoded by one dispatch of a fixed three-stage
program, whatever the per-TTI grants are:

* every grant-dependent quantity is **data**, not trace constants —
  modulation (all four constellations demodulated, one-hot selected),
  PRB sets (padded RE index vectors), TB layout, redundancy version, and
  the rate-matching indices, derived *on device* per codeblock
  (`phy/fec/rate_match_dev.py`) instead of host-built LUTs;
* stage C packs the window's codeblocks DENSELY into N slots (bucketed
  powers of two) instead of a (W, B_CB_max) grid — a typical mixed-grant
  window has ~3 CBs/TTI, so the always-max grid wasted 4-6x of every
  downstream op;
* all per-CB index work (de-rate-match fill, QPP interleaves) uses
  **window-global layout classes**: the ≤NCLS distinct (K, F, rv)
  layouts in the window get index tables shared by every slot, so each
  gather is fully vectorized (no per-row-index gathers);
* per-TTI constants that repeat across a connection (CRS references per
  subframe index, scrambling signs per (rnti, sf), RE index vectors per
  PRB set) are cached device-resident and stacked on device — besides
  the samples, each window uploads ONE packed int32 param vector;
* the whole window returns as ONE packed uint8 array (TB bits packed
  8-per-byte + CRC flag + per-TTI iteration count): one readback RPC
  per W TTIs.

This is the batched analog of the reference's sf_worker pipeline
(`thread_pool.h:46-77`, 4 subframes in flight): latency is traded for
sustained real-time throughput, with W as the depth knob.  The reference
processes arbitrary grants in 1 ms on 4 cores (`cc_worker.cc:214-307`);
here one device runs W TTIs per dispatch with a bounded-for-life
compile set (stage A/B fixed + one stage C per occupancy bucket).

Scope — all four directions of the sf_worker role:
* decode: `WindowedUeDl` (port0 SISO/MRC or TM2 SFBC), `WindowedUeDlMimo`
  (2-codeword TM3/TM4, PMI/CDD as data), `WindowedEnbUl` (multi-UE PUSCH,
  Bluestein IDFT de-precoding);
* generate: `WindowedEnbDl` (PDSCH data subframes, payload→baseband) and
  `WindowedUeUl` (PUSCH with DFT precoding) through a shared dynamic-K
  closed-form encode core.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .phy.chest.chest_dl import ChestDlConfig, _chest_tables
from .phy.common import Cell
from .phy.fec.cbsegm import cbsegm
from .phy.fec.rate_match_dev import j0_variant_np, ncb_max, qpp_np
from .phy.fec.turbo_dyn import crc_table_ab, turbo_decode_dyn
from .phy.mimo import predecode_diversity2, predecode_single_mrc
from .phy.modem import Mod, demod_soft
from .phy.ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
from .phy.phch.pdsch import DlGrant, pdsch_cinit
from .phy.phch.sch import FILLER_LLR, _e_split
from .phy.sequence import gold_sequence_signs
from .pipeline_dynamic import G_MAX, RE_BUCKETS, _padded_re_indices

K_MAX = 6144
MAX_CB = 16        # max codeblocks per TB (LTE max TBS 97896 @256QAM → 16)
RE_MAX = RE_BUCKETS[-1]
TBS_MAX = 98304    # ≥ max LTE single-codeword TBS (97896 @256QAM)
TB_BYTES = TBS_MAX // 8
QMS = (2, 4, 6, 8)
MODS = (Mod.QPSK, Mod.QAM16, Mod.QAM64, Mod.QAM256)

# stage C static-shape buckets (each combination lazily compiles once)
# bucket ladders use ~1.33-1.5x steps: stage C's fold/de-RM/reassembly
# costs scale with the PADDED sizes, which pow2/coarse ladders inflate
# (e.g. 176 real slots padded to 256, CF=22 classes padded to 32)
CLS_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128)
ECAP_BUCKETS = (16384, 24576, 32768, 49152, 65536, G_MAX)
JFOLD_BUCKETS = (0, 3, 11)  # log2 fold steps: rep==1 / <=8 / <=2048
TBCAP_BUCKETS = (1200, 4800, 9600, TB_BYTES)  # packed readback bytes/row


def _c2ri(x):
    return jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)


def _ri2c(x):
    return x[..., 0] + 1j * x[..., 1]


def _upload(x):
    """Host→device transfer of a shaped host array as a FLAT buffer +
    on-device reshape.  Device arrays pass through untouched
    (device-resident ingest)."""
    if isinstance(x, jax.Array):
        return x
    x = np.ascontiguousarray(x)
    return jnp.asarray(x.reshape(-1)).reshape(x.shape)


def _bucket_of(n, buckets):
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def _pow2_bucket(n):
    """Slot-count bucket: powers of two plus the 1.5x midpoints (12, 24,
    48, 96, 192, 384, …) — the dense-slot programs' fold cost scales
    linearly with the bucket, so the finer ladder saves up to 25% padded
    work per window at the cost of a few more cached compiles."""
    b = 8
    while True:
        if n <= b:
            return b
        if n <= b + b // 2:
            return b + b // 2
        b *= 2


# --------------------------------------------------------------------------
# device-side stacking of cached constants (no host uploads in steady state)
# --------------------------------------------------------------------------


@lru_cache(maxsize=64)
def _stacker(n: int):
    return jax.jit(lambda *xs: jnp.stack(xs))


def _stack_cached(cache: dict, key, rows_thunk):
    """Memoize a stacked device constant by its logical key: the stack
    inputs recur window after window (the sf pattern cycles, the RNTI is
    fixed), and every _stacker call is a device dispatch (a window
    issues half a dozen)."""
    v = cache.get(key)
    if v is None:
        rows = rows_thunk()
        v = _stacker(len(rows))(*rows)
        if len(cache) > 512:
            cache.clear()
        cache[key] = v
    return v


# --------------------------------------------------------------------------
# ingest quantization (int8 SQNR can pinch QAM256 near the waterfall —
# int16 and float32 ingest modes are selectable)
# --------------------------------------------------------------------------

_INGEST = {"int8": (np.int8, 127.0), "int16": (np.int16, 32767.0),
           "float32": (np.float32, None)}


def _quantize_ingest(samples, ingest: str):
    """samples (W, nrx, sf_len) complex → (quantized (…, 2), scale (W,)).

    A `jax.Array` input is the device-resident ingest path (loopback /
    serving topology — baseband generated on-chip never crosses the host
    link): expected already in (W, nrx, sf_len, 2) float32 RI layout,
    passed through with unit scales."""
    if isinstance(samples, jax.Array):
        assert samples.ndim == 4 and samples.shape[-1] == 2, (
            "device ingest expects (W, nrx, sf_len, 2) float32 RI")
        return samples, jnp.ones((samples.shape[0],), jnp.float32)
    w = samples.shape[0]
    sri = np.stack([samples.real, samples.imag], axis=-1)
    dt, full = _INGEST[ingest]
    if full is None:
        return sri.astype(np.float32), np.ones(w, np.float32)
    peak = np.maximum(np.abs(sri).reshape(w, -1).max(axis=1), 1e-12)
    scale = (peak / full).astype(np.float32)
    q = np.clip(np.round(sri / scale[:, None, None, None]), -full, full
                ).astype(dt)
    return q, scale


# --------------------------------------------------------------------------
# stage programs A and B (front-end; grant quantities as data)
# --------------------------------------------------------------------------


def _build_win_a(cell: Cell, w: int, nof_ports: int = 1):
    """Front-end for W subframes: OFDM demod + CRS chest (1 or 2 ports).

    Samples arrive quantized + a per-TTI scale — the native ADC layout
    (the reference ingests int16 from UHD / cf32 from ZMQ); int8 is 4x
    less host→device traffic than float32 on the ingest link.  The only
    subframe-dependent input is the conjugated CRS sequence — passed as
    data so one program serves all 10 subframe indices."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    cfg = ChestDlConfig()
    tabs = [_chest_tables(cell, 0, cfg, p) for p in range(nof_ports)]
    syms_d = [jnp.asarray(t[0]) for t in tabs]
    freqs_d = [jnp.asarray(t[1]) for t in tabs]
    wf_d = [jnp.asarray(t[3]) for t in tabs]
    wt_d = [jnp.asarray(t[4]) for t in tabs]

    def one(samples_q, scale, ref_conj_ri):
        samples = _ri2c(samples_q.astype(jnp.float32) * scale)
        grid = ofdm_rx_sf(ofdm, samples)     # (nrx, nsymb, nre)
        ces, noises = [], []
        for p in range(nof_ports):
            pilots = grid[..., syms_d[p][:, None], freqs_d[p]]
            ls = pilots * _ri2c(ref_conj_ri[p])  # (nrx, 4, npil)
            per_sym = jnp.einsum("snp,rsp->rsn", wf_d[p], ls)
            ces.append(jnp.einsum(
                "ls,rsn->rln", wt_d[p].astype(jnp.complex64), per_sym))
            resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
            noises.append(jnp.mean(jnp.abs(resid) ** 2) / 1.5)
        ce = jnp.stack(ces, axis=1)  # (nrx, nports, nsymb, nre)
        noise = sum(noises) / nof_ports
        return _c2ri(grid), _c2ri(ce), noise

    @jax.jit
    def fn(samples_q, scale, ref_conj_ri):
        return jax.vmap(one)(samples_q, scale, ref_conj_ri)

    return fn


def _gather_re_classes(grid_ri, ce_ri, idx_cls, cls_re):
    """Window-global class-shared RE gather: every TTI selects one of the
    ≤NCLS distinct (sf_idx, PRB-set) index vectors, so each gather's
    indices are SHARED across the whole window axis (the per-TTI-indexed
    form is a per-row gather).  The gathers run on a TRANSPOSED
    (S, W·nrx·…) layout, as gathers of major-axis ROWS instead of along
    the minor axis; the transposes fuse into the surrounding elementwise
    work.
    Returns (y (W, nrx, RE_MAX), h (W, nrx, P, RE_MAX)) complex."""
    w, nrx = grid_ri.shape[0], grid_ri.shape[1]
    p = ce_ri.shape[2]
    s = grid_ri.shape[2] * grid_ri.shape[3]
    r = idx_cls.shape[1]
    gt = grid_ri.reshape(w, nrx, s, 2).transpose(2, 0, 1, 3).reshape(s, -1)
    ct = ce_ri.reshape(w, nrx, p, s, 2).transpose(3, 0, 1, 2, 4).reshape(
        s, -1)
    ncls = idx_cls.shape[0]
    y = gt[idx_cls[0]]
    h = ct[idx_cls[0]]
    for v in range(1, ncls):
        m = cls_re == v
        y = jnp.where(jnp.repeat(m, nrx * 2)[None, :], gt[idx_cls[v]], y)
        h = jnp.where(jnp.repeat(m, nrx * p * 2)[None, :],
                      ct[idx_cls[v]], h)
    y = y.reshape(r, w, nrx, 2).transpose(1, 2, 0, 3)
    h = h.reshape(r, w, nrx, p, 2).transpose(1, 2, 3, 0, 4)
    return _ri2c(y), _ri2c(h)


def _build_win_b(w: int, scheme: str, qms: tuple = tuple(QMS)):
    """Grant front-end for W TTIs: class-shared RE gather → equalize
    (port0 MRC or TM2 SFBC combining) → demod (one-hot select by the
    per-TTI Qm over the constellations PRESENT in the window — the
    host knows the Qm set, so a uniform window demodulates once, not
    four times) → CSI weight → descramble.  Emits (W, G_MAX) masked
    LLRs."""

    def one(y, h, noise, n_re, qm, signs):
        if scheme == "diversity":
            x, csi = predecode_diversity2(y, h)
        else:
            x, csi = predecode_single_mrc(y, h[:, 0], noise)
        llr = jnp.zeros((G_MAX,), jnp.float32)
        for mod_c, qm_c in zip(MODS, QMS):
            if qm_c not in qms:
                continue
            lc = demod_soft(mod_c, x) * jnp.repeat(csi, qm_c)
            lc = jnp.zeros((G_MAX,), jnp.float32).at[: RE_MAX * qm_c].set(lc)
            llr = jnp.where(qm == qm_c, lc, llr)
        llr = llr * signs.astype(jnp.float32)
        mask = jnp.arange(G_MAX) < n_re * qm
        return jnp.where(mask, llr, 0.0)

    @jax.jit
    def fn(grid_ri, ce_ri, noise, idx_cls, cls_re, n_re, qm, signs):
        y, h = _gather_re_classes(grid_ri, ce_ri, idx_cls, cls_re)
        return jax.vmap(one)(y, h, noise, n_re, qm, signs)

    return fn


# --------------------------------------------------------------------------
# stage C: dense-slot TB decode, window-global layout classes
# --------------------------------------------------------------------------


@dataclasses.dataclass
class WindowPack:
    """Host-side dense-slot layout of one window's codeblocks."""

    key: tuple                  # static-shape key for the stage C program
    params: np.ndarray          # ONE packed int32 vector (single upload)
    row_start: list             # per row: first slot index
    row_ncb: list               # per row: codeblock count
    tbs: list                   # per row: TB size
    fill_classes: list          # distinct (k, f, rv) layouts, table order
    qpp_classes: list           # distinct k values, table order
    tb_classes: list            # distinct TB sizes, table order


def pack_window(row_specs) -> WindowPack:
    """Lay out a window's codeblocks densely.

    row_specs: per codeword row (tbs, g, qm, rv) — g the codeword length
    in bits.  Returns the packed param vector + the static bucket key
    (n_rows, n_slots, ncls_q, ncls_f, e_cap, j_fold, tb_cap, ncls_t,
    d_total).  The
    per-class de-rate-match/QPP index tables are NOT in the params —
    they depend only on (k, f, rv) and are cached device-resident
    (`_j0_table_dev`/`_qpp_table_dev`; building them on device measured
    15 ms per window).
    """
    slots = []           # (row, off, e, k, f, crcb, cls_f, cls_q, nv)
    fill_cls: dict = {}  # (k, f, rv) -> id
    qpp_cls: dict = {}   # k -> id
    row_start, row_ncb, row_tbs = [], [], []
    max_e, max_rep = 1, 1
    for r, (tbs, g, qm, rv) in enumerate(row_specs):
        segm = cbsegm(tbs)
        assert segm.C <= MAX_CB
        es = _e_split(g, segm.C, qm, 1)
        crcb = 1 if segm.C > 1 else 0
        row_start.append(len(slots))
        row_ncb.append(segm.C)
        row_tbs.append(tbs)
        off = 0
        for c, k in enumerate(segm.cb_sizes):
            f = segm.F if c == 0 else 0
            fc = fill_cls.setdefault((k, f, rv), len(fill_cls))
            qc = qpp_cls.setdefault(k, len(qpp_cls))
            nv = 3 * (k + 4) - 2 * f
            slots.append((r, off, es[c], k, f, crcb, fc, qc, nv))
            max_e = max(max_e, es[c])
            max_rep = max(max_rep, -(-es[c] // nv))
            off += es[c]

    n_rows = len(row_specs)
    tb_cls: dict = {}
    cls_tb = np.zeros(n_rows, np.int32)
    for r, tbs_r in enumerate(row_tbs):
        cls_tb[r] = tb_cls.setdefault(tbs_r, len(tb_cls))
    n_slots = _pow2_bucket(max(len(slots), 1))
    ncls_q = _bucket_of(len(qpp_cls), CLS_BUCKETS)
    ncls_f = _bucket_of(len(fill_cls), CLS_BUCKETS)
    ncls_t = _bucket_of(len(tb_cls), CLS_BUCKETS)
    e_cap = _bucket_of(max_e, ECAP_BUCKETS)
    j_fold = _bucket_of((max_rep - 1).bit_length(), JFOLD_BUCKETS)
    tb_cap = _bucket_of(-(-max(row_tbs) // 8), TBCAP_BUCKETS)
    # dense packed-readback size: each row contributes exactly its own
    # TB bytes + 2 status bytes (the (R, tb_cap) form read back the
    # window's LARGEST TB width for every row — 2-3x the bytes on a
    # ~45 MB/s link).  Pure pow2 ladder with a 2 KB floor: this bucket
    # keys a stage C recompile (~10 s remote), so it must stay COARSE
    # under live-scheduler traffic where per-window Σtbs wanders.
    d_total = max(2048, 1 << (sum(t // 8 + 2 for t in row_tbs) - 1)
                  .bit_length())

    p = np.zeros(8 * n_slots + 4 * n_rows, np.int32)
    sl = np.array(slots, np.int32).reshape(-1, 9)
    n = len(slots)
    p[0:n_slots][:n] = sl[:, 0] * G_MAX + sl[:, 1]     # flat llr offset
    p[1 * n_slots:2 * n_slots][:n] = sl[:, 2]          # e (0 = unused pad)
    p[2 * n_slots:3 * n_slots] = 40
    p[2 * n_slots:3 * n_slots][:n] = sl[:, 3]          # k
    p[3 * n_slots:4 * n_slots][:n] = sl[:, 4]          # f
    p[4 * n_slots:5 * n_slots][:n] = sl[:, 5]          # crcb
    p[5 * n_slots:6 * n_slots][:n] = sl[:, 6]          # cls_f
    p[6 * n_slots:7 * n_slots][:n] = sl[:, 7]          # cls_q
    p[7 * n_slots:8 * n_slots] = 1
    p[7 * n_slots:8 * n_slots][:n] = sl[:, 8]          # n_valid
    o = 8 * n_slots
    p[o:o + n_rows] = row_tbs
    p[o + n_rows:o + 2 * n_rows] = row_ncb
    p[o + 2 * n_rows:o + 3 * n_rows] = row_start
    p[o + 3 * n_rows:o + 4 * n_rows] = cls_tb

    return WindowPack(
        key=(n_rows, n_slots, ncls_q, ncls_f, e_cap, j_fold, tb_cap,
             ncls_t, d_total),
        params=p, row_start=row_start, row_ncb=row_ncb, tbs=row_tbs,
        fill_classes=list(fill_cls), qpp_classes=list(qpp_cls),
        tb_classes=list(tb_cls))


# Device-table cache budgets: the tables are cheap to
# rebuild host-side, so the caches are sized for one busy cell's working
# set instead of every (k, f, rv)/TBS combination ever seen — worst-case
# pinned HBM stays ~100 MB instead of ~1 GB:
#   j0: 512 x ~74 KB = 38 MB;  tb: 128 x ~394 KB = 50 MB;
#   tx: 64 x <=440 KB = 28 MB.


@lru_cache(maxsize=512)
def _j0_table_dev(k: int, f: int, rv: int) -> jnp.ndarray:
    """Device-resident de-rate-match index table of one layout class."""
    j0, _nv = j0_variant_np(k, f, rv, K_MAX)
    return jnp.asarray(j0)


@lru_cache(maxsize=512)
def _qpp_table_dev(k: int):
    per, inv = qpp_np(k, K_MAX)
    return jnp.asarray(per), jnp.asarray(inv)


@lru_cache(maxsize=128)
def _tb_gather_dev(tbs: int) -> jnp.ndarray:
    """Per-TB-size reassembly gather table: local source index into a
    row's contiguous slot region (MAX_CB*K_MAX bits, dump = the final
    zero pad) for each bit of the right-aligned TB||CRC stream — the
    class-shared replacement for the 16-step scatter-ish
    dynamic-update-slice reassembly loop (measured 7.9 ms/window)."""
    segm = cbsegm(tbs)
    crcb = 1 if segm.C > 1 else 0
    dump = MAX_CB * K_MAX
    idx = np.full(TBS_MAX + 24, dump, np.int32)
    u0 = TBS_MAX + 24 - (tbs + 24)
    startb = 0
    for c, k in enumerate(segm.cb_sizes):
        f = segm.F if c == 0 else 0
        take = k - f - 24 * crcb
        u = np.arange(take)
        idx[u0 + startb + u] = c * K_MAX + f + u
        startb += take
    assert startb == tbs + 24
    return jnp.asarray(idx)


def class_tables(pack: WindowPack):
    """Stack the window's cached per-class tables on device:
    (j0_tab (CF, 3*(K+4)), perq (CQ, K), invq (CQ, K),
    tb_tab (CT, TBS_MAX+24))."""
    cq, cf, ct = pack.key[2], pack.key[3], pack.key[7]
    f_rows = [_j0_table_dev(*c) for c in pack.fill_classes]
    f_rows += [f_rows[0]] * (cf - len(f_rows))
    q = [_qpp_table_dev(k) for k in pack.qpp_classes]
    p_rows = [a for a, _ in q] + [q[0][0]] * (cq - len(q))
    i_rows = [b for _, b in q] + [q[0][1]] * (cq - len(q))
    t_rows = [_tb_gather_dev(t) for t in pack.tb_classes]
    t_rows += [t_rows[0]] * (ct - len(t_rows))
    return (_stacker(cf)(*f_rows), _stacker(cq)(*p_rows),
            _stacker(cq)(*i_rows), _stacker(ct)(*t_rows))


@lru_cache(maxsize=256)
def _build_win_c(n_rows: int, n_slots: int, ncls_q: int, ncls_f: int,
                 e_cap: int, j_fold: int, tb_cap: int, ncls_t: int,
                 d_total: int, max_iterations: int):
    """Dense-slot TB decode: fold codeword segments (contiguous slices +
    log-halving for arbitrary repetition counts), class-shared
    de-rate-match gathers (HARQ += into the softbuffer), dynamic-K turbo
    over the N dense slots with window-global class QPP, per-CB + TB CRC,
    per-row reassembly → ONE dense packed result buffer
    (d_total + tb_cap + 2,) uint8 where row r occupies
    [off_r, off_r + tbs_r/8 + 2) as [tb bytes | ok | n_it] — exactly the
    row's own bytes are read back, not the window's largest-TB width.

    Every index-dependent step uses indices shared across the whole slot
    axis, contiguous dynamic slices, or contiguous dynamic-update-slices
    — never per-row arbitrary gathers."""
    crc_ab = jnp.asarray(crc_table_ab(K_MAX))
    from .phy.common import LTE_CRC24A
    from .phy.crc import crc_matrix_np

    # TB stream width bucketed to the window's largest TB (leading-zeros
    # invariance keeps the CRC matrix exact at any width ≥ tbs) — the
    # reassembly gather and TB-CRC matmul would otherwise be sized TBS_MAX
    # for every window
    sw = tb_cap * 8
    tb_table = jnp.asarray(crc_matrix_np(LTE_CRC24A, sw).astype(np.float32))
    pow2 = jnp.asarray((1 << np.arange(7, -1, -1)).astype(np.uint8))
    NCB = ncb_max(K_MAX)
    D = K_MAX + 4

    N, CQ, CF, R, CT = n_slots, ncls_q, ncls_f, n_rows, ncls_t

    @jax.jit
    def fn(llr, params, j0_tab, perq, invq, tb_tab, softbuffer):
        s_off = params[0:N]
        s_e = params[N:2 * N]
        s_k = params[2 * N:3 * N]
        s_f = params[3 * N:4 * N]
        s_crcb = params[4 * N:5 * N]
        s_clsf = params[5 * N:6 * N]
        s_clsq = params[6 * N:7 * N]
        nv = params[7 * N:8 * N]
        o = 8 * N
        row_ncb = params[o + R:o + 2 * R]
        row_start = params[o + 2 * R:o + 3 * R]
        cls_tb = params[o + 3 * R:o + 4 * R]

        valid = s_e > 0

        # --- fold codeword segments onto circular positions ---
        llr_flat = jnp.concatenate(
            [llr.reshape(-1), jnp.zeros((e_cap,), llr.dtype)])
        pos_e = jnp.arange(e_cap)

        def fold_one(off, e, nv_s):
            seg = jax.lax.dynamic_slice(llr_flat, (off,), (e_cap,))
            seg = jnp.where(pos_e < e, seg, 0.0)
            # log-halving fold: block b += block b + 2^j (blocks of nv_s);
            # handles ANY repetition count in j_fold static steps; j_fold
            # == 0 when the whole window has no repetition (rate > 1/3
            # everywhere).
            # The zero tail is padded ONCE — folded values beyond e stay
            # zero (both addends are), so only the head ever updates.
            m = (e + nv_s - 1) // jnp.maximum(nv_s, 1)
            if j_fold:
                buf = jnp.concatenate(
                    [seg, jnp.zeros((e_cap,), seg.dtype)])
                for j in range(j_fold - 1, -1, -1):
                    sh = jax.lax.dynamic_slice(
                        buf, ((1 << j) * nv_s,), (e_cap,))
                    head = jnp.where(m > (1 << j), buf[:e_cap] + sh,
                                     buf[:e_cap])
                    buf = buf.at[:e_cap].set(head)
                    m = jnp.minimum(m, 1 << j)
                seg = buf[:e_cap]
            if e_cap >= NCB:
                return seg[:NCB]
            return jnp.concatenate(
                [seg, jnp.zeros((NCB - e_cap,), seg.dtype)])

        acc = jax.vmap(fold_one)(s_off, s_e, nv)  # (N, NCB)
        acc = jnp.concatenate(
            [acc, jnp.zeros((N, 1), acc.dtype)], axis=1)  # dump slot NCB

        # --- class-shared de-rate-match gathers + select (the per-class
        # index tables are CACHED device constants — see class_tables) ---
        fill = acc[:, j0_tab[0]]
        for c in range(1, CF):
            fill = jnp.where((s_clsf == c)[:, None], acc[:, j0_tab[c]], fill)
        fill = jnp.where(valid[:, None], fill, 0.0)
        new_soft = softbuffer + fill.reshape(N, 3, D)

        # pin filler bits (known 0) in the systematic stream
        d = new_soft
        pin = jnp.arange(D)[None, :] < s_f[:, None]
        d = d.at[:, 0, :].set(jnp.where(pin, FILLER_LLR, d[:, 0, :]))

        # --- dynamic-K turbo with window-global class QPP ---
        bf = s_crcb.astype(bool)
        bits, _post, it_vec = turbo_decode_dyn(
            d, s_k, None, None, valid, K_MAX, max_iterations,
            crc_table=crc_ab, crc_is_b=bf,
            class_perms=(perq, invq, s_clsq))

        # --- final per-CB CRC: roll to buffer tail via contiguous slices
        # (uint8 left-pad form: bits beyond K are zero, so the padded
        # window right-aligns them at 1/4 the f32 traffic)
        cat = jnp.concatenate(
            [jnp.zeros((N, K_MAX), jnp.uint8), bits], axis=1)
        tail_bits = jax.vmap(
            lambda row, k: jax.lax.dynamic_slice(row, (k,), (K_MAX,))
        )(cat, s_k)
        acc2 = jnp.matmul(tail_bits.astype(jnp.float32), crc_ab,
                          preferred_element_type=jnp.float32)
        okA = jnp.all((acc2[:, :24].astype(jnp.int32) & 1) == 0, axis=-1)
        okB = jnp.all((acc2[:, 24:].astype(jnp.int32) & 1) == 0, axis=-1)
        cb_ok = jnp.where(bf, okB, okA)

        # --- per-row reassembly via class-shared TB gather tables: rows
        # of the same TB size share the index vector (_tb_gather_dev), so
        # the gather vectorizes — replaces a 16-step scatter-ish
        # dynamic-update-slice loop (7.9 ms/window) ---
        bits_flat = jnp.concatenate(
            [bits.reshape(-1),
             jnp.zeros((MAX_CB * K_MAX + 1,), bits.dtype)])
        region = jax.vmap(lambda st: jax.lax.dynamic_slice(
            bits_flat, (st * K_MAX,), (MAX_CB * K_MAX + 1,)))(row_start)
        region = region.at[:, MAX_CB * K_MAX].set(0)  # dump slot
        # the stream is right-aligned: only the trailing sw+24 bits can be
        # non-pad for any row in this window, so the class tables are
        # statically cropped to that width
        stream = region[:, tb_tab[0, TBS_MAX - sw:]]
        for c in range(1, CT):
            stream = jnp.where((cls_tb == c)[:, None],
                               region[:, tb_tab[c, TBS_MAX - sw:]], stream)
        tbp = stream[:, :sw]
        rx_crc = stream[:, sw:]
        # per-row CB ok / iteration stats (scalar-only loop)
        row_cb_ok = jnp.ones((R,), bool)
        row_it = jnp.zeros((R,), jnp.int32)
        for c in range(MAX_CB):
            sidx = jnp.clip(row_start + c, 0, N - 1)
            in_row = c < row_ncb
            row_cb_ok = row_cb_ok & jnp.where(in_row, cb_ok[sidx], True)
            row_it = jnp.maximum(
                row_it, jnp.where(in_row, it_vec[sidx], 0))
        crc_calc = (
            jnp.matmul(tbp.astype(jnp.float32), tb_table,
                       preferred_element_type=jnp.float32).astype(jnp.int32)
            & 1
        ).astype(jnp.uint8)
        tb_ok = row_cb_ok & jnp.all(crc_calc == rx_crc, axis=1)
        # pack only the trailing tb_cap bytes (TBs are right-aligned) —
        # the readback link runs ~25-45 MB/s, so the packed width is
        # bucketed to the window's largest TB
        tb_bytes = jnp.sum(
            tbp.reshape(R, tb_cap, 8) * pow2[None, None, :], axis=-1
        ).astype(jnp.uint8)
        rows = jnp.concatenate(
            [
                tb_bytes,
                tb_ok.astype(jnp.uint8)[:, None],
                jnp.clip(row_it, 0, 255).astype(jnp.uint8)[:, None],
            ],
            axis=1,
        )
        # dense pack: left-align each row's real block ([trailing tbs/8
        # bytes | ok | it]) with a batched contiguous slice, then write
        # the R fixed-width segments at ascending dense offsets — later
        # rows overwrite earlier rows' zero tails (in-order
        # dynamic_update_slice, no scatter)
        row_tbs = params[o:o + R]
        nb = row_tbs // 8 + 2
        off = jnp.cumsum(nb) - nb
        src = jnp.concatenate(
            [rows, jnp.zeros((R, tb_cap + 2), jnp.uint8)], axis=1)
        segs = jax.vmap(lambda row, n: jax.lax.dynamic_slice(
            row, (tb_cap + 2 - n,), (tb_cap + 2,)))(src, nb)
        dense = jnp.zeros((d_total + tb_cap + 2,), jnp.uint8)
        for r in range(R):
            dense = jax.lax.dynamic_update_slice(
                dense, segs[r], (off[r],))
        return dense, new_soft

    return fn


# --------------------------------------------------------------------------
# softbuffer routing (dense slots)
# --------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _soft_extract_fn():
    def ex(s, st, n_cb):
        blk = jax.lax.dynamic_slice(
            jnp.concatenate([s, jnp.zeros((MAX_CB,) + s.shape[1:], s.dtype)]),
            (st, 0, 0), (MAX_CB,) + s.shape[1:])
        # zero the padded tail — those dense slots belong to OTHER rows
        mask = jnp.arange(MAX_CB)[:, None, None] < n_cb
        return jnp.where(mask, blk, 0.0)

    return jax.jit(ex)


@lru_cache(maxsize=8)
def _soft_place_fn():
    return jax.jit(lambda s, blk, st: jax.lax.dynamic_update_slice(
        s, blk, (st, 0, 0)))


@dataclasses.dataclass
class PendingWindow:
    """A dispatched window (device arrays); realize with `results`."""

    # dense 1-D (d_total + tb_cap + 2,) uint8 buffer: row r's block lives
    # at its cumulative offset as [tbs/8 tb bytes | ok | n_it] (see
    # `WindowedUeDl.results` for the walk)
    packed: jnp.ndarray
    softbuffer: jnp.ndarray  # (n_slots, 3, K_MAX + 4) dense slot layout
    tbs: list                # per-row true TB sizes
    pack: WindowPack | None = None


def extract_softbuffer(p: PendingWindow, row: int) -> jnp.ndarray:
    """Device-resident softbuffer block of window row `row` (MAX_CB
    padded slots, tail zeroed), for HARQ carry into a LATER window at any
    position — retransmissions rarely land in the same window slot."""
    return _soft_extract_fn()(p.softbuffer,
                              jnp.int32(p.pack.row_start[row]),
                              jnp.int32(p.pack.row_ncb[row]))


def make_softbuffer(entries):
    """Per-row softbuffer carry list (None = fresh).  The dense slot
    layout is only known at dispatch time, so this returns the entries
    for `dispatch_window` to place at the new window's slot offsets."""
    return list(entries)


def _assemble_soft(softbuffer, pack: WindowPack, n_slots: int):
    """Resolve the softbuffer argument into a dense (N, 3, D) array."""
    if softbuffer is None:
        return jnp.zeros((n_slots, 3, K_MAX + 4), jnp.float32)
    if isinstance(softbuffer, (list, tuple)):
        soft = jnp.zeros((n_slots + MAX_CB, 3, K_MAX + 4), jnp.float32)
        place = _soft_place_fn()
        for r, blk in enumerate(softbuffer):
            if blk is not None:
                soft = place(soft, blk, jnp.int32(pack.row_start[r]))
        return soft[:n_slots]
    assert softbuffer.shape[0] == n_slots, (
        "dense softbuffer carry requires identical window CB layout; "
        "use make_softbuffer/extract_softbuffer for per-row routing")
    return softbuffer


# --------------------------------------------------------------------------
# facade
# --------------------------------------------------------------------------


class WindowedUeDl:
    """Decode ANY W-TTI mix of port0 PDSCH grants per dispatch.

    Stage A/B compile once; stage C compiles once per occupancy bucket
    (dense slot count / class counts — a handful for the life of the
    object); one packed readback per window.  `decode_window` is the
    synchronous form; `dispatch_window`/`results` pipeline multiple
    windows in flight.
    """

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32,
                 max_iterations: int = 5, scheme: str = "port0",
                 ingest: str = "int8"):
        assert scheme in ("port0", "diversity")
        assert ingest in _INGEST
        self.cell = cell
        self.cfi = cfi
        self.w = w
        self.scheme = scheme
        self.ingest = ingest
        self.nof_ports = 2 if scheme == "diversity" else 1
        self.max_iterations = max_iterations
        self._a = _build_win_a(cell, w, self.nof_ports)
        self._b_cache: dict = {}
        self._ref_dev: dict = {}    # sf_idx -> (4, npil, 2) device
        self._idx_dev: dict = {}    # (sf, prb) -> (RE_MAX,) device
        self._signs_dev: dict = {}  # (rnti, sf) -> (G_MAX,) int8 device
        self.stats = {"windows": 0, "ttis": 0, "crc_ok": 0}

    def _c_for(self, key):
        return _build_win_c(*key, self.max_iterations)

    def _b_for(self, ncls_re: int, qms: tuple = tuple(QMS)):
        # keyed on the RE-class bucket count + the window's Qm set so one
        # compiled executable serves each bucket (the jit itself
        # specializes on idx_cls.shape: the count is a cache key, not a
        # build parameter)
        key = (ncls_re, qms)
        if key not in self._b_cache:
            self._b_cache[key] = _build_win_b(self.w, self.scheme, qms)
        return self._b_cache[key]

    def _re_classes(self, sf_indices, grants):
        """Distinct (sf_idx, PRB-set) classes of the window → (stacked
        device idx table (NCLS, RE_MAX), per-TTI class vector, n_re per
        TTI)."""
        keys: dict = {}
        cls_re = np.zeros(len(grants), np.int32)
        n_re = []
        for i, (s, g) in enumerate(zip(sf_indices, grants)):
            k = (s, tuple(g.prb))
            cls_re[i] = keys.setdefault(k, len(keys))
            n_re.append(self._idx(s, tuple(g.prb))[1])
        ncls = _bucket_of(len(keys), CLS_BUCKETS)

        def rows():
            r = [self._idx(s, prb)[0] for (s, prb) in keys]
            return r + [r[0]] * (ncls - len(r))

        if not hasattr(self, "_stackc"):
            self._stackc = {}
        idx = _stack_cached(self._stackc, ("recls", tuple(keys), ncls),
                            rows)
        return idx, cls_re, n_re

    # -- cached device constants --
    def _ref(self, sf_idx: int):
        if sf_idx not in self._ref_dev:
            refs = []
            for p in range(self.nof_ports):
                ref_conj = _chest_tables(
                    self.cell, sf_idx, ChestDlConfig(), p)[2]
                refs.append(np.stack(
                    [ref_conj.real, ref_conj.imag], -1).astype(np.float32))
            self._ref_dev[sf_idx] = jnp.asarray(np.stack(refs))
        return self._ref_dev[sf_idx]

    def _idx(self, sf_idx: int, prb: tuple):
        key = (sf_idx, prb)
        if key not in self._idx_dev:
            pad, n_re, _bucket = _padded_re_indices(
                self.cell, sf_idx, self.cfi, prb)
            full = np.zeros(RE_MAX, np.int32)
            full[: len(pad)] = pad
            self._idx_dev[key] = (jnp.asarray(full), n_re)
        return self._idx_dev[key]

    def _signs(self, rnti: int, sf_idx: int):
        key = (rnti, sf_idx)
        if key not in self._signs_dev:
            cinit = pdsch_cinit(rnti, sf_idx, self.cell.id, q=0)
            self._signs_dev[key] = jnp.asarray(
                gold_sequence_signs(cinit, G_MAX).astype(np.int8))
        return self._signs_dev[key]

    def _plan(self, samples, sf_indices, grants, softbuffer=None,
              sharding=None, abc=None):
        """Staged (name, fn) chain — see `WindowedEnbUl._plan`.

        ``abc``: optional (grid_ri, ce_ri, noise) device arrays from a
        front-end dispatch over the SAME W TTIs — stage A is skipped and
        the stored grids feed stage B directly (the windowed control
        plane decodes PDCCH from the front-end pass, then dispatches the
        data pass without re-uploading or re-FFTing the window; the
        one-FFT-per-subframe discipline of ue_dl.c:383)."""
        w = self.w
        assert len(sf_indices) == w and len(grants) == w
        if not hasattr(self, "_stackc"):
            self._stackc = {}
        if abc is None:
            samples_q, scale = _quantize_ingest(samples, self.ingest)
            refs = _stack_cached(
                self._stackc, ("refs", tuple(sf_indices)),
                lambda: [self._ref(s) for s in sf_indices])
        idx_cls, cls_re, n_res = self._re_classes(sf_indices, grants)
        sign_key = tuple((g.rnti, s) for s, g in zip(sf_indices, grants))
        signs = _stack_cached(
            self._stackc, ("signs", sign_key),
            lambda: [self._signs(g.rnti, s)
                     for s, g in zip(sf_indices, grants)])

        pack = pack_window([
            (g.tbs, n_res[i] * g.qm, g.qm, getattr(g, "rv", 0))
            for i, g in enumerate(grants)])
        bpar = np.array([[n_res[i], g.qm, cls_re[i]]
                         for i, g in enumerate(grants)], np.int32)
        pdev = jnp.asarray(np.concatenate([bpar.reshape(-1), pack.params]))
        if abc is None:
            scale_d = jnp.asarray(scale)
            samples_q = _upload(samples_q)
            if sharding is not None:
                from jax.sharding import NamedSharding, PartitionSpec

                samples_q = jax.device_put(samples_q, sharding)
                scale_d = jax.device_put(
                    scale_d, NamedSharding(sharding.mesh,
                                           PartitionSpec(sharding.spec[0])))

        bp = pdev[: 3 * w].reshape(w, 3)
        soft = _assemble_soft(softbuffer, pack, pack.key[1])
        j0_tab, perq, invq, tb_tab = class_tables(pack)
        bfn = self._b_for(idx_cls.shape[0],
                          tuple(sorted({g.qm for g in grants})))
        cfn = self._c_for(pack.key)

        stages = [
            ("A", (lambda _prev: abc) if abc is not None
                  else lambda _prev: self._a(samples_q, scale_d, refs)),
            ("B", lambda abc: bfn(
                abc[0], abc[1], abc[2], idx_cls, bp[:, 2], bp[:, 0],
                bp[:, 1], signs)),
            ("C", lambda llr: cfn(
                llr, pdev[3 * w:], j0_tab, perq, invq, tb_tab, soft)),
        ]
        return stages, pack

    def dispatch_window(self, samples, sf_indices, grants,
                        softbuffer=None, sharding=None) -> PendingWindow:
        """samples: (W, nrx, sf_len) complex64; sf_indices/grants: length-W
        lists (grants: DlGrant, port0 single-codeword).  Results stay on
        device until `results`.

        sharding: optional `NamedSharding` partitioning the window axis
        over a device mesh — W (carrier, TTI) slots shard across chips
        exactly like the reference's cc_worker x sf_worker grid."""
        stages, pack = self._plan(samples, sf_indices, grants, softbuffer,
                                  sharding)
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    def dispatch_window_from(self, abc, sf_indices, grants,
                             softbuffer=None) -> PendingWindow:
        """Decode a window of grants from a STORED front-end pass.

        ``abc``: the (grid_ri, ce_ri, noise) device tuple a
        `WindowedUeFrontEnd.dispatch` produced for these W TTIs.  Stage A
        (upload + FFT + chest) is skipped — the data pass shares the
        control pass's grids, so each subframe is FFT'd exactly once
        (ue_dl.c:383) and baseband is uploaded exactly once."""
        stages, pack = self._plan(None, sf_indices, grants, softbuffer,
                                  abc=abc)
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    def stage_times(self, samples, sf_indices, grants, n: int = 40):
        """Per-stage seconds for one window through the SAME plan
        `dispatch_window` runs (the bench must not hand-replicate pipeline
        internals): the mean of n back-to-back calls of each stage, ended
        by `block_until_ready`."""
        import time as _time

        stages, _pack = self._plan(samples, sf_indices, grants)
        times = {}
        prev = None
        for name, fn in stages:
            r = jax.block_until_ready(fn(prev))
            t = _time.perf_counter()
            for _ in range(n):
                r = fn(prev)
            jax.block_until_ready(r)
            times[name] = (_time.perf_counter() - t) / n
            prev = r
        return times

    def results(self, p: PendingWindow):
        """Realize a window: ONE dense readback; returns
        [(tb, ok, n_it)] * W — row r's block at its cumulative offset is
        [tbs/8 tb bytes | ok | n_it].

        n_it is the max turbo-iteration count over the TTI's own
        codeblocks (per-slot counts tracked in `turbo_decode_dyn`)."""
        res = np.asarray(p.packed)
        out = []
        off = 0
        for tbs in p.tbs:
            nb = tbs // 8
            tb = np.unpackbits(res[off:off + nb])
            ok = bool(res[off + nb])
            n_it = int(res[off + nb + 1])
            off += nb + 2
            self.stats["ttis"] += 1
            self.stats["crc_ok"] += int(ok)
            out.append((tb, ok, n_it))
        self.stats["windows"] += 1
        return out

    def decode_window(self, samples, sf_indices, grants, softbuffer=None):
        p = self.dispatch_window(samples, sf_indices, grants, softbuffer)
        return self.results(p), p.softbuffer


# --------------------------------------------------------------------------
# eNB UL (PUSCH) window — mirrors the DL design; shares stage C
# --------------------------------------------------------------------------

M_MAX = 1200  # max PUSCH allocation subcarriers (100 PRB)


def _build_win_a_ul(cell: Cell, w: int):
    """SC-FDMA demod for W subframes (grant independent)."""
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)

    @jax.jit
    def fn(samples_q, scale):
        def one(s_q, sc):
            return _c2ri(ofdm_rx_sf(ofdm, _ri2c(s_q.astype(jnp.float32) * sc)))

        return jax.vmap(one)(samples_q, scale)

    return fn


def _build_win_b_ul(cell: Cell, w: int, qms: tuple = tuple(QMS)):
    """PUSCH grant front-end for W TTIs, every grant quantity data:
    allocation slice (contiguous dynamic-slice), DMRS chest with masked
    smoothing, MRC, **Bluestein IDFT** de-precoding (transform length is
    data — no per-width DFT matrices), 4-constellation demod select over
    the padded (symbol, M_MAX) layout, then ONE class-shared composed
    gather per (m_sc, Qm) class that simultaneously compacts the padded
    layout to transmit order, applies the descramble signs, and channel
    de-interleaves (TS 36.212 §5.2.2.8).

    The composed per-class index tables replace per-row arbitrary
    gathers of G_MAX elements; they are host-built once per (m_sc, Qm)
    and cached device-resident."""
    from .phy.chest.refsignal_ul import dmrs_symbol_in_slot
    from .phy.dft_precoding import idft_bluestein
    from .phy.phch.pusch import pusch_symbols_data

    l_dmrs = dmrs_symbol_in_slot(cell)
    dmrs_syms = (l_dmrs, cell.nsymb_per_slot + l_dmrs)
    data_syms = tuple(pusch_symbols_data(cell))
    nsym = len(data_syms)

    t = np.zeros((cell.nsymb_per_sf, 2), np.float32)
    l0, l1 = dmrs_syms
    for l in range(cell.nsymb_per_sf):
        t[l] = (1.0, 0.0) if l <= l0 else ((0.0, 1.0) if l >= l1 else
                                           (1.0 - (l - l0) / (l1 - l0),
                                            (l - l0) / (l1 - l0)))
    t_data = jnp.asarray(t[list(data_syms)])  # (nsym, 2)

    def one(grid_ri, k0, m_sc, qm, dmrs_conj_ri):
        grid = _ri2c(grid_ri)  # (nrx, nsymb, nre)
        nrx = grid.shape[0]
        gp = jnp.concatenate(
            [grid, jnp.zeros((nrx, grid.shape[1], M_MAX), grid.dtype)], axis=2)
        alloc = jax.lax.dynamic_slice(
            gp, (0, 0, k0), (nrx, grid.shape[1], M_MAX))
        m_mask = (jnp.arange(M_MAX) < m_sc)[None, :]
        pilots = alloc[:, jnp.asarray(dmrs_syms), :]
        ls = pilots * _ri2c(dmrs_conj_ri)[None]
        ls = jnp.where(m_mask[None], ls, 0.0)
        kern = jnp.ones((5,), jnp.float32)
        wsum = jnp.convolve(m_mask[0].astype(jnp.float32), kern, mode="same")
        sm = jax.vmap(jax.vmap(lambda row: (
            jnp.convolve(row.real, kern, mode="same")
            + 1j * jnp.convolve(row.imag, kern, mode="same")
        )))(ls) / jnp.maximum(wsum, 1.0)
        sm = jnp.where(m_mask[None], sm, 0.0)
        resid = jnp.where(m_mask[None], ls - sm, 0.0)
        noise = jnp.sum(jnp.abs(resid) ** 2) / jnp.maximum(
            2.0 * nrx * m_sc.astype(jnp.float32), 1.0)
        ce = jnp.einsum("ls,rsn->rln", t_data.astype(jnp.complex64), sm)
        y = alloc[:, jnp.asarray(data_syms), :]
        num = jnp.sum(y * jnp.conj(ce), axis=0)
        den = jnp.sum(jnp.abs(ce) ** 2, axis=0) + noise
        xf = jnp.where(m_mask, num / den, 0.0)  # (nsym, M_MAX)
        csi = jnp.where(m_mask, den, 0.0)
        x = idft_bluestein(xf, m_sc)  # (nsym, M_MAX)
        csi_t = jnp.sum(csi, axis=-1, keepdims=True) / jnp.maximum(
            m_sc.astype(jnp.float32), 1.0)
        wcsi = jnp.broadcast_to(csi_t, (nsym, M_MAX)).reshape(-1)
        # all four constellations over the padded layout; select by Qm
        llr_pad = jnp.zeros((G_MAX,), jnp.float32)
        xf_flat = x.reshape(-1)
        for mod_c, qm_c in zip(MODS, QMS):
            if qm_c not in qms:
                continue
            lc = demod_soft(mod_c, xf_flat) * jnp.repeat(wcsi, qm_c)
            lc = jnp.zeros((G_MAX,), jnp.float32).at[: nsym * M_MAX * qm_c].set(lc)
            llr_pad = jnp.where(qm == qm_c, lc, llr_pad)
        return llr_pad

    @jax.jit
    def fn(grid_ri, k0, m_sc, qm, dmrs_conj_ri, signs, tab_llr, tab_sig,
           cls_il):
        llr_pad = jax.vmap(one)(grid_ri, k0, m_sc, qm, dmrs_conj_ri)
        lp = jnp.concatenate(
            [llr_pad, jnp.zeros((w, 1), jnp.float32)], axis=1)
        sg = jnp.concatenate(
            [signs.astype(jnp.float32), jnp.zeros((w, 1), jnp.float32)],
            axis=1)
        out = lp[:, tab_llr[0]] * sg[:, tab_sig[0]]
        for c in range(1, tab_llr.shape[0]):
            out = jnp.where((cls_il == c)[:, None],
                            lp[:, tab_llr[c]] * sg[:, tab_sig[c]], out)
        return out

    return fn


@lru_cache(maxsize=256)
def _ul_compose_tabs(m_sc: int, qm: int, nsym: int):
    """Composed class tables for one (m_sc, Qm) class: natural position j
    reads padded-layout LLR tab_llr[j] (dump G_MAX beyond g_len) and
    transmit-order scrambling sign tab_sig[j] — the §5.2.2.8
    de-interleave and the padded→transmit compaction fused into one
    shared-index gather each."""
    g_len = nsym * m_sc * qm
    j = np.arange(G_MAX, dtype=np.int64)
    q = j % qm
    t2 = j // qm
    c2 = t2 % nsym
    r2 = t2 // nsym
    tab_llr = np.where(j < g_len, c2 * (M_MAX * qm) + r2 * qm + q, G_MAX)
    tab_sig = np.where(j < g_len, c2 * (m_sc * qm) + r2 * qm + q, G_MAX)
    return (jnp.asarray(tab_llr.astype(np.int32)),
            jnp.asarray(tab_sig.astype(np.int32)))


@lru_cache(maxsize=128)
def _win_ul_dmrs(cell: Cell, nof_prb: int) -> jnp.ndarray:
    from .phy.chest.refsignal_ul import pusch_dmrs

    r = np.zeros((2, M_MAX), np.complex64)
    for s in range(2):
        r[s, : 12 * nof_prb] = np.conj(np.asarray(pusch_dmrs(cell, nof_prb, 0, s)))
    return jnp.asarray(np.stack([r.real, r.imag], -1).astype(np.float32))


class WindowedEnbUl:
    """Decode ANY W-TTI mix of PUSCH data grants per dispatch — the eNB's
    multi-UE uplink at windowed throughput; shares the DL window's
    dense-slot stage C."""

    def __init__(self, cell: Cell, w: int = 32, max_iterations: int = 5,
                 ingest: str = "int8"):
        assert ingest in _INGEST
        self.cell = cell
        self.w = w
        self.ingest = ingest
        self.max_iterations = max_iterations
        self._a = _build_win_a_ul(cell, w)
        self._b_cache: dict = {}
        self._signs_dev: dict = {}
        from .phy.phch.pusch import pusch_symbols_data

        self._nsym = len(pusch_symbols_data(cell))
        self.stats = {"windows": 0, "ttis": 0, "crc_ok": 0}

    _c_for = WindowedUeDl._c_for

    def _b_for_ul(self, qms: tuple):
        if qms not in self._b_cache:
            self._b_cache[qms] = _build_win_b_ul(self.cell, self.w, qms)
        return self._b_cache[qms]

    def _signs(self, rnti: int, sf_idx: int):
        from .phy.phch.pusch import pusch_cinit

        key = (rnti, sf_idx)
        if key not in self._signs_dev:
            cinit = pusch_cinit(rnti, sf_idx, self.cell.id)
            self._signs_dev[key] = jnp.asarray(
                gold_sequence_signs(cinit, G_MAX).astype(np.int8))
        return self._signs_dev[key]

    def _plan(self, samples, sf_indices, grants, softbuffer=None,
              abc=None):
        """Build the window's staged programs: ordered (name, fn) chain
        where each fn consumes the previous stage's output.  Both
        `dispatch_window` and `stage_times` run THIS plan, so per-stage
        bench timings exercise exactly the production path.

        ``abc``: optional stored (W, nrx, nsymb, nre, 2) SC-FDMA grid
        from an UL front-end pass — stage A is skipped (the windowed
        control plane FFTs each UL subframe once for PUCCH extraction
        AND PUSCH decode, the enb_ul.c:66-86 shared-FFT discipline)."""
        w = self.w
        assert len(sf_indices) == w and len(grants) == w
        if not hasattr(self, "_stackc"):
            self._stackc = {}
        if abc is None:
            samples_q, scale = _quantize_ingest(samples, self.ingest)

        dmrs = _stack_cached(
            self._stackc, ("dmrs", tuple(g.nof_prb for g in grants)),
            lambda: [_win_ul_dmrs(self.cell, g.nof_prb) for g in grants])
        signs = _stack_cached(
            self._stackc,
            ("signs", tuple((g.rnti, s)
                            for s, g in zip(sf_indices, grants))),
            lambda: [self._signs(g.rnti, s)
                     for s, g in zip(sf_indices, grants)])

        # composed de-interleave classes by (m_sc, qm)
        keys: dict = {}
        cls_il = np.zeros(w, np.int32)
        for i, g in enumerate(grants):
            cls_il[i] = keys.setdefault((12 * g.nof_prb, g.qm), len(keys))
        ncls = _bucket_of(len(keys), CLS_BUCKETS)

        def _rows(part):
            def rows():
                r = [_ul_compose_tabs(m, q, self._nsym)[part]
                     for (m, q) in keys]
                return r + [r[0]] * (ncls - len(r))
            return rows

        tab_llr = _stack_cached(self._stackc,
                                ("tabl", tuple(keys), ncls), _rows(0))
        tab_sig = _stack_cached(self._stackc,
                                ("tabs", tuple(keys), ncls), _rows(1))
        cls_il_d = jnp.asarray(cls_il)

        pack = pack_window([
            (g.tbs, self._nsym * 12 * g.nof_prb * g.qm, g.qm, g.rv)
            for g in grants])
        bpar = np.array([[g.prb_start * 12, 12 * g.nof_prb, g.qm]
                         for g in grants], np.int32)
        pdev = jnp.asarray(np.concatenate([bpar.reshape(-1), pack.params]))
        bp = pdev[: 3 * w].reshape(w, 3)
        soft = _assemble_soft(softbuffer, pack, pack.key[1])
        j0_tab, perq, invq, tb_tab = class_tables(pack)
        if abc is None:
            sq, sc = _upload(samples_q), jnp.asarray(scale)
        cfn = self._c_for(pack.key)

        bfn_ul = self._b_for_ul(tuple(sorted({g.qm for g in grants})))
        stages = [
            ("A", (lambda _prev: abc) if abc is not None
                  else lambda _prev: self._a(sq, sc)),
            ("B", lambda grid_ri: bfn_ul(
                grid_ri, bp[:, 0], bp[:, 1], bp[:, 2], dmrs, signs,
                tab_llr, tab_sig, cls_il_d)),
            ("C", lambda llr: cfn(
                llr, pdev[3 * w:], j0_tab, perq, invq, tb_tab, soft)),
        ]
        return stages, pack

    def dispatch_window(self, samples, sf_indices, grants,
                        softbuffer=None) -> PendingWindow:
        """samples: (W, nrx, sf_len) complex64; grants: UlGrant list."""
        stages, pack = self._plan(samples, sf_indices, grants, softbuffer)
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    def dispatch_window_from(self, abc, sf_indices, grants,
                             softbuffer=None) -> PendingWindow:
        """Decode a PUSCH window from a STORED UL front-end grid (see
        `_plan(abc=...)`)."""
        stages, pack = self._plan(None, sf_indices, grants, softbuffer,
                                  abc=abc)
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    results = WindowedUeDl.results
    stage_times = WindowedUeDl.stage_times

    def decode_window(self, samples, sf_indices, grants, softbuffer=None):
        p = self.dispatch_window(samples, sf_indices, grants, softbuffer)
        return self.results(p), p.softbuffer

# --------------------------------------------------------------------------
# 2-codeword (TM3/TM4) DL window — each TTI fills TWO stage-C rows
# --------------------------------------------------------------------------


def _build_win_b_mimo(w: int, qms: tuple = tuple(QMS)):
    """Spatial-multiplexing grant front-end for W TTIs: class-shared RE
    gather → fold the per-TTI precoder into H (the 3 TM4 codebook PMIs
    and TM3 large-delay CDD are cheap elementwise transforms of H,
    one-hot selected by the PMI as data) → ONE joint 2x2 MMSE solve →
    layer demap → per-codeword demod/descramble.  Emits (W, 2, G_MAX)
    masked LLRs.  (Running the full Gram+solve for all 4 precoder
    variants and selecting afterwards is bit-identical but does 4x the
    solves.)"""
    from .phy.mimo import _codebook_2x2, layerdemap, predecode_zf_mmse

    ws = [np.asarray(_codebook_2x2(p, 2)) for p in range(3)]
    u_cdd = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    s2 = np.float32(1.0 / np.sqrt(2.0))

    def one(y, h, noise, n_re, qm1, qm2, pmi, signs1, signs2):
        m = h.shape[-1]
        cands = [jnp.einsum("rpm,pl->rlm", h, jnp.asarray(ws[p]))
                 for p in range(3)]
        # TM3 CDD: fold W·D(i)·U per RE parity (pmi slot 3)
        par = jnp.asarray(
            np.where(np.arange(RE_MAX) % 2 == 0, 1.0, -1.0).astype(
                np.complex64))
        heff_l0 = (h[:, 0, :] * (u_cdd[0, 0] * s2)
                   + h[:, 1, :] * (u_cdd[1, 0] * s2) * par[:m])
        heff_l1 = (h[:, 0, :] * (u_cdd[0, 1] * s2)
                   + h[:, 1, :] * (u_cdd[1, 1] * s2) * par[:m])
        cands.append(jnp.stack([heff_l0, heff_l1], axis=-2))
        heff = jnp.where(pmi == 0, cands[0], jnp.where(pmi == 1, cands[1],
                         jnp.where(pmi == 2, cands[2], cands[3])))
        x, csi = predecode_zf_mmse(y, heff, 2, noise, pmi=None)
        sym_cws = layerdemap(x, 2)
        csi_cws = layerdemap(csi.astype(jnp.complex64), 2)

        def demod_cw(sym, csi_c, qm, signs):
            llr = jnp.zeros((G_MAX,), jnp.float32)
            wcsi = jnp.real(csi_c)
            for mod_c, qm_c in zip(MODS, QMS):
                if qm_c not in qms:
                    continue
                lc = demod_soft(mod_c, sym) * jnp.repeat(wcsi, qm_c)
                lc = jnp.zeros((G_MAX,), jnp.float32).at[: RE_MAX * qm_c].set(lc)
                llr = jnp.where(qm == qm_c, lc, llr)
            llr = llr * signs.astype(jnp.float32)
            mask = jnp.arange(G_MAX) < n_re * qm
            return jnp.where(mask, llr, 0.0)

        return jnp.stack([
            demod_cw(sym_cws[0], csi_cws[0], qm1, signs1),
            demod_cw(sym_cws[1], csi_cws[1], qm2, signs2),
        ])

    @jax.jit
    def fn(grid_ri, ce_ri, noise, idx_cls, cls_re, n_re, qm1, qm2, pmi,
           signs1, signs2):
        y, h = _gather_re_classes(grid_ri, ce_ri, idx_cls, cls_re)
        return jax.vmap(one)(y, h, noise, n_re, qm1, qm2, pmi,
                             signs1, signs2)

    return fn


class WindowedUeDlMimo(WindowedUeDl):
    """2-codeword spatial-multiplexing windows (TM4 codebook PMIs 0-2 as
    data, TM3 CDD as pmi=3): W TTIs of DlGrant2 per dispatch — each TTI
    occupies TWO rows of the shared dense stage C.  The reference's
    150 Mbps headline config (README.md:47) on the windowed dynamic
    path."""

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32,
                 max_iterations: int = 5, ingest: str = "int8"):
        assert ingest in _INGEST
        self.cell = cell
        self.cfi = cfi
        self.w = w
        self.scheme = "spatialmux"
        self.ingest = ingest
        self.nof_ports = 2
        self.max_iterations = max_iterations
        self._a = _build_win_a(cell, w, 2)
        self._b_cache = {}
        self._ref_dev = {}
        self._idx_dev = {}
        self._signs_dev = {}
        self.stats = {"windows": 0, "ttis": 0, "crc_ok": 0}

    def _b_for(self, ncls_re: int, qms: tuple = tuple(QMS)):
        key = (ncls_re, qms)
        if key not in self._b_cache:
            self._b_cache[key] = _build_win_b_mimo(self.w, qms)
        return self._b_cache[key]

    def _signs_q(self, rnti: int, sf_idx: int, q: int):
        key = (rnti, sf_idx, q)
        if key not in self._signs_dev:
            cinit = pdsch_cinit(rnti, sf_idx, self.cell.id, q=q)
            self._signs_dev[key] = jnp.asarray(
                gold_sequence_signs(cinit, G_MAX).astype(np.int8))
        return self._signs_dev[key]

    def _plan(self, samples, sf_indices, grants, softbuffer=None,
              sharding=None):
        """Staged (name, fn) chain — see `WindowedEnbUl._plan`."""
        w = self.w
        assert len(sf_indices) == w and len(grants) == w
        samples_q, scale = _quantize_ingest(samples, self.ingest)

        refs = _stacker(w)(*[self._ref(s) for s in sf_indices])
        idx_cls, cls_re, n_res = self._re_classes(sf_indices, grants)
        signs1 = _stacker(w)(*[self._signs_q(g.rnti, s, 0)
                               for s, g in zip(sf_indices, grants)])
        signs2 = _stacker(w)(*[self._signs_q(g.rnti, s, 1)
                               for s, g in zip(sf_indices, grants)])

        row_specs = []
        bpar = np.zeros((w, 5), np.int32)  # n_re, qm1, qm2, pmi, cls_re
        for i, g in enumerate(grants):
            n_re = n_res[i]
            pmi = 3 if g.tx_scheme == "cdd" else g.pmi
            bpar[i] = (n_re, g.qm1, g.qm2, pmi, cls_re[i])
            row_specs.append((g.tbs1, n_re * g.qm1, g.qm1, g.rv1))
            row_specs.append((g.tbs2, n_re * g.qm2, g.qm2, g.rv2))
        pack = pack_window(row_specs)
        pdev = jnp.asarray(np.concatenate([bpar.reshape(-1), pack.params]))
        sq, sc = _upload(samples_q), jnp.asarray(scale)
        bp = pdev[: 5 * w].reshape(w, 5)
        soft = _assemble_soft(softbuffer, pack, pack.key[1])
        j0_tab, perq, invq, tb_tab = class_tables(pack)
        bfn = self._b_for(idx_cls.shape[0], tuple(sorted(
            {g.qm1 for g in grants} | {g.qm2 for g in grants})))
        cfn = self._c_for(pack.key)

        stages = [
            ("A", lambda _prev: self._a(sq, sc, refs)),
            ("B", lambda abc: bfn(
                abc[0], abc[1], abc[2], idx_cls, bp[:, 4], bp[:, 0],
                bp[:, 1], bp[:, 2], bp[:, 3], signs1,
                signs2).reshape(2 * w, G_MAX)),
            ("C", lambda llr: cfn(
                llr, pdev[5 * w:], j0_tab, perq, invq, tb_tab, soft)),
        ]
        return stages, pack

    def dispatch_window(self, samples, sf_indices, grants,
                        softbuffer=None) -> PendingWindow:
        """samples: (W, nrx, sf_len) complex64; grants: DlGrant2 list
        (tx_scheme spatialmux -> pmi 0-2, cdd -> pmi slot 3)."""
        stages, pack = self._plan(samples, sf_indices, grants, softbuffer)
        out = None
        for _name, fn in stages:
            out = fn(out)
        packed, new_soft = out
        return PendingWindow(packed, new_soft, pack.tbs, pack)

    def results(self, p: PendingWindow):
        """[( (tb1, ok1), (tb2, ok2), n_it )] * W.

        stats count one TTI per codeword PAIR; crc_ok counts pairs with
        both codewords good."""
        res = np.asarray(p.packed)
        out = []
        rows = []
        off = 0
        for tbs in p.tbs:
            nb = tbs // 8
            rows.append((np.unpackbits(res[off:off + nb]),
                         bool(res[off + nb]), int(res[off + nb + 1])))
            off += nb + 2
        for i in range(0, len(rows), 2):
            (t1, ok1, n1), (t2, ok2, n2) = rows[i], rows[i + 1]
            self.stats["ttis"] += 1
            self.stats["crc_ok"] += int(ok1 and ok2)
            out.append(((t1, ok1), (t2, ok2), max(n1, n2)))
        self.stats["windows"] += 1
        return out


# --------------------------------------------------------------------------
# eNB DL GENERATION window — the sf_worker TX half (enb_dl.c + sch.c
# encode_tb) as fixed window programs: payload bytes in, baseband out
# --------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _expand_payload_fn(tb_cap: int, flat_cap: int):
    """Dense payload ingest: ONE flat (flat_cap,) uint8 upload carrying
    exactly each row's own TB bytes; the device expands it to the
    (R, tb_cap) right-aligned layout the TX core consumes (batched
    contiguous slices — the padded 2-D form uploaded the window's
    largest-TB width for every row, 2-3x the bytes on the ~45 MB/s
    host link)."""

    @jax.jit
    def fn(flat, nb, off):
        src = jnp.concatenate([jnp.zeros((tb_cap,), jnp.uint8), flat])

        def one(o, n):
            seg = jax.lax.dynamic_slice(src, (o + n,), (tb_cap,))
            return jnp.where(jnp.arange(tb_cap) < tb_cap - n, 0, seg)

        return jax.vmap(one)(off, nb)

    return fn


def _upload_payload_dense(payloads, tbs_list, tb_cap: int):
    """payloads: per-row bit arrays; returns the (R, tb_cap) device
    layout via the dense flat upload."""
    nb = np.array([t // 8 for t in tbs_list], np.int32)
    off = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int32)
    flat_cap = _pow2_bucket(int(nb.sum()))
    flat = np.zeros(flat_cap, np.uint8)
    for o, n, tb in zip(off, nb, payloads):
        flat[o:o + n] = np.packbits(np.asarray(tb, np.uint8))
    # (the jit itself specializes on the (R,) nb/off shapes, so tb_cap
    # and flat_cap are the only build parameters)
    return _expand_payload_fn(tb_cap, flat_cap)(
        _upload(flat), jnp.asarray(nb), jnp.asarray(off))


@lru_cache(maxsize=64)
def _tx_table_dev(k: int, f: int, rv: int, e_cap: int) -> jnp.ndarray:
    """TX rate-match gather table of one layout class, pre-tiled to the
    window's e_cap so repetition wraps HOST-side and the device gather
    keeps class-shared indices."""
    from .phy.fec.rate_match_dev import tx_table_np

    tx, nv = tx_table_np(k, f, rv, K_MAX)
    return jnp.asarray(tx[np.arange(e_cap) % nv])


def tx_class_tables(pack: WindowPack, e_cap: int):
    """(tx_tab (CF, e_cap), perq (CQ, K_MAX)) from cached class tables."""
    cq, cf = pack.key[2], pack.key[3]
    f_rows = [_tx_table_dev(*c, e_cap) for c in pack.fill_classes]
    f_rows += [f_rows[0]] * (cf - len(f_rows))
    p_rows = [_qpp_table_dev(k)[0] for k in pack.qpp_classes]
    p_rows += [p_rows[0]] * (cq - len(p_rows))
    return _stacker(cf)(*f_rows), _stacker(cq)(*p_rows)


def _make_codeword_core(n_rows: int, n_slots: int, ncls_f: int,
                        e_cap: int, tb_cap: int):
    """Shared TX chain: payload bytes → TB CRC24A → segmentation
    (+CRC24B, filler) → dynamic-K closed-form turbo encode → class-shared
    TX rate-match gathers → in-order row codeword assembly.  Used by the
    DL (PDSCH) and UL (PUSCH) generation windows."""
    from .phy.common import LTE_CRC24A, LTE_CRC24B
    from .phy.crc import crc_matrix_np
    from .phy.fec.turbo import turbo_encode_device_dyn

    N, CF, R = n_slots, ncls_f, n_rows
    D = K_MAX + 4
    tbl_a = jnp.asarray(
        crc_matrix_np(LTE_CRC24A, tb_cap * 8).astype(np.float32))
    tbl_b = jnp.asarray(
        crc_matrix_np(LTE_CRC24B, K_MAX).astype(np.float32))

    def core(payload, params, tx_tab, perq):
        s_off = params[0:N]            # flat row*G_MAX + codeword offset
        s_e = params[N:2 * N]
        s_k = params[2 * N:3 * N]
        s_f = params[3 * N:4 * N]
        s_crcb = params[4 * N:5 * N]
        s_clsf = params[5 * N:6 * N]
        s_clsq = params[6 * N:7 * N]
        o = 8 * N
        row_ncb = params[o + R:o + 2 * R]
        row_start = params[o + 2 * R:o + 3 * R]
        s_src = params[o + 4 * R:o + 4 * R + N]  # after cls_tb

        # TB CRC24A over right-aligned payload bits (leading-zeros
        # invariance makes the fixed-width matrix exact for every tbs)
        bits_tb = jnp.unpackbits(payload, axis=1)          # (R, tb_cap*8)
        crc_a = (jnp.matmul(bits_tb.astype(jnp.float32), tbl_a,
                            preferred_element_type=jnp.float32
                            ).astype(jnp.int32) & 1).astype(jnp.uint8)
        rb_flat = jnp.concatenate(
            [jnp.zeros((R, K_MAX), jnp.uint8),
             jnp.concatenate([bits_tb, crc_a], axis=1)],
            axis=1).reshape(-1)

        # per-slot right-aligned CB data (contiguous slices) + CRC24B;
        # filler zeros live in the masked prefix
        take = s_k - s_f - 24 * s_crcb
        ra = jax.vmap(lambda src: jax.lax.dynamic_slice(
            rb_flat, (src,), (K_MAX,)))(s_src)             # (N, K_MAX)
        pos_k = jnp.arange(K_MAX)[None, :]
        ra = jnp.where(pos_k >= K_MAX - take[:, None], ra, 0)
        crc_b = (jnp.matmul(ra.astype(jnp.float32), tbl_b,
                            preferred_element_type=jnp.float32
                            ).astype(jnp.int32) & 1).astype(jnp.uint8)
        crc_b = jnp.where(s_crcb[:, None] > 0, crc_b, 0)
        rak = jnp.concatenate(
            [ra, crc_b, jnp.zeros((N, K_MAX), jnp.uint8)], axis=1)
        cb = jax.vmap(lambda row, k, crcb: jax.lax.dynamic_slice(
            row, (K_MAX + 24 * crcb - k,), (K_MAX,)))(rak, s_k, s_crcb)

        # dynamic-K closed-form turbo encode
        d = turbo_encode_device_dyn(cb, s_k, (perq, s_clsq))
        d_flat = d.reshape(N, 3 * D)

        # class-shared TX rate match
        piece = d_flat[:, tx_tab[0]]
        for c in range(1, CF):
            piece = jnp.where((s_clsf == c)[:, None],
                              d_flat[:, tx_tab[c]], piece)
        piece = jnp.where(jnp.arange(e_cap)[None, :] < s_e[:, None],
                          piece, 0)

        # assemble row codewords: ascending in-order writes (each
        # piece's zero tail is overwritten by the next CB's write)
        def asm_row(r):
            row_cw = jnp.zeros((G_MAX + e_cap,), jnp.uint8)
            base = row_start[r]
            for c in range(MAX_CB):
                sl = jnp.clip(base + c, 0, N - 1)
                use = c < row_ncb[r]
                off = jnp.where(use, s_off[sl] - r * G_MAX, G_MAX)
                row_cw = jax.lax.dynamic_update_slice(
                    row_cw, piece[sl], (off,))
            return row_cw[:G_MAX]

        return jax.vmap(asm_row)(jnp.arange(R))

    return core


@lru_cache(maxsize=32)
def _build_win_tx(cell: Cell, n_rows: int, n_slots: int, ncls_q: int,
                  ncls_f: int, e_cap: int, tb_cap: int, ncls_re: int,
                  n_ov: int = 0):
    """Windowed DL data-subframe ENCODER: payload bytes → TB CRC24A →
    segmentation (+CRC24B, filler) → dynamic-K closed-form turbo encode →
    class-shared TX rate-match gathers → in-order codeword assembly →
    scramble → 4-constellation modulate (one-hot by Qm) → inverse-RE
    class tables over the CRS template → batched IFFT.

    The TX mirror of the decode stage C: same dense slots, same cached
    class-table discipline (j0's inverse), same one-packed-upload
    contract.  Scope mirrors the decode windows: PDSCH data region + CRS
    (sync/PBCH/control render via `phy/enb/enb_dl.py`)."""
    from .phy.modem import modulate

    R = n_rows
    core = _make_codeword_core(n_rows, n_slots, ncls_f, e_cap, tb_cap)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    @jax.jit
    def fn(payload, params, tx_tab, perq, inv_re, cls_re, qm_r, n_re_r,
           seqs, tmpl_ri, *ov_args):
        cw = core(payload, params, tx_tab, perq)

        # --- scramble + modulate (one-hot by Qm) ---
        cwm = cw ^ seqs
        sym = jnp.zeros((R, RE_MAX), jnp.complex64)
        for mod_c, qm_c in zip(MODS, QMS):
            sy = modulate(mod_c, cwm[:, : RE_MAX * qm_c])
            sym = jnp.where((qm_r == qm_c)[:, None], sy, sym)
        mask_re = jnp.arange(RE_MAX)[None, :] < n_re_r[:, None]
        sym = jnp.where(mask_re, sym, 0.0)
        sym_pad = jnp.concatenate(
            [sym, jnp.zeros((R, 1), jnp.complex64)], axis=1)

        # --- grid via class-shared inverse RE tables over the template --
        tmpl = _ri2c(tmpl_ri)                              # (R, S)
        def overlay(c):
            return jnp.where(inv_re[c][None, :] < RE_MAX,
                             sym_pad[:, jnp.clip(inv_re[c], 0, RE_MAX)],
                             tmpl)
        g = overlay(0)
        for c in range(1, ncls_re):
            g = jnp.where((cls_re == c)[:, None], overlay(c), g)
        if n_ov:
            # per-TTI control/PBCH overlay (host-rendered PCFICH + PHICH
            # + PDCCH + PBCH RE values scattered into the grid — the
            # enb_dl.c control half batched onto the device; pad indices
            # point past the grid and drop)
            ov_idx, ov_ri = ov_args[0], ov_args[1]
            g = jax.vmap(lambda gr, ir, vr: gr.at[ir].set(
                _ri2c(vr), mode="drop"))(g, ov_idx, ov_ri)
        grid = g.reshape(R, cell.nsymb_per_sf, cell.nof_re_per_symbol)

        samples = jax.vmap(lambda gr: ofdm_tx_sf(ofdm, gr[None]))(grid)
        return _c2ri(samples[:, 0])

    return fn


class WindowedEnbDl:
    """Generate ANY W-TTI mix of port0 PDSCH data subframes per dispatch
    — the eNB sf_worker TX half at window throughput (payload bytes in,
    baseband out); the generation mirror of `WindowedUeDl`."""

    def __init__(self, cell: Cell, cfi: int = 1, w: int = 32,
                 template: str = "crs"):
        assert template in ("crs", "full")
        self.cell = cell
        self.cfi = cfi
        self.w = w
        self.template = template  # "full" bakes PSS/SSS in (enb_dl.c sync)
        self._idx_cache: dict = {}
        self._inv_dev: dict = {}    # (sf, prb) -> (S,) int32 inverse
        self._seq_dev: dict = {}    # (rnti, sf) -> (G_MAX,) uint8 bits
        self._tmpl_dev: dict = {}   # sf -> (S, 2) f32 CRS template
        self.stats = {"windows": 0, "ttis": 0}

    def _idx(self, sf_idx: int, prb: tuple):
        key = (sf_idx, prb)
        if key not in self._idx_cache:
            pad, n_re, _b = _padded_re_indices(
                self.cell, sf_idx, self.cfi, prb)
            self._idx_cache[key] = (pad, n_re)
        return self._idx_cache[key]

    def _inv(self, sf_idx: int, prb: tuple):
        key = (sf_idx, prb)
        if key not in self._inv_dev:
            pad, n_re = self._idx(sf_idx, prb)
            S = self.cell.nsymb_per_sf * self.cell.nof_re_per_symbol
            inv = np.full(S, RE_MAX, np.int32)
            inv[pad[:n_re]] = np.arange(n_re, dtype=np.int32)
            self._inv_dev[key] = jnp.asarray(inv)
        return self._inv_dev[key], self._idx(sf_idx, prb)[1]

    def _seq(self, rnti: int, sf_idx: int):
        from .phy.sequence import gold_sequence

        key = (rnti, sf_idx)
        if key not in self._seq_dev:
            cinit = pdsch_cinit(rnti, sf_idx, self.cell.id, q=0)
            self._seq_dev[key] = jnp.asarray(np.asarray(
                gold_sequence(cinit, G_MAX)).astype(np.uint8))
        return self._seq_dev[key]

    def _tmpl(self, sf_idx: int):
        if sf_idx not in self._tmpl_dev:
            from .phy.chest.refsignal_dl import put_crs_np

            t = np.zeros((1, self.cell.nsymb_per_sf,
                          self.cell.nof_re_per_symbol), np.complex64)
            put_crs_np(t, self.cell, sf_idx)
            if self.template == "full" and sf_idx in (0, 5):
                from .phy.sync.pss import put_pss_grid
                from .phy.sync.sss import put_sss_grid

                c = self.cell
                put_pss_grid(t[0], c.n_id_2, c.nof_prb,
                             c.nsymb_per_slot - 1)
                put_sss_grid(t[0], c.n_id_1, c.n_id_2, sf_idx, c.nof_prb,
                             c.nsymb_per_slot - 2)
            flat = t[0].reshape(-1)
            self._tmpl_dev[sf_idx] = jnp.asarray(
                np.stack([flat.real, flat.imag], -1).astype(np.float32))
        return self._tmpl_dev[sf_idx]

    def dispatch_window(self, payloads, sf_indices, grants, overlay=None):
        """payloads: per TTI the TB bits ((tbs,) uint8 arrays);
        grants: DlGrant list.  Returns a device (W, sf_len, 2) float32
        RI sample array (realize with `samples`).

        overlay: optional (idx (W, n_ov) int32, vals (W, n_ov) complex)
        host-rendered control-region REs (PCFICH/PHICH/PDCCH/PBCH)
        scattered over the template before the IFFT — out-of-range pad
        indices drop.  This is how the windowed control plane renders
        the full enb_dl.c subframe in one device program."""
        w = self.w
        assert len(payloads) == w == len(sf_indices) == len(grants)
        n_res = [self._idx(s, tuple(g.prb))[1] for s, g in
                 zip(sf_indices, grants)]
        pack = pack_window([
            (g.tbs, n_res[i] * g.qm, g.qm, getattr(g, "rv", 0))
            for i, g in enumerate(grants)])
        (_r, n_slots, cq, cf, e_cap, _jf, tb_cap, _ct) = pack.key[:8]

        # right-aligned payload bytes (tbs divisible by 8 in LTE) via
        # the dense flat upload
        for tb, g in zip(payloads, grants):
            assert len(tb) == g.tbs
        pay = _upload_payload_dense(payloads, [g.tbs for g in grants],
                                    tb_cap)

        # per-slot source offsets into the front-padded row bit streams
        BW = tb_cap * 8 + 24
        s_src = np.zeros(n_slots, np.int32)
        for r, g in enumerate(grants):
            segm = cbsegm(g.tbs)
            startb = 0
            for c, k in enumerate(segm.cb_sizes):
                f = segm.F if c == 0 else 0
                take = k - f - (24 if segm.C > 1 else 0)
                slot = pack.row_start[r] + c
                # slice START: the K_MAX window ENDS at this slot's last
                # data bit (the front K_MAX zero-pad keeps it >= 0)
                s_src[slot] = (r * (K_MAX + BW) + K_MAX
                               + (BW - (g.tbs + 24)) + startb + take
                               - K_MAX)
                startb += take

        # RE classes + per-row params
        keys: dict = {}
        cls_re = np.zeros(w, np.int32)
        for i, (s, g) in enumerate(zip(sf_indices, grants)):
            cls_re[i] = keys.setdefault((s, tuple(g.prb)), len(keys))
        ncls_re = _bucket_of(len(keys), CLS_BUCKETS)
        if not hasattr(self, "_stackc"):
            self._stackc = {}

        def inv_rows():
            r = [self._inv(s, prb)[0] for (s, prb) in keys]
            return r + [r[0]] * (ncls_re - len(r))

        inv_re = _stack_cached(self._stackc,
                               ("inv", tuple(keys), ncls_re), inv_rows)
        seqs = _stack_cached(
            self._stackc,
            ("seq", tuple((g.rnti, s)
                          for s, g in zip(sf_indices, grants))),
            lambda: [self._seq(g.rnti, s)
                     for s, g in zip(sf_indices, grants)])
        tmpl = _stack_cached(self._stackc, ("tmpl", tuple(sf_indices)),
                             lambda: [self._tmpl(s) for s in sf_indices])

        params = jnp.asarray(np.concatenate([pack.params, s_src]))
        qm_r = jnp.asarray(np.array([g.qm for g in grants], np.int32))
        n_re_r = jnp.asarray(np.array(n_res, np.int32))
        tx_tab, perq = tx_class_tables(pack, e_cap)
        ov_args = ()
        n_ov = 0
        if overlay is not None:
            ov_idx, ov_vals = overlay
            n_ov = ov_idx.shape[1]
            ov_ri = np.stack([ov_vals.real, ov_vals.imag],
                             -1).astype(np.float32)
            ov_args = (_upload(ov_idx.astype(np.int32)), _upload(ov_ri))
        fn = _build_win_tx(self.cell, w, n_slots, cq, cf, e_cap, tb_cap,
                           ncls_re, n_ov)
        out = fn(pay, params, tx_tab, perq, inv_re,
                 jnp.asarray(cls_re), qm_r, n_re_r, seqs, tmpl, *ov_args)
        self.stats["windows"] += 1
        self.stats["ttis"] += w
        return out

    @staticmethod
    def samples(out) -> np.ndarray:
        """Realize a dispatched window: (W, sf_len) complex64."""
        ri = np.asarray(out)
        return (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)


# --------------------------------------------------------------------------
# device-resident window loopback — the serving topology: a generation
# window feeds a decode window through an on-chip channel, so baseband
# never crosses the host link (only payload bits do, ~8x less traffic
# than samples on the ingest link; cf. the reference's ZMQ loopback
# between srsenb and srsue processes, rf_zmq_imp.c)
# --------------------------------------------------------------------------


@lru_cache(maxsize=8)
def _win_channel_fn():
    @jax.jit
    def fn(tx_ri, h_ri, seed, amp):
        tx = _ri2c(tx_ri)                      # (W, ntx, L)
        h = _ri2c(h_ri)                        # (nrx, ntx)
        rx = jnp.einsum("rp,wpl->wrl", h, tx)
        nz = jax.random.normal(jax.random.PRNGKey(seed),
                               rx.shape + (2,), jnp.float32)
        return _c2ri(rx) + amp * nz            # (W, nrx, L, 2)

    return fn


def window_channel(tx, h, noise_amp: float, seed: int = 0):
    """Flat-fading channel + AWGN between windows, entirely on device.

    tx: device (W, sf_len, 2) or (W, P, sf_len, 2) float32 RI (a
    generation window's output); h: (nrx, ntx) complex ndarray.
    Returns a device (W, nrx, sf_len, 2) float32 RI array that the
    decode windows ingest directly (`_quantize_ingest` device path)."""
    if tx.ndim == 3:
        tx = tx[:, None]
    nrx, ntx = h.shape
    assert ntx == tx.shape[1]
    h_ri = jnp.asarray(
        np.stack([np.asarray(h).real, np.asarray(h).imag], -1)
        .astype(np.float32))
    return _win_channel_fn()(
        tx, h_ri, jnp.uint32(seed), jnp.float32(noise_amp))


# --------------------------------------------------------------------------
# UE UL (PUSCH) GENERATION window — the UE transmit half; completes the
# four windowed directions (UE-DL rx, eNB-UL rx, eNB-DL tx, UE-UL tx)
# --------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _ul_interleave_tab_dev(m_sc: int, qm: int, nsym: int) -> jnp.ndarray:
    """Transmit-order source index (G_MAX,): out_t[i] = cw[tab[i]] — the
    TS 36.212 §5.2.2.8 time-first channel interleaver, per (m_sc, Qm)
    class (the forward of the stage-B UL de-interleave)."""
    g_len = nsym * m_sc * qm
    i = np.arange(G_MAX, dtype=np.int64)
    cc = i // max(m_sc * qm, 1)
    u = i - cc * (m_sc * qm)
    r = u // max(qm, 1)
    q = u - r * qm
    j = (r * nsym + cc) * qm + q
    return jnp.asarray(np.where(i < g_len, j, G_MAX).astype(np.int32))


@lru_cache(maxsize=256)
def _ul_pad_tab_dev(m_sc: int, qm: int, nsym: int) -> jnp.ndarray:
    """Padded-layout source index, FIXED width nsym*M_MAX*8 so classes of
    different Qm stack: padded bit position (symbol c, subcarrier
    r < M_MAX, bit q) reads transmit-order bit c*(m_sc*qm) + r*qm + q
    when r < m_sc; positions beyond the class's own nsym*M_MAX*qm (or
    beyond the allocation) read the dump."""
    width = nsym * M_MAX * 8
    pp = np.arange(width, dtype=np.int64)
    cc = pp // (M_MAX * qm)
    u = pp - cc * (M_MAX * qm)
    t = cc * (m_sc * qm) + u
    ok = (u < m_sc * qm) & (pp < nsym * M_MAX * qm)
    return jnp.asarray(np.where(ok, t, G_MAX).astype(np.int32))


@lru_cache(maxsize=128)
def _win_ul_dmrs_tx(cell: Cell, nof_prb: int) -> jnp.ndarray:
    from .phy.chest.refsignal_ul import pusch_dmrs

    r = np.zeros((2, M_MAX), np.complex64)
    for sl in range(2):
        r[sl, : 12 * nof_prb] = np.asarray(pusch_dmrs(cell, nof_prb, 0, sl))
    return jnp.asarray(np.stack([r.real, r.imag], -1).astype(np.float32))


@lru_cache(maxsize=32)
def _build_win_ul_tx(cell: Cell, n_rows: int, n_slots: int, ncls_q: int,
                     ncls_f: int, e_cap: int, tb_cap: int, ncls_il: int):
    """Windowed PUSCH ENCODER: the shared codeword core, then the UL
    chain — class-shared channel interleave → scramble → padded-layout
    expand → one-hot modulate → Bluestein DFT precode (allocation width
    as data) → DMRS + allocation placement (contiguous slices) → SC-FDMA
    IFFT with the +0.5 subcarrier shift (`ue_ul.c` / sch.c:1182 roles)."""
    from .phy.dft_precoding import dft_bluestein
    from .phy.modem import modulate
    from .phy.phch.pusch import pusch_symbols_data
    from .phy.chest.refsignal_ul import dmrs_symbol_in_slot

    R = n_rows
    core = _make_codeword_core(n_rows, n_slots, ncls_f, e_cap, tb_cap)
    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=0.5)
    data_syms = tuple(pusch_symbols_data(cell))
    nsym = len(data_syms)
    l_dmrs = dmrs_symbol_in_slot(cell)
    dmrs_syms = (l_dmrs, cell.nsymb_per_slot + l_dmrs)
    nre = cell.nof_re_per_symbol

    @jax.jit
    def fn(payload, params, tx_tab, perq, il_tab, pad_tab, cls_il,
           qm_r, msc_r, k0_r, seqs, dmrs_ri, *pucch_args):
        cw = core(payload, params, tx_tab, perq)

        # channel interleave (class-shared) + scramble in transmit order
        cwp = jnp.concatenate(
            [cw, jnp.zeros((R, 1), jnp.uint8)], axis=1)
        cw_t = cwp[:, il_tab[0]]
        for c in range(1, ncls_il):
            cw_t = jnp.where((cls_il == c)[:, None],
                             cwp[:, il_tab[c]], cw_t)
        cw_t = cw_t ^ seqs

        # padded (symbol, M_MAX) layout expand (class-shared)
        ctp = jnp.concatenate(
            [cw_t, jnp.zeros((R, 1), jnp.uint8)], axis=1)
        pb = ctp[:, pad_tab[0]]
        for c in range(1, ncls_il):
            pb = jnp.where((cls_il == c)[:, None], ctp[:, pad_tab[c]], pb)

        # one-hot modulate over the padded layout
        sym = jnp.zeros((R, nsym * M_MAX), jnp.complex64)
        for mod_c, qm_c in zip(MODS, QMS):
            sy = modulate(mod_c, pb[:, : nsym * M_MAX * qm_c])
            sym = jnp.where((qm_r == qm_c)[:, None], sy, sym)
        sym = sym.reshape(R, nsym, M_MAX)
        r_pos = jnp.arange(M_MAX)[None, None, :]
        sym = jnp.where(r_pos < msc_r[:, None, None], sym, 0.0)

        # Bluestein DFT precoding at the per-row allocation width
        xf = jax.vmap(lambda x, m: dft_bluestein(x, m))(sym, msc_r)

        # build the allocation block (nsymb, M_MAX): data symbols + DMRS
        def one(xf_r, dmrs_r, msc, k0):
            blk = jnp.zeros((cell.nsymb_per_sf, M_MAX), jnp.complex64)
            for i, l in enumerate(data_syms):
                blk = blk.at[l].set(xf_r[i])
            dm = _ri2c(dmrs_r)
            dm = jnp.where(jnp.arange(M_MAX)[None, :] < msc, dm, 0.0)
            blk = blk.at[dmrs_syms[0]].set(dm[0])
            blk = blk.at[dmrs_syms[1]].set(dm[1])
            grid = jnp.zeros((cell.nsymb_per_sf, nre + M_MAX),
                             jnp.complex64)
            grid = jax.lax.dynamic_update_slice(grid, blk, (0, k0))
            return grid[:, :nre]

        grid = jax.vmap(one)(xf, dmrs_ri, msc_r, k0_r)
        if pucch_args:
            # PUCCH rides the SAME subframe (simultaneousPUCCH-PUSCH):
            # per-row band-edge PRB-local grids added before the IFFT,
            # PUSCH rows masked by `live` (pad rows transmit nothing)
            pprb, pgrid_ri, live = pucch_args
            grid = grid * live[:, None, None]
            nss = cell.nsymb_per_slot

            def add_p(gr, pp, pg_ri):
                pg = _ri2c(pg_ri)            # (nsymb, 12)
                for slot in range(2):
                    sl = pg[slot * nss: (slot + 1) * nss]
                    blk = jax.lax.dynamic_slice(
                        gr, (slot * nss, pp[slot] * 12), (nss, 12)) + sl
                    gr = jax.lax.dynamic_update_slice(
                        gr, blk, (slot * nss, pp[slot] * 12))
                return gr

            grid = jax.vmap(add_p)(grid, pprb, pgrid_ri)
        samples = jax.vmap(lambda gr: ofdm_tx_sf(ofdm, gr[None]))(grid)
        return _c2ri(samples[:, 0])

    return fn


class WindowedUeUl:
    """Generate ANY W-TTI mix of PUSCH data grants per dispatch — the
    UE's transmit half at window throughput (the generation mirror of
    `WindowedEnbUl`, which decodes these subframes)."""

    def __init__(self, cell: Cell, w: int = 32):
        self.cell = cell
        self.w = w
        from .phy.phch.pusch import pusch_symbols_data

        self._nsym = len(pusch_symbols_data(cell))
        self._seq_dev: dict = {}
        self.stats = {"windows": 0, "ttis": 0}

    def _seq(self, rnti: int, sf_idx: int):
        from .phy.phch.pusch import pusch_cinit
        from .phy.sequence import gold_sequence

        key = (rnti, sf_idx)
        if key not in self._seq_dev:
            cinit = pusch_cinit(rnti, sf_idx, self.cell.id)
            self._seq_dev[key] = jnp.asarray(np.asarray(
                gold_sequence(cinit, G_MAX)).astype(np.uint8))
        return self._seq_dev[key]

    def dispatch_window(self, payloads, sf_indices, grants, pucch=None):
        """payloads: per TTI the TB bits; grants: UlGrant list.  Returns
        a device (W, sf_len, 2) float32 RI array (realize with
        `WindowedEnbDl.samples`).

        pucch: optional (prb (W, 2) int32 per-slot PRB, grids
        (W, nsymb, 12) complex PRB-local, live (W,) bool PUSCH mask) —
        simultaneous PUCCH+PUSCH subframes rendered in the same program
        (pad rows with live=False transmit only their PUCCH part)."""
        w = self.w
        assert len(payloads) == w == len(sf_indices) == len(grants)
        nsym = self._nsym
        pack = pack_window([
            (g.tbs, nsym * 12 * g.nof_prb * g.qm, g.qm, g.rv)
            for g in grants])
        (_r, n_slots, cq, cf, e_cap, _jf, tb_cap, _ct) = pack.key[:8]

        # right-aligned payload bytes (tbs divisible by 8 in LTE) via
        # the dense flat upload
        for tb, g in zip(payloads, grants):
            assert len(tb) == g.tbs
        pay = _upload_payload_dense(payloads, [g.tbs for g in grants],
                                    tb_cap)

        BW = tb_cap * 8 + 24
        s_src = np.zeros(n_slots, np.int32)
        for r, g in enumerate(grants):
            segm = cbsegm(g.tbs)
            startb = 0
            for c, k in enumerate(segm.cb_sizes):
                f = segm.F if c == 0 else 0
                take = k - f - (24 if segm.C > 1 else 0)
                s_src[pack.row_start[r] + c] = (
                    r * (K_MAX + BW) + K_MAX + (BW - (g.tbs + 24))
                    + startb + take - K_MAX)
                startb += take

        # interleave classes by (m_sc, qm)
        keys: dict = {}
        cls_il = np.zeros(w, np.int32)
        for i, g in enumerate(grants):
            cls_il[i] = keys.setdefault((12 * g.nof_prb, g.qm), len(keys))
        ncls_il = _bucket_of(len(keys), CLS_BUCKETS)
        if not hasattr(self, "_stackc"):
            self._stackc = {}

        def _tab(rows_of):
            def rows():
                r = [rows_of(m, q) for (m, q) in keys]
                return r + [r[0]] * (ncls_il - len(r))
            return rows

        il_tab = _stack_cached(
            self._stackc, ("il", tuple(keys), ncls_il),
            _tab(lambda m, q: _ul_interleave_tab_dev(m, q, nsym)))
        pad_tab = _stack_cached(
            self._stackc, ("pad", tuple(keys), ncls_il),
            _tab(lambda m, q: _ul_pad_tab_dev(m, q, nsym)))
        seqs = _stack_cached(
            self._stackc,
            ("seq", tuple((g.rnti, s)
                          for s, g in zip(sf_indices, grants))),
            lambda: [self._seq(g.rnti, s)
                     for s, g in zip(sf_indices, grants)])
        dmrs = _stack_cached(
            self._stackc, ("dmrs", tuple(g.nof_prb for g in grants)),
            lambda: [_win_ul_dmrs_tx(self.cell, g.nof_prb)
                     for g in grants])
        params = jnp.asarray(np.concatenate([pack.params, s_src]))
        qm_r = jnp.asarray(np.array([g.qm for g in grants], np.int32))
        msc_r = jnp.asarray(np.array([12 * g.nof_prb for g in grants],
                                     np.int32))
        k0_r = jnp.asarray(np.array([12 * g.prb_start for g in grants],
                                    np.int32))
        tx_tab, perq = tx_class_tables(pack, e_cap)
        fn = _build_win_ul_tx(self.cell, w, n_slots, cq, cf, e_cap,
                              tb_cap, ncls_il)
        p_args = ()
        if pucch is not None:
            pprb, pgrids, live = pucch
            p_args = (_upload(np.asarray(pprb, np.int32)),
                      _upload(np.stack([pgrids.real, pgrids.imag],
                                       -1).astype(np.float32)),
                      jnp.asarray(np.asarray(live, np.float32)))
        out = fn(pay, params, tx_tab, perq, il_tab, pad_tab,
                 jnp.asarray(cls_il), qm_r, msc_r, k0_r, seqs, dmrs,
                 *p_args)
        self.stats["windows"] += 1
        self.stats["ttis"] += w
        return out

    samples = staticmethod(WindowedEnbDl.samples)


# --------------------------------------------------------------------------
# 2-codeword (TM3/TM4) DL GENERATION window
# --------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _build_win_tx_mimo(cell: Cell, n_rows: int, n_slots: int, ncls_q: int,
                       ncls_f: int, e_cap: int, tb_cap: int, ncls_re: int):
    """2-codeword spatial-multiplexing DL generator: the shared codeword
    core over 2W rows, per-codeword scramble/modulate, layer map, TM4
    codebook / TM3 CDD precoding one-hot selected by the per-TTI PMI,
    2-port grid overlay, 2-port IFFT — the TX mirror of
    `WindowedUeDlMimo`."""
    from .phy.mimo import precode_cdd2, precode_spatialmux
    from .phy.modem import modulate

    R = n_rows          # codeword rows = 2 * W
    W2 = n_rows // 2
    core = _make_codeword_core(n_rows, n_slots, ncls_f, e_cap, tb_cap)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    @jax.jit
    def fn(payload, params, tx_tab, perq, inv_re, cls_re, qm_r, n_re_t,
           pmi_t, seqs, tmpl_ri):
        cw = core(payload, params, tx_tab, perq)
        cwm = cw ^ seqs

        sym = jnp.zeros((R, RE_MAX), jnp.complex64)
        for mod_c, qm_c in zip(MODS, QMS):
            sy = modulate(mod_c, cwm[:, : RE_MAX * qm_c])
            sym = jnp.where((qm_r == qm_c)[:, None], sy, sym)
        n_re_rows = jnp.repeat(n_re_t, 2)
        sym = jnp.where(jnp.arange(RE_MAX)[None, :] < n_re_rows[:, None],
                        sym, 0.0)

        # layer map (2 CW → 2 layers) + precode, PMI/CDD as data
        layers = sym.reshape(W2, 2, RE_MAX)
        cands = [precode_spatialmux(layers, p) for p in range(3)]
        cands.append(precode_cdd2(layers))
        ports = cands[0]
        for p in range(1, 4):
            ports = jnp.where((pmi_t == p)[:, None, None], cands[p], ports)

        # 2-port grid overlay via the class-shared inverse RE tables
        tmpl = _ri2c(tmpl_ri)                       # (W2, 2, S)
        pp = jnp.concatenate(
            [ports, jnp.zeros((W2, 2, 1), jnp.complex64)], axis=2)

        def overlay(c):
            return jnp.where(inv_re[c][None, None, :] < RE_MAX,
                             pp[:, :, jnp.clip(inv_re[c], 0, RE_MAX)],
                             tmpl)

        g = overlay(0)
        for c in range(1, ncls_re):
            g = jnp.where((cls_re == c)[:, None, None], overlay(c), g)
        grid = g.reshape(W2, 2, cell.nsymb_per_sf, cell.nof_re_per_symbol)
        samples = jax.vmap(lambda gr: ofdm_tx_sf(ofdm, gr))(grid)
        return _c2ri(samples)                       # (W2, 2, sf_len, 2)

    return fn


class WindowedEnbDlMimo(WindowedEnbDl):
    """Generate ANY W-TTI mix of 2-codeword TM3/TM4 PDSCH subframes per
    dispatch (DlGrant2: TM4 codebook PMIs 0-2 as data, TM3 CDD as
    pmi 3) — validated against `WindowedUeDlMimo`."""

    def _seq_q(self, rnti: int, sf_idx: int, q: int):
        from .phy.sequence import gold_sequence

        key = (rnti, sf_idx, q)
        if key not in self._seq_dev:
            cinit = pdsch_cinit(rnti, sf_idx, self.cell.id, q=q)
            self._seq_dev[key] = jnp.asarray(np.asarray(
                gold_sequence(cinit, G_MAX)).astype(np.uint8))
        return self._seq_dev[key]

    def _tmpl(self, sf_idx: int):
        if sf_idx not in self._tmpl_dev:
            from .phy.chest.refsignal_dl import put_crs_np

            t = np.zeros((2, self.cell.nsymb_per_sf,
                          self.cell.nof_re_per_symbol), np.complex64)
            put_crs_np(t, self.cell, sf_idx)
            flat = t.reshape(2, -1)
            self._tmpl_dev[sf_idx] = jnp.asarray(
                np.stack([flat.real, flat.imag], -1).astype(np.float32))
        return self._tmpl_dev[sf_idx]

    def dispatch_window(self, payload_pairs, sf_indices, grants):
        """payload_pairs: per TTI (tb1_bits, tb2_bits); grants: DlGrant2.
        Returns device (W, 2, sf_len, 2) float32 RI samples."""
        w = self.w
        assert len(payload_pairs) == w == len(sf_indices) == len(grants)
        n_res = [self._idx(s, tuple(g.prb))[1] for s, g in
                 zip(sf_indices, grants)]
        row_specs = []
        for i, g in enumerate(grants):
            row_specs.append((g.tbs1, n_res[i] * g.qm1, g.qm1, g.rv1))
            row_specs.append((g.tbs2, n_res[i] * g.qm2, g.qm2, g.rv2))
        pack = pack_window(row_specs)
        (_r, n_slots, cq, cf, e_cap, _jf, tb_cap, _ct) = pack.key[:8]

        tbs_rows = [t for pair in payload_pairs for t in pair]
        for tb, (tbs_r, _g, _q, _rv) in zip(tbs_rows, row_specs):
            assert len(tb) == tbs_r
        pay = _upload_payload_dense(
            tbs_rows, [r_[0] for r_ in row_specs], tb_cap)

        BW = tb_cap * 8 + 24
        s_src = np.zeros(n_slots, np.int32)
        for r, (tbs_r, _g, _q, _rv) in enumerate(row_specs):
            segm = cbsegm(tbs_r)
            startb = 0
            for c, k in enumerate(segm.cb_sizes):
                f = segm.F if c == 0 else 0
                take = k - f - (24 if segm.C > 1 else 0)
                s_src[pack.row_start[r] + c] = (
                    r * (K_MAX + BW) + K_MAX + (BW - (tbs_r + 24))
                    + startb + take - K_MAX)
                startb += take

        keys: dict = {}
        cls_re = np.zeros(w, np.int32)
        for i, (s, g) in enumerate(zip(sf_indices, grants)):
            cls_re[i] = keys.setdefault((s, tuple(g.prb)), len(keys))
        ncls_re = _bucket_of(len(keys), CLS_BUCKETS)
        inv_rows = [self._inv(s, prb)[0] for (s, prb) in keys]
        inv_rows += [inv_rows[0]] * (ncls_re - len(inv_rows))
        inv_re = _stacker(ncls_re)(*inv_rows)
        seqs = _stacker(2 * w)(*[
            self._seq_q(g.rnti, s, q)
            for s, g in zip(sf_indices, grants) for q in (0, 1)])
        tmpl = _stacker(w)(*[self._tmpl(s) for s in sf_indices])

        params = jnp.asarray(np.concatenate([pack.params, s_src]))
        qm_r = jnp.asarray(np.array(
            [q for g in grants for q in (g.qm1, g.qm2)], np.int32))
        n_re_t = jnp.asarray(np.array(n_res, np.int32))
        pmi_t = jnp.asarray(np.array(
            [3 if g.tx_scheme == "cdd" else g.pmi for g in grants],
            np.int32))
        tx_tab, perq = tx_class_tables(pack, e_cap)
        fn = _build_win_tx_mimo(self.cell, 2 * w, n_slots, cq, cf, e_cap,
                                tb_cap, ncls_re)
        out = fn(pay, params, tx_tab, perq, inv_re,
                 jnp.asarray(cls_re), qm_r, n_re_t, pmi_t, seqs, tmpl)
        self.stats["windows"] += 1
        self.stats["ttis"] += w
        return out
