"""On-device turbo rate-matching index computation (TS 36.212 §5.1.4.1).

The host path (`rate_match.py`) precomputes a gather/scatter index vector
per (K, E, rv, filler) signature and caches it — fine when grants repeat,
but a windowed multi-TTI pipeline would have to upload stacked index
arrays (tens of MB per window) through the host↔device link.  This module
instead derives the de-rate-match scatter indices *inside the XLA program*
from five scalars per codeblock (k, e, f, rv and the codeword offset):
the sub-block interleaver, <NULL>-skipping circular buffer, and RV start
points are all closed-form index arithmetic (the design SURVEY §7 and
Appendix A.2 call for — the reference burns 100+ MB of static LUTs on
this, `rm_turbo.c:75-100`).

Everything is traced-size-as-data over static maxima, so ONE compiled
program serves every (K, E, rv, filler) combination.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .rate_match import RM_PERM_TC

NCOLS = 32


def ncb_max(k_max: int) -> int:
    """Static circular-buffer bound for CBs up to k_max."""
    d = k_max + 4
    return 3 * (-(-d // NCOLS)) * NCOLS


def turbo_rm_positions_dev(k, f, rv, k_max: int):
    """Per-codeblock circular-buffer position table, entirely on device.

    k, f, rv: traced int32 scalars (CB size, filler bits, redundancy
    version).  k_max: static bound.

    Returns (pos_valid, n_valid):
      pos_valid: (NCB_MAX,) int32 — pos_valid[m] is the flat d-stream
        index (stream * (k_max+4) + position) of the m-th transmitted bit
        when reading the circular buffer from k0(rv), skipping <NULL>
        dummy and filler positions.  Entries beyond n_valid are the dump
        index 3*(k_max+4).
      n_valid: int32 — 3*(k+4) - 2*f distinct transmitted positions.
    """
    NCB = ncb_max(k_max)
    dump = 3 * (k_max + 4)
    perm = jnp.asarray(RM_PERM_TC, jnp.int32)

    d = k + 4
    r = (d + NCOLS - 1) // NCOLS
    kp = NCOLS * r
    nd = kp - d
    ncb = 3 * kp
    m = jnp.arange(NCB, dtype=jnp.int32)

    # region A (m < kp): streams 0/1 column-read order
    # y_idx01[i] = (i % r) * 32 + PERM[i // r]
    ca = jnp.clip(m // r, 0, NCOLS - 1)
    ya = (m % r) * NCOLS + perm[ca]
    # region B (kp <= m < 3kp): j = m - kp; even j → stream 1 via
    # y_idx01[j//2], odd j → stream 2 via pi(j//2)
    j = m - kp
    i1 = jnp.maximum(j // 2, 0)  # j < 0 only where region A wins the select
    cb = jnp.clip(i1 // r, 0, NCOLS - 1)
    yb1 = (i1 % r) * NCOLS + perm[cb]
    yb2 = (perm[cb] + NCOLS * (i1 % r) + 1) % kp
    is_even = (j % 2) == 0
    stream = jnp.where(m < kp, 0, jnp.where(is_even, 1, 2)).astype(jnp.int32)
    y = jnp.where(m < kp, ya, jnp.where(is_even, yb1, yb2))

    dpos = y - nd
    valid = (y >= nd) & (m < ncb)
    # filler bits are <NULL> in streams 0 and 1 (turbocoder.c:133-147)
    valid = valid & ~((stream < 2) & (dpos < f))
    w_flat = stream * (k_max + 4) + jnp.maximum(dpos, 0)

    # RV start point: ncb = 96r → ceil(ncb / (8r)) = 12 exactly, so
    # k0 = r * (24*rv + 2) (§5.1.4.1.2)
    k0 = r * (24 * rv + 2)
    rot = (k0 + m) % ncb
    w_rot = w_flat[rot]
    v_rot = valid[rot] & (m < ncb)  # exactly one sweep (rot wraps past ncb)
    rank = jnp.cumsum(v_rot.astype(jnp.int32)) - 1
    tgt = jnp.where(v_rot, rank, NCB)  # out-of-bounds → dropped
    pos_valid = jnp.full((NCB,), dump, jnp.int32).at[tgt].set(
        w_rot, mode="drop")
    n_valid = 3 * d - 2 * f
    return pos_valid, n_valid


@partial(jax.jit, static_argnames=("k_max", "g_max"))
def codeword_scatter_dev(cb_k, cb_e, cb_f, cb_valid, rv, k_max: int, g_max: int):
    """Scatter targets for a whole codeword's de-rate-match, on device.

    cb_k/cb_e/cb_f: (B,) int32 per-CB size / rate-matched length / filler.
    cb_valid: (B,) bool.  rv: int32 scalar.

    Returns (G_MAX,) int32: position g of the codeword LLR vector scatters
    into flat index cb*(3*(k_max+4)) + d_position of the per-TB softbuffer
    (B, 3, k_max+4); positions past the true codeword length (or mapping
    to <NULL>) get the dump index B*3*(k_max+4).
    """
    bsz = cb_k.shape[0]
    dflat = 3 * (k_max + 4)
    dump = bsz * dflat

    pos_valid, n_valid = jax.vmap(
        lambda k, f: turbo_rm_positions_dev(k, f, rv, k_max)
    )(cb_k, cb_f)  # (B, NCB), (B,)
    n_valid = jnp.where(cb_valid, jnp.maximum(n_valid, 1), 1)

    e_eff = jnp.where(cb_valid, cb_e, 0)
    bounds = jnp.cumsum(e_eff)  # (B,) exclusive-after bounds
    g_tot = bounds[-1]
    g = jnp.arange(g_max, dtype=jnp.int32)
    cb = jnp.sum((g[:, None] >= bounds[None, :]).astype(jnp.int32), axis=1)
    cb = jnp.clip(cb, 0, bsz - 1)
    start = jnp.concatenate([jnp.zeros((1,), jnp.int32), bounds[:-1]])
    jj = g - start[cb]
    mm = jj % n_valid[cb]
    tgt = cb * dflat + pos_valid[cb, mm]
    in_cb_dump = pos_valid[cb, mm] >= dflat  # that CB's own dump slot
    return jnp.where((g < g_tot) & ~in_cb_dump, tgt, dump)


def _valid_rank_dev(k, f, k_max: int):
    """Validity mask + inclusive rank over the circular buffer, in
    unrotated order (shared core of the scatter/gather forms)."""
    NCB = ncb_max(k_max)
    perm = jnp.asarray(RM_PERM_TC, jnp.int32)
    d = k + 4
    r = (d + NCOLS - 1) // NCOLS
    kp = NCOLS * r
    nd = kp - d
    ncb = 3 * kp
    m = jnp.arange(NCB, dtype=jnp.int32)
    ca = jnp.clip(m // r, 0, NCOLS - 1)
    ya = (m % r) * NCOLS + perm[ca]
    j = m - kp
    i1 = jnp.maximum(j // 2, 0)
    cb = jnp.clip(i1 // r, 0, NCOLS - 1)
    yb1 = (i1 % r) * NCOLS + perm[cb]
    yb2 = (perm[cb] + NCOLS * (i1 % r) + 1) % kp
    is_even = (j % 2) == 0
    stream = jnp.where(m < kp, 0, jnp.where(is_even, 1, 2)).astype(jnp.int32)
    y = jnp.where(m < kp, ya, jnp.where(is_even, yb1, yb2))
    dpos = y - nd
    valid = (y >= nd) & (m < ncb) & ~((stream < 2) & (dpos < f))
    rank_incl = jnp.cumsum(valid.astype(jnp.int32))
    return valid, rank_incl, r, kp, nd, ncb


def codeword_d_fill_dev(llr_pad, off, e, k, f, rv, k_max: int, rep: int):
    """De-rate-match ONE codeblock as pure gathers (no scatter).

    llr_pad: (G + NCB_MAX,) codeword LLRs zero-padded (shared across the
    TB's CBs).  off/e/k/f: traced int32 — this CB's codeword offset,
    rate-matched length, size, filler count.  rep: static bound on
    ceil(e / n_valid) repetition folds (callers assert it).

    Returns (3, k_max+4) accumulated d-stream LLRs: position p receives
    the sum of every transmitted bit that maps to it (the HARQ `+=`
    semantics of rm_turbo RX); <NULL>/filler/beyond-K positions are 0.

    Scatters serialize (colliding indices); this form is a cumsum +
    `rep` strided slices + two gather passes.
    """
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    inv_perm = np.empty(NCOLS, np.int64)
    inv_perm[RM_PERM_TC] = np.arange(NCOLS)
    inv_perm = jnp.asarray(inv_perm, jnp.int32)

    valid, rank_incl, r, kp, nd, ncb = _valid_rank_dev(k, f, k_max)
    d = k + 4
    n_valid = jnp.maximum(3 * d - 2 * f, 1)
    k0 = r * (24 * rv + 2)
    r0 = rank_incl[k0 - 1]  # k0 >= 2r >= 2

    # fold the codeword onto the n_valid circular positions:
    # acc[m'] = sum_t llr[off + m' + t*n_valid]  (masked to < e)
    marange = jnp.arange(NCB, dtype=jnp.int32)
    acc = jnp.zeros((NCB,), llr_pad.dtype)
    for t in range(rep):
        seg = jax.lax.dynamic_slice(llr_pad, (off + t * n_valid,), (NCB,))
        acc = acc + jnp.where(marange + t * n_valid < e, seg, 0.0)

    # closed-form sub-block interleaver position m of each flat d index
    p = jnp.arange(dflat, dtype=jnp.int32)
    stream = p // (k_max + 4)
    dpos = p % (k_max + 4)
    y = dpos + nd
    c01 = inv_perm[y % NCOLS]
    m01 = c01 * r + y // NCOLS
    u = (y + kp - 1) % kp  # stream 2: (y2 - 1) mod kp = P[c] + 32*row
    m2 = inv_perm[u % NCOLS] * r + u // NCOLS
    m_flat = jnp.where(stream == 0, m01,
                       jnp.where(stream == 1, kp + 2 * m01, kp + 2 * m2 + 1))
    ok = (dpos < d) & ~((stream < 2) & (dpos < f))
    m_safe = jnp.clip(m_flat, 0, NCB - 1)
    j0 = (rank_incl[m_safe] - 1 - r0) % n_valid
    fill = jnp.where(ok, acc[j0], 0.0)
    return fill.reshape(3, k_max + 4)


def _j0_variant_dev(k, f, rv, k_max: int):
    """Per-layout-variant first-fold index table: j0[p] for each flat
    d-stream position p (dump-masked by validity), plus n_valid.

    j0[p] = rank of position p in the RV-rotated transmitted sequence —
    position p accumulates llr[off + j0 + t*n_valid] for t < rep.
    """
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    inv_perm = np.empty(NCOLS, np.int64)
    inv_perm[RM_PERM_TC] = np.arange(NCOLS)
    inv_perm = jnp.asarray(inv_perm, jnp.int32)

    _valid, rank_incl, r, kp, nd, _ncb = _valid_rank_dev(k, f, k_max)
    d = k + 4
    n_valid = jnp.maximum(3 * d - 2 * f, 1)
    k0 = r * (24 * rv + 2)
    r0 = rank_incl[k0 - 1]

    p = jnp.arange(dflat, dtype=jnp.int32)
    stream = p // (k_max + 4)
    dpos = p % (k_max + 4)
    y = dpos + nd
    c01 = inv_perm[y % NCOLS]
    m01 = c01 * r + y // NCOLS
    u = (y + kp - 1) % kp
    m2 = inv_perm[u % NCOLS] * r + u // NCOLS
    m_flat = jnp.where(stream == 0, m01,
                       jnp.where(stream == 1, kp + 2 * m01, kp + 2 * m2 + 1))
    ok = (dpos < d) & ~((stream < 2) & (dpos < f))
    j0 = (rank_incl[jnp.clip(m_flat, 0, NCB - 1)] - 1 - r0) % n_valid
    return jnp.where(ok, j0, NCB), n_valid  # NCB = dump (acc[NCB] == 0)


def j0_variant_np(k: int, f: int, rv: int, k_max: int):
    """Host-side `_j0_variant_dev`: the per-layout first-fold index table
    (dflat,) int32 + n_valid, as plain numpy.

    The table depends only on (k, f, rv) — ~74 KB — so windowed pipelines
    compute it ONCE per layout class ever seen and keep it device-resident
    (building 16 class tables on device measured 13 ms per window)."""
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    perm = np.asarray(RM_PERM_TC, np.int64)
    inv_perm = np.empty(NCOLS, np.int64)
    inv_perm[perm] = np.arange(NCOLS)

    d = k + 4
    r = (d + NCOLS - 1) // NCOLS
    kp = NCOLS * r
    nd = kp - d
    ncb = 3 * kp
    m = np.arange(NCB, dtype=np.int64)
    ca = np.clip(m // r, 0, NCOLS - 1)
    ya = (m % r) * NCOLS + perm[ca]
    j = m - kp
    i1 = np.maximum(j // 2, 0)
    cb = np.clip(i1 // r, 0, NCOLS - 1)
    yb1 = (i1 % r) * NCOLS + perm[cb]
    yb2 = (perm[cb] + NCOLS * (i1 % r) + 1) % kp
    is_even = (j % 2) == 0
    stream = np.where(m < kp, 0, np.where(is_even, 1, 2))
    y = np.where(m < kp, ya, np.where(is_even, yb1, yb2))
    dpos = y - nd
    valid = (y >= nd) & (m < ncb) & ~((stream < 2) & (dpos < f))
    rank_incl = np.cumsum(valid.astype(np.int64))

    n_valid = max(3 * d - 2 * f, 1)
    k0 = r * (24 * rv + 2)
    r0 = rank_incl[k0 - 1]

    p = np.arange(dflat, dtype=np.int64)
    stream_p = p // (k_max + 4)
    dpos_p = p % (k_max + 4)
    yp = dpos_p + nd
    c01 = inv_perm[yp % NCOLS]
    m01 = c01 * r + yp // NCOLS
    u = (yp + kp - 1) % kp
    m2 = inv_perm[u % NCOLS] * r + u // NCOLS
    m_flat = np.where(stream_p == 0, m01,
                      np.where(stream_p == 1, kp + 2 * m01, kp + 2 * m2 + 1))
    ok = (dpos_p < d) & ~((stream_p < 2) & (dpos_p < f))
    j0 = (rank_incl[np.clip(m_flat, 0, NCB - 1)] - 1 - r0) % n_valid
    return np.where(ok, j0, NCB).astype(np.int32), int(n_valid)


def tx_table_np(k: int, f: int, rv: int, k_max: int):
    """TX-direction rate-match table for one layout class: tx_tab[j] is
    the flat d-stream index (stream*(k_max+4) + position) of the j-th
    transmitted bit, j in [0, n_valid) — the inverse of `j0_variant_np`
    (position → rank).  Output index n_valid-1 at entries that would read
    <NULL>/filler (none remain after inversion).  Repetition beyond
    n_valid wraps via j mod n_valid on device."""
    j0, n_valid = j0_variant_np(k, f, rv, k_max)
    dflat = 3 * (k_max + 4)
    d = k + 4
    tx = np.zeros(n_valid, np.int32)
    p = np.arange(dflat, dtype=np.int64)
    stream = p // (k_max + 4)
    dpos = p % (k_max + 4)
    ok = (dpos < d) & ~((stream < 2) & (dpos < f))
    NCB = ncb_max(k_max)
    sel = ok & (j0 < NCB)
    tx[j0[sel]] = p[sel].astype(np.int32)
    return tx, n_valid


def qpp_np(k: int, k_max: int):
    """Host-side QPP permutation + inverse, identity beyond k (the
    windowed pipelines cache these per CB size)."""
    from .cbsegm import F1, F2, cb_size_index, qpp_interleaver_np

    per = np.arange(k_max, dtype=np.int32)
    inv = np.arange(k_max, dtype=np.int32)
    p = qpp_interleaver_np(k).astype(np.int32)
    per[:k] = p
    inv_k = np.empty(k, np.int32)
    inv_k[p] = np.arange(k, dtype=np.int32)
    inv[:k] = inv_k
    return per, inv


def codeword_d_fill_grouped_dev(llr_pad, start, e_eff, cls, k3, f3, rv,
                                k_max: int, rep: int):
    """De-rate-match ONE TTI's whole codeword — grouped-gather form.

    A transport block has at most 3 distinct CB layouts (CB0-with-filler,
    K-, K+), so the per-position index tables are built once per VARIANT
    and every per-CB gather uses indices SHARED across the CB batch axis
    (shared-index gathers vectorize better than per-row-index ones).

    llr_pad: (G_MAX + NCB_MAX,) zero-padded codeword LLRs.
    start/e_eff: (B_CB,) per-CB codeword offsets / lengths (0 = unused).
    cls: (B_CB,) int32 variant index in [0, 3).
    k3/f3: (3,) variant CB size / filler count.  rv: scalar.
    Returns (B_CB, 3, k_max+4) accumulated d-stream LLRs.
    """
    dflat = 3 * (k_max + 4)
    NCB = ncb_max(k_max)
    b_cb = start.shape[0]

    j0_3, nv3 = jax.vmap(lambda k, f: _j0_variant_dev(k, f, rv, k_max))(k3, f3)
    nv_c = nv3[cls]  # (B_CB,)

    # fold the codeword onto circular positions per CB (contiguous slices);
    # high repetition counts (tiny TBs on wide allocations) use a rolled
    # loop so the program stays small
    marange = jnp.arange(NCB, dtype=jnp.int32)

    def fold_one(off, e, nv):
        def step(t, acc):
            seg = jax.lax.dynamic_slice(llr_pad, (off + t * nv,), (NCB,))
            return acc + jnp.where(marange + t * nv < e, seg, 0.0)

        acc = jnp.zeros((NCB,), llr_pad.dtype)
        if rep <= 8:
            for t in range(rep):
                acc = step(t, acc)
            return acc
        t_need = jnp.minimum((e + nv - 1) // nv, rep)  # actual folds only
        return jax.lax.fori_loop(0, t_need, step, acc)

    acc = jax.vmap(fold_one)(start, e_eff, nv_c)  # (B_CB, NCB)
    acc = jnp.concatenate(
        [acc, jnp.zeros((b_cb, 1), llr_pad.dtype)], axis=1)  # dump slot NCB

    fills = [acc[:, j0_3[v]] for v in range(3)]  # shared-index gathers
    sel = cls[:, None]
    fill = jnp.where(sel == 0, fills[0],
                     jnp.where(sel == 1, fills[1], fills[2]))
    fill = jnp.where((e_eff > 0)[:, None], fill, 0.0)
    return fill.reshape(b_cb, 3, k_max + 4)


def qpp_dev(cb_k, f1, f2, k_max: int):
    """QPP interleaver + inverse on device: per[i] = (f1·i + f2·i²) mod k.

    cb_k/f1/f2: (B,) int32.  Identity beyond k (as turbo_decode_dyn
    expects).  All arithmetic stays within int32 via modular reduction:
    (f1·i + f2·i²) mod k == (i · ((f1 + f2·i) mod k)) mod k.
    """
    bsz = cb_k.shape[0]
    i = jnp.arange(k_max, dtype=jnp.int32)[None, :]
    k = jnp.maximum(cb_k, 1)[:, None]
    t = (f1[:, None] + (f2[:, None] * i) % k) % k
    per = (i * t) % k
    per = jnp.where(i < k, per, i)
    inv = (
        jnp.zeros((bsz, k_max), jnp.int32)
        .at[jnp.arange(bsz)[:, None], per]
        .set(jnp.broadcast_to(i, (bsz, k_max)))
    )
    return per, inv


def tb_reassembly_gather_dev(cb_k, cb_f, cb_valid, crc_is_b, tbs,
                             k_max: int, tbs_max: int):
    """TB bit-gather indices on device (sch.c TB concatenation, inverted).

    Returns (tb_idx (tbs_max,) int32 left-padded gather into the flat
    (B*k_max,) decoded-bit array [dump = B*k_max for pad positions],
    crc_idx (24,) int32 — the received TB-CRC24A bit positions).
    CB i contributes bits [f_i, k_i - 24·crc_is_b_i); the final 24 bits of
    the concatenation are the TB CRC.
    """
    bsz = cb_k.shape[0]
    dump = bsz * k_max
    nbits = jnp.where(cb_valid, cb_k - cb_f - 24 * crc_is_b.astype(jnp.int32), 0)
    bounds = jnp.cumsum(nbits)
    start = jnp.concatenate([jnp.zeros((1,), jnp.int32), bounds[:-1]])

    def src_of(u):
        cb = jnp.sum((u[:, None] >= bounds[None, :]).astype(jnp.int32), axis=1)
        cb = jnp.clip(cb, 0, bsz - 1)
        local = u - start[cb] + cb_f[cb]
        return cb * k_max + jnp.clip(local, 0, k_max - 1)

    t = jnp.arange(tbs_max, dtype=jnp.int32)
    u = t - (tbs_max - tbs)
    tb_idx = jnp.where(u >= 0, src_of(jnp.maximum(u, 0)), dump)
    crc_idx = src_of(tbs + jnp.arange(24, dtype=jnp.int32))
    return tb_idx, crc_idx
