"""Dynamic-shape turbo decoding: one compiled program per (K_max, B) bucket
decodes codeblocks of ANY of the 188 LTE sizes K <= K_max.

Why: the static decoder (`turbo.py`) bakes K into the trace, so a live
scheduler driving arbitrary per-TTI grants (MCS 0-28 x any PRB set) would
trigger a fresh XLA compile per transport-block layout — the reference
handles any grant inside a 1 ms budget with zero recompilation
(`lib/src/phy/phch/sch.c:503` decode_tb, `srsue/src/phy/cc_worker.cc:214`).
Here the codeblock size becomes *data*:

* LLRs live in (B, 3, K_max+4) buffers; positions >= K are zeroed, which
  makes every trellis step beyond K an erasure (gamma == 0) — the masked
  region is branch-metric-neutral, so alpha/beta for positions < K are
  untouched.
* The exact tail state (beta at position K) is **injected mid-scan**: each
  window lane knows the scan step at which its global position crosses its
  codeblock's K and swaps the carry for the tail-derived beta — the dynamic
  analog of `turbodecoder_win.h`'s known-last-window initialisation.
* The QPP interleaver and its inverse are *inputs* ((B, K_max) gathers,
  identity-padded), not trace constants.
* CRC early-stop uses the leading-zeros invariance of CRCs with zero
  initial value: bits are rolled to the tail of the K_max buffer and
  multiplied with ONE fixed (K_max, 24) matrix, valid for every K.

All shapes are static; `k_vec`, permutations, and masks are plain device
arrays, so one jit serves every grant in the bucket.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .turbo import (NEG_INF, TRAIN, _beta_tail, _trellis, _window_layout,
                    auto_backend, dstream_tails, window_rows)


def map_decoder_dyn(lx, lz, beta_k, k_vec, k_max: int, dtype=jnp.float32,
                    backend: str = "auto"):
    """One constituent max-log-MAP pass over dynamic-size codeblocks.

    lx, lz: (B, K_max) systematic+apriori / parity LLRs, zero beyond each
    CB's true size.  beta_k: (B, 8) exact beta at position K (from the tail
    bits).  k_vec: (B,) int32 true sizes.  Returns posteriors (B, K_max)
    (garbage beyond K — callers mask).

    Same window layout/scan structure as `turbo.map_decoder` (states on
    the leading axis, B*nw windows on lanes); the only dynamic additions
    are the per-lane beta injection and the erasure region.  backend
    "auto" follows `turbo.auto_backend`: the Pallas kernel on a GPU (the
    injection rides its per-lane `kq` input), the XLA scan elsewhere.
    """
    t = _trellis()
    nw, lw = _window_layout(k_max)
    b = lx.shape[0]
    bn = b * nw
    T = min(24 if lw >= 96 else TRAIN, lw)

    x = (0.5 * lx).astype(dtype)
    z = (0.5 * lz).astype(dtype)

    if backend == "auto":
        backend = auto_backend(dtype)
    rows = window_rows(x, z, nw, lw, T)
    starts = np.arange(nw) * lw
    if backend in ("pallas", "pallas_interpret"):
        from .turbo_kernel import map_windows

        lane_w = np.tile(np.arange(nw), b)
        a_mask = jnp.asarray((lane_w == 0).astype(np.float32))
        b_known = jnp.repeat(beta_k.astype(jnp.float32), nw, axis=0).T
        w_starts_t = jnp.asarray(np.tile(starts, b).astype(np.int32))
        k_local = jnp.repeat(k_vec.astype(jnp.int32), nw) - w_starts_t
        kq = jnp.where((k_local >= 1) & (k_local <= lw), k_local, 0)
        llr = map_windows(
            *rows, a_mask, kq, b_known, T=T, lw=lw,
            interpret=(backend == "pallas_interpret"))
        return llr.reshape(lw, b, nw).transpose(1, 2, 0).reshape(
            b, k_max).astype(jnp.float32)
    # alpha as in the static decoder (positions < K never read data beyond
    # K, and erasure steps beyond K are harmless)
    ax_train, az_train, bx_train, bz_train, ax_main, az_main = rows

    sp = (2.0 * t["parity"] - 1.0).astype(np.float32)
    spp = (2.0 * t["prev_parity"] - 1.0).astype(np.float32)
    spu = (2.0 * t["prev_u"] - 1.0).astype(np.float32)
    ps0, ps1 = t["prev_state"][:, 0], t["prev_state"][:, 1]
    ns0, ns1 = t["next_state"][:, 0], t["next_state"][:, 1]

    c_spu0 = jnp.asarray(spu[:, 0:1], dtype)
    c_spu1 = jnp.asarray(spu[:, 1:2], dtype)
    c_spp0 = jnp.asarray(spp[:, 0:1], dtype)
    c_spp1 = jnp.asarray(spp[:, 1:2], dtype)

    def alpha_step(a, inputs):
        xt, zt = inputs
        a0 = a[jnp.asarray(ps0)]
        a1 = a[jnp.asarray(ps1)]
        new = jnp.maximum(
            a0 + (c_spu0 * xt + c_spp0 * zt), a1 + (c_spu1 * xt + c_spp1 * zt)
        )
        return new, None

    def alpha_step_out(a, inputs):
        new, _ = alpha_step(a, inputs)
        return new, a

    a_tr, _ = jax.lax.scan(alpha_step, jnp.zeros((8, bn), dtype), (ax_train, az_train))
    a_init = a_tr.reshape(8, b, nw)
    known = jnp.concatenate(
        [jnp.zeros((1, b, 1), dtype), jnp.full((7, b, 1), NEG_INF, dtype)], axis=0
    )
    a_init = jnp.concatenate([known, a_init[:, :, 1:]], axis=2).reshape(8, bn)
    _, alphas = jax.lax.scan(alpha_step_out, a_init, (ax_main, az_main))

    # --- beta with dynamic tail injection ---
    c_sp0 = jnp.asarray(sp[:, 0:1], dtype)
    c_sp1 = jnp.asarray(sp[:, 1:2], dtype)

    def beta_core(bta, xt, zt):
        g0 = -xt + c_sp0 * zt
        g1 = xt + c_sp1 * zt
        b0 = bta[jnp.asarray(ns0)] + g0
        b1 = bta[jnp.asarray(ns1)] + g1
        return b0, b1

    def beta_train_step(bta, inputs):
        xt, zt = inputs
        b0, b1 = beta_core(bta, xt, zt)
        return jnp.maximum(b0, b1), None

    b_tr, _ = jax.lax.scan(
        beta_train_step, jnp.zeros((8, bn), dtype), (bx_train[::-1], bz_train[::-1])
    )
    b_init = b_tr.reshape(8, bn)

    # lane (b_i, w) injects its codeblock's tail beta when the carry
    # represents position w*lw + (lw - j) == K, i.e. at reversed step
    # j = w*lw + lw - K (steps outside [0, lw) never fire — that lane's K
    # lies in another window).
    # lane order is (b, w) flattened — matches window_rows' lanes
    w_starts = jnp.asarray(np.tile(starts, b))
    k_lane = jnp.repeat(k_vec.astype(jnp.int32), nw)  # (bn,)
    inject_step = w_starts + lw - k_lane  # (bn,) reversed-step index, may be out of range
    beta_known = jnp.repeat(beta_k.astype(dtype), nw, axis=0).T  # (8, bn)

    def beta_post_step(carry, inputs):
        bta, j = carry
        xt, zt, alpha_t = inputs
        hit = (j == inject_step)[None, :]  # (1, bn)
        bta = jnp.where(hit, beta_known, bta)
        b0, b1 = beta_core(bta, xt, zt)
        m0 = jnp.max(alpha_t + b0, axis=0)
        m1 = jnp.max(alpha_t + b1, axis=0)
        return (jnp.maximum(b0, b1), j + 1), m1 - m0

    (_, _), llr_rev = jax.lax.scan(
        beta_post_step,
        (b_init, jnp.int32(0)),
        (ax_main[::-1], az_main[::-1], alphas[::-1]),
    )
    llr = llr_rev[::-1]
    return llr.reshape(lw, b, nw).transpose(1, 2, 0).reshape(b, k_max).astype(jnp.float32)


@partial(jax.jit, static_argnames=("k_max", "max_iterations", "backend"))
def turbo_decode_dyn(
    d_llr,
    k_vec,
    per,
    inv,
    valid,
    k_max: int,
    max_iterations: int = 5,
    crc_table=None,
    crc_is_b=None,
    perm_groups=None,
    class_perms=None,
    backend: str = "auto",
):
    """Decode a batch of dynamic-size codeblocks.

    d_llr: (B, 3, K_max+4) d-stream LLRs — each CB's data in columns
    [0, K_i), its 4 tail columns at [K_i, K_i+4), zeros elsewhere.
    k_vec: (B,) int32 true sizes.  per/inv: (B, K_max) QPP permutation and
    inverse, identity beyond K_i.  valid: (B,) bool — padded slots are
    treated as already done.
    crc_table: optional (K_max, 24+24) float32: columns [:24] the CRC24A
    matrix, [24:] CRC24B (both built at K_max; leading-zeros invariance
    makes them exact for every K).  crc_is_b: (B,) bool selects which poly
    gates early stop per CB.
    perm_groups: optional (per3, inv3, cls) for the windowed layout where
    B = W * B_CB and a transport block has at most 3 distinct CB layouts
    (CB0-with-filler / K- / K+): per3/inv3 (W, 3, K_max), cls (W, B_CB)
    int32 in [0, 3).  Gathers whose indices are SHARED across a batch
    axis vectorize better than per-row-index gathers — grouping turns
    every interleave into 3 shared gathers + a select.
    class_perms: optional (perC (NCLS, K_max), invC (NCLS, K_max),
    cls (B,)) — WINDOW-GLOBAL layout classes: every batch row selects one
    of NCLS permutation tables shared by the whole batch, so each
    interleave is NCLS fully-vectorized shared-index gathers + a select
    chain (the per-TTI grouped form above still gathers per row along
    the TTI axis).
    Returns (bits (B, K_max) uint8 — zero beyond K, posteriors,
    n_iters (B,) int32 — the iteration at which each CB's CRC first
    passed, or the loop's final iteration count if it never did).

    The iteration does TWO interleaves (nat→int of ext1, int→nat of
    ext2) — the posterior for output/early-stop is the natural-order
    extrinsic sum sys + ext1 + ext2, so no third interleave is needed
    (the reference extracts output from the second decoder and pays the
    deinterleave, turbodecoder_win.h:811).
    """
    b = d_llr.shape[0]
    pos = jnp.arange(k_max)
    in_mask = pos[None, :] < k_vec[:, None]  # (B, K_max)

    sys = jnp.where(in_mask, d_llr[:, 0, :k_max], 0.0)
    p1 = jnp.where(in_mask, d_llr[:, 1, :k_max], 0.0)
    p2 = jnp.where(in_mask, d_llr[:, 2, :k_max], 0.0)

    tail_cols = k_vec[:, None, None] + jnp.arange(4)[None, None, :]  # (B,1,4)
    d_tail = jnp.take_along_axis(
        d_llr, jnp.broadcast_to(tail_cols, (b, 3, 4)), axis=2
    )  # (B, 3, 4)
    lx1_t, lz1_t, lx2_t, lz2_t = dstream_tails(d_tail)
    beta_k1 = _beta_tail(lx1_t, lz1_t)  # (B, 8)
    beta_k2 = _beta_tail(lx2_t, lz2_t)

    if class_perms is not None:
        perC, invC, clsv = class_perms
        ncls = perC.shape[0]

        def make_cls(tab):
            def fwd(s):
                out = s[:, tab[0]]
                for v in range(1, ncls):
                    out = jnp.where((clsv == v)[:, None], s[:, tab[v]], out)
                return out

            return fwd

        permute_per = make_cls(perC)
        permute_inv = make_cls(invC)
    elif perm_groups is not None:
        per3, inv3, cls = perm_groups
        w, b_cb = cls.shape

        def grouped(idx3):
            def fwd(s):
                x = s.reshape(w, b_cb, k_max)

                def one_tti(xi, idx3_i, cls_i):
                    outs = xi[:, idx3_i[0]], xi[:, idx3_i[1]], xi[:, idx3_i[2]]
                    sel = cls_i[:, None]
                    return jnp.where(
                        sel == 0, outs[0],
                        jnp.where(sel == 1, outs[1], outs[2]))

                return jax.vmap(one_tti)(x, idx3, cls).reshape(b, k_max)

            return fwd

        permute_per = grouped(per3)
        permute_inv = grouped(inv3)
    else:
        permute_per = lambda s: jnp.take_along_axis(s, per, axis=1)
        permute_inv = lambda s: jnp.take_along_axis(s, inv, axis=1)

    sys_int = jnp.where(in_mask, permute_per(sys), 0.0)

    def one_iteration(ext2):
        x1 = sys + ext2
        post1 = map_decoder_dyn(x1, p1, beta_k1, k_vec, k_max,
                                backend=backend)
        ext1 = jnp.where(in_mask, post1 - x1, 0.0)
        in2 = sys_int + permute_per(ext1)
        post2 = map_decoder_dyn(in2, p2, beta_k2, k_vec, k_max,
                                backend=backend)
        ext2_int = post2 - in2
        new_ext2 = jnp.where(in_mask, permute_inv(ext2_int), 0.0)
        # full APP in natural order — no third interleave
        return new_ext2, sys + ext1 + new_ext2

    def crc_pass(post):
        if crc_table is None:
            return jnp.zeros((b,), bool)
        bits = jnp.where(in_mask, (post > 0), False)
        # roll each CB's bits to the buffer tail so the fixed CRC matrix
        # applies — a batched contiguous slice, not a per-row gather.
        # Left-pad with zeros instead of duplicating the bit array (bits
        # beyond K are zero, so [0…0 | bits][k : k+K] is the right-aligned
        # window) and slice in uint8: 4x less traffic than the f32 form.
        cat = jnp.concatenate(
            [jnp.zeros((b, k_max), jnp.uint8), bits.astype(jnp.uint8)],
            axis=1)
        tail_bits = jax.vmap(
            lambda row, k: jax.lax.dynamic_slice(row, (k,), (k_max,))
        )(cat, k_vec)
        acc = jnp.matmul(tail_bits.astype(jnp.float32), crc_table,
                         preferred_element_type=jnp.float32)
        okA = jnp.all((acc[:, :24].astype(jnp.int32) & 1) == 0, axis=-1)
        okB = jnp.all((acc[:, 24:].astype(jnp.int32) & 1) == 0, axis=-1)
        return jnp.where(crc_is_b, okB, okA)

    def cond(state):
        i, ext2, post, done, it_vec = state
        return jnp.logical_and(i < max_iterations, jnp.logical_not(jnp.all(done)))

    def body(state):
        i, ext2, post, done, it_vec = state
        new_ext2, new_post = one_iteration(ext2)
        new_ext2 = jnp.where(done[:, None], ext2, new_ext2)
        new_post = jnp.where(done[:, None], post, new_post)
        new_done = jnp.logical_or(done, crc_pass(new_post))
        it_vec = jnp.where(jnp.logical_and(new_done, jnp.logical_not(done)),
                           i + 1, it_vec)
        return i + 1, new_ext2, new_post, new_done, it_vec

    init = (
        jnp.int32(0),
        jnp.zeros((b, k_max)),
        jnp.zeros((b, k_max)),
        jnp.logical_not(valid),
        jnp.zeros((b,), jnp.int32),
    )
    n_loop, _, post, done, it_vec = jax.lax.while_loop(cond, body, init)
    it_vec = jnp.where(done, it_vec, n_loop)  # never-converged: loop count
    bits = jnp.where(in_mask, (post > 0).astype(jnp.uint8), 0)
    return bits, post, it_vec


@lru_cache(maxsize=64)
def crc_table_ab(k_max: int) -> np.ndarray:
    """Fixed (K_max, 48) CRC24A|CRC24B matrix for dynamic-K checks."""
    from ..common import LTE_CRC24A, LTE_CRC24B
    from ..crc import crc_matrix_np

    a = crc_matrix_np(LTE_CRC24A, k_max).astype(np.float32)
    bb = crc_matrix_np(LTE_CRC24B, k_max).astype(np.float32)
    return np.concatenate([a, bb], axis=1)
