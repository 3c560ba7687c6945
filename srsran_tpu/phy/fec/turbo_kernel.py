"""Pallas kernel (Triton route) for the windowed max-log-MAP pass.

The XLA form of the pass (`turbo.map_decoder`'s scan) runs every trellis
step as its own loop iteration over all lanes and writes each step's
(8, lanes) alphas to device memory.  Here one program owns a power-of-two
block of lanes — a lane is one (codeblock, window) pair — and loops over
the window's positions itself, with the 8 state metrics of each recursion
held in registers as 8 separate lane vectors (state permutations are then
free renamings).

Schedule, per lane (window length lw, training length T):

1. Training: alpha runs forward over the T positions before the window
   while beta runs backward over the T after it, in one loop.  Window 0
   then takes the exact known start state.
2. First half (n1 = ceil(lw/2) steps): alpha runs forward from position 0
   while beta runs backward from position lw; both store their metrics.
3. Second half (lw - n1 steps): each step emits two posteriors, one from
   the live alpha and a stored beta, one from the live beta and a stored
   alpha.  For odd lw the middle position is emitted from stored metrics
   between the two halves.

The stores of step 2 go to device memory (the Triton route has no shared
memory scratch); each lane's metrics are written and read back by the
thread that owns the lane.

The exact tail beta replaces the backward carry where the carry reaches
the lane's codeblock end (`kq`, K - w*lw in [1, lw]; 0 = never).  That one
mechanism serves the static decoder (last window: kq = lw) and the
dynamic-K decoder (`turbo_dyn.map_decoder_dyn`).

Arithmetic is the scan's, step for step: the branch metrics are sums of
±x and ±z, the same adds and maxes run in the same order, and no step
renormalises (float32 carries a window's metric growth; per-lane offsets
cancel in the posterior m1 - m0).
"""

from __future__ import annotations

from functools import lru_cache, partial, reduce

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# lanes per program (one lane per thread)
LANES = 128


@lru_cache(maxsize=1)
def _tables():
    """Trellis wiring as static Python tuples, and the sign identities the
    kernel relies on: the u=1 branch of every transition carries the
    negated u=0 branch metric."""
    from .turbo import _trellis

    t = _trellis()
    assert (t["prev_u"][:, 1] == 1 - t["prev_u"][:, 0]).all()
    assert (t["prev_parity"][:, 1] == 1 - t["prev_parity"][:, 0]).all()
    assert (t["parity"][:, 1] == 1 - t["parity"][:, 0]).all()
    ints = lambda a: tuple(int(v) for v in a)
    return dict(
        ps0=ints(t["prev_state"][:, 0]), ps1=ints(t["prev_state"][:, 1]),
        ns0=ints(t["next_state"][:, 0]), ns1=ints(t["next_state"][:, 1]),
        # alpha gamma of the u=0 branch into s: (2u-1)x + (2p-1)z
        a_u=ints(2 * t["prev_u"][:, 0] - 1),
        a_p=ints(2 * t["prev_parity"][:, 0] - 1),
        # beta gamma of the u=0 branch out of s: -x + (2p-1)z
        b_p=ints(2 * t["parity"][:, 0] - 1),
    )


def _gamma(sx: int, sz: int, xpz, xmz):
    """sx*x + sz*z for signs ±1, bit-identical to the scan's product sum."""
    if sx > 0:
        return xpz if sz > 0 else xmz
    return -xmz if sz > 0 else -xpz


def _map_kernel(T: int, lw: int, barrier: bool):
    tb = _tables()
    ps0, ps1, ns0, ns1 = tb["ps0"], tb["ps1"], tb["ns0"], tb["ns1"]
    n1 = (lw + 1) // 2
    n2 = lw - n1

    def alpha_step(a, x, z):
        xpz, xmz = x + z, x - z
        new = []
        for s in range(8):
            g = _gamma(tb["a_u"][s], tb["a_p"][s], xpz, xmz)
            new.append(jnp.maximum(a[ps0[s]] + g, a[ps1[s]] - g))
        return new

    def beta_branches(b, x, z):
        xpz, xmz = x + z, x - z
        b0, b1 = [], []
        for s in range(8):
            g = _gamma(-1, tb["b_p"][s], xpz, xmz)
            b0.append(b[ns0[s]] + g)
            b1.append(b[ns1[s]] - g)
        return b0, b1

    def posterior(a, b0, b1):
        m0 = reduce(jnp.maximum, [a[s] + b0[s] for s in range(8)])
        m1 = reduce(jnp.maximum, [a[s] + b1[s] for s in range(8)])
        return m1 - m0

    def kernel(axt_ref, azt_ref, bxt_ref, bzt_ref, ax_ref, az_ref,
               amask_ref, kq_ref, bknown_ref, out_ref, a_scr, b_scr):
        kq = kq_ref[...]
        bk = [bknown_ref[s] for s in range(8)]

        def inject(b, pos):
            hit = kq == pos
            return [jnp.where(hit, bk[s], b[s]) for s in range(8)]

        def train(i, carry):
            a, b = carry[:8], carry[8:]
            a = alpha_step(a, axt_ref[i], azt_ref[i])
            b0, b1 = beta_branches(b, bxt_ref[T - 1 - i], bzt_ref[T - 1 - i])
            b = [jnp.maximum(b0[s], b1[s]) for s in range(8)]
            return tuple(a) + tuple(b)

        zero = jnp.zeros_like(kq, dtype=jnp.float32)
        carry = jax.lax.fori_loop(0, T, train, (zero,) * 16)
        start = amask_ref[...] > 0
        a = [jnp.where(start, 0.0 if s == 0 else -1e30, carry[s])
             for s in range(8)]
        b = list(carry[8:])

        def first_half(i, carry):
            a, b = list(carry[:8]), list(carry[8:])
            for s in range(8):
                a_scr[i * 8 + s] = a[s]
            a = alpha_step(a, ax_ref[i], az_ref[i])
            b = inject(b, lw - i)
            for s in range(8):
                b_scr[i * 8 + s] = b[s]
            b0, b1 = beta_branches(b, ax_ref[lw - 1 - i], az_ref[lw - 1 - i])
            b = [jnp.maximum(b0[s], b1[s]) for s in range(8)]
            return tuple(a) + tuple(b)

        carry = jax.lax.fori_loop(0, n1, first_half, tuple(a) + tuple(b))
        if barrier:
            plgpu.debug_barrier()

        if n1 != n2:  # odd lw: the middle position from stored metrics
            h = n2
            am = [a_scr[h * 8 + s] for s in range(8)]
            bn = [b_scr[(lw - h - 1) * 8 + s] for s in range(8)]
            b0, b1 = beta_branches(bn, ax_ref[h], az_ref[h])
            out_ref[h] = posterior(am, b0, b1)

        def second_half(c, carry):
            a, b = list(carry[:8]), list(carry[8:])
            # mirrored position: live beta, stored alpha
            tm = n2 - 1 - c
            b = inject(b, n2 - c)
            b0, b1 = beta_branches(b, ax_ref[tm], az_ref[tm])
            am = [a_scr[tm * 8 + s] for s in range(8)]
            out_ref[tm] = posterior(am, b0, b1)
            b = [jnp.maximum(b0[s], b1[s]) for s in range(8)]
            # forward position: live alpha, stored beta (at t + 1)
            t = n1 + c
            x, z = ax_ref[t], az_ref[t]
            bn = [b_scr[(lw - t - 1) * 8 + s] for s in range(8)]
            b0, b1 = beta_branches(bn, x, z)
            out_ref[t] = posterior(a, b0, b1)
            a = alpha_step(a, x, z)
            return tuple(a) + tuple(b)

        jax.lax.fori_loop(0, n2, second_half, carry)

    return kernel


def lanes_per_program(bn: int) -> int:
    """Power-of-two lane block: LANES, or less for small batches (at
    least one warp)."""
    return min(LANES, max(32, 1 << max(0, bn - 1).bit_length()))


@partial(jax.jit, static_argnames=("T", "lw", "interpret"))
def map_windows(ax_tr, az_tr, bx_tr, bz_tr, ax, az, a_mask, kq, b_known,
                T: int, lw: int, interpret: bool = False):
    """Windowed MAP over all lanes.

    ax_tr/az_tr: (T, bn) alpha training rows (positions before the
    window, in order); bx_tr/bz_tr: (T, bn) beta training rows (positions
    after the window, in order); ax/az: (lw, bn) window rows;
    a_mask: (bn,) nonzero for window-0 lanes; kq: (bn,) int32 beta
    injection position (0 = never); b_known: (8, bn) exact tail beta.
    Returns the posterior (lw, bn) float32.
    """
    bn = ax.shape[1]
    lanes = lanes_per_program(bn)
    pad = -bn % lanes
    if pad:
        padl = lambda v: jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, pad)])
        ax_tr, az_tr, bx_tr, bz_tr, ax, az, a_mask, kq, b_known = map(
            padl, (ax_tr, az_tr, bx_tr, bz_tr, ax, az, a_mask, kq, b_known))
    n = bn + pad
    n1 = (lw + 1) // 2

    def rows(r):
        return pl.BlockSpec((r, lanes), lambda i: (0, i))

    lane = pl.BlockSpec((lanes,), lambda i: (i,))
    f32 = jnp.float32
    out, _, _ = pl.pallas_call(
        _map_kernel(T, lw, barrier=not interpret),
        grid=(n // lanes,),
        in_specs=[rows(T)] * 4 + [rows(lw)] * 2 + [lane, lane, rows(8)],
        out_specs=[rows(lw), rows(8 * n1), rows(8 * n1)],
        out_shape=[jax.ShapeDtypeStruct((lw, n), f32),
                   jax.ShapeDtypeStruct((8 * n1, n), f32),
                   jax.ShapeDtypeStruct((8 * n1, n), f32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=lanes // 32, num_stages=1),
        interpret=interpret,
        name="turbo_map_windows",
    )(ax_tr.astype(f32), az_tr.astype(f32), bx_tr.astype(f32),
      bz_tr.astype(f32), ax.astype(f32), az.astype(f32),
      a_mask.astype(f32), kq.astype(jnp.int32), b_known.astype(f32))
    return out[:, :bn]

