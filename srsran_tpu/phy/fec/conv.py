"""Tail-biting convolutional code K=7 R=1/3 + Viterbi decoder, TS 36.212 §5.1.3.1.

Reference: `lib/src/phy/fec/convcoder.c` (polys 0x6D, 0x4F, 0x57 with
``sr = (sr<<1)|bit``, ``out = parity(sr & poly)`` — see pbch.c:152) and the
five SIMD Viterbi implementations (`viterbi37_*.c`).

Design: one `lax.scan` add-compare-select over the 64-state trellis with
the batch axis on codeblocks — states live in a (B, 64) metric tensor;
decisions are stored and a second scan does traceback.  Tail-biting is
handled by wrap-around Viterbi: decode the sequence repeated 3x and keep the
middle copy (near-ML, standard WAVA practice; the reference similarly decodes
with wrapped sequences).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

POLYS = (0x6D, 0x4F, 0x57)
K = 7
NSTATES = 64
RATE = 3


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@lru_cache(maxsize=1)
def _tables():
    """prev_state (64,2), and branch output signs (64,2,3) in ±1 (bit b→2b-1)."""
    prev_state = np.zeros((NSTATES, 2), np.int32)  # [s', which] -> prev s
    out_signs = np.zeros((NSTATES, 2, 3), np.float32)  # [s', which, j]
    for sp in range(NSTATES):
        u = sp & 1
        base = sp >> 1
        for which in (0, 1):
            prev = base | (which << 5)
            prev_state[sp, which] = prev
            sr = ((prev << 1) | u) & 0x7F
            for j, poly in enumerate(POLYS):
                b = _parity(sr & poly)
                out_signs[sp, which, j] = 2.0 * b - 1.0
    return prev_state, out_signs


def convcoder_encode_np(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: (D,) bits → (3, D) streams d^(0..2).

    Matches `srslte_convcoder_encode` with tail_biting=true.
    """
    d = len(bits)
    sr = 0
    for i in range(d - K + 1, d):
        sr = (sr << 1) | int(bits[i])
    out = np.zeros((3, d), np.uint8)
    for i in range(d):
        sr = ((sr << 1) | int(bits[i])) & 0x7F
        for j, poly in enumerate(POLYS):
            out[j, i] = _parity(sr & poly)
    return out


@partial(jax.jit, static_argnames=("d", "wraps"))
def viterbi_decode(llr_d, d: int, wraps: int = 3):
    """Decode (B, 3, D) LLRs (positive ⇒ bit 1) → (B, D) hard bits.

    Wrap-around Viterbi over `wraps` copies for tail-biting.
    """
    prev_state, out_signs = _tables()
    ps = jnp.asarray(prev_state)
    signs = jnp.asarray(out_signs)  # (64,2,3)

    x = 0.5 * jnp.tile(llr_d, (1, 1, wraps))  # (B, 3, wraps*D)
    b = x.shape[0]
    total = wraps * d

    def acs(pm, llr3):
        # llr3: (B, 3); branch metric (B, 64, 2)
        bm = jnp.einsum("swj,bj->bsw", signs, llr3)
        cand = pm[:, ps] + bm  # (B, 64, 2)
        dec = jnp.argmax(cand, axis=-1).astype(jnp.uint8)
        new = jnp.max(cand, axis=-1)
        new = new - jnp.max(new, axis=-1, keepdims=True)
        return new, dec

    pm0 = jnp.zeros((b, NSTATES))
    pm_final, decs = jax.lax.scan(acs, pm0, x.transpose(2, 0, 1))  # decs (T,B,64)
    state0 = jnp.argmax(pm_final, axis=-1).astype(jnp.int32)  # (B,)

    def tb(state, dec_t):
        u = (state & 1).astype(jnp.uint8)
        which = jnp.take_along_axis(dec_t, state[:, None], axis=-1)[:, 0]
        prev = (state >> 1) | (which.astype(jnp.int32) << 5)
        return prev, u

    _, bits_rev = jax.lax.scan(tb, state0, decs[::-1])
    bits = bits_rev[::-1].T  # (B, total)
    # take the middle copy (last full copy before the final partial influence)
    mid = (wraps // 2) * d
    return bits[:, mid : mid + d]
