"""Resampling: linear interpolation, FFT interpolate/decimate with
overlap-save block state, decimating FIR.

Re-design of `lib/src/phy/resampling/` (`interp.h:40-110`,
`resampler.c:109-189`, `decim.c`).  The FFT resampler mirrors the
reference's overlap-add state machine but expresses one block as pure
device math; blocks batch over a leading axis, and when the sample axis is
sharded across chips the `halo` argument is exchanged with
`jax.lax.ppermute` (SURVEY §5.7 — overlap-save becomes a halo exchange).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np


def interp_linear(x, ratio: int):
    """Linear interpolation by integer ratio (`srslte_interp_linear_*`).

    (..., n) → (..., n*ratio); last segment extrapolates.
    """
    n = x.shape[-1]
    nxt = jnp.concatenate([x[..., 1:], 2 * x[..., -1:] - x[..., -2:-1]], axis=-1)
    t = jnp.arange(ratio, dtype=jnp.float32) / ratio
    out = x[..., :, None] * (1 - t) + nxt[..., :, None] * t
    return out.reshape(x.shape[:-1] + (n * ratio,))


def resample_fft(x, p: int, q: int):
    """Whole-buffer FFT resampling by rational p/q (len*p % q must be 0).

    Frequency-domain zero-pad (p>q) or truncate (p<q); equivalent to the
    reference's `srslte_resampler_fft` on one block.
    """
    n = x.shape[-1]
    m = n * p // q
    xf = jnp.fft.fft(x, axis=-1)
    yf = jnp.zeros(x.shape[:-1] + (m,), xf.dtype)
    half = min(n, m) // 2
    yf = yf.at[..., :half].set(xf[..., :half])
    yf = yf.at[..., -half:].set(xf[..., -half:])
    return (jnp.fft.ifft(yf, axis=-1) * (m / n)).astype(jnp.complex64)


def resample_fft_blocks(x_blocks, p: int, q: int, halo: int = 64):
    """Blockwise overlap-save FFT resampling.

    x_blocks: (nblocks, blk) contiguous stream split into equal blocks.
    Each block is extended by `halo` samples from its neighbours (edge
    blocks reflect), resampled, and the halo region discarded — the
    distributed form replaces the numpy rolls with `lax.ppermute`.
    """
    nb, blk = x_blocks.shape[-2], x_blocks.shape[-1]
    assert (blk + 2 * halo) * p % q == 0 and blk * p % q == 0
    left = jnp.concatenate([x_blocks[..., :1, :halo], x_blocks[..., :-1, -halo:]], axis=-2)
    right = jnp.concatenate([x_blocks[..., 1:, :halo], x_blocks[..., -1:, -halo:]], axis=-2)
    ext = jnp.concatenate([left, x_blocks, right], axis=-1)
    y = resample_fft(ext, p, q)
    h_out = halo * p // q
    return y[..., h_out : h_out + blk * p // q]


@lru_cache(maxsize=32)
def _lowpass_fir(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def decimate(x, factor: int, ntaps: int = 33):
    """Anti-aliased decimation (`srslte_decim_c`): FIR then downsample."""
    h = jnp.asarray(_lowpass_fir(ntaps, 0.5 / factor), jnp.complex64)
    y = jnp.convolve(x, h, mode="same") if x.ndim == 1 else None
    if y is None:
        pad = ntaps // 2
        xe = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
        win = jnp.stack([xe[..., i : i + x.shape[-1]] for i in range(ntaps)], -1)
        y = jnp.einsum("...nt,t->...n", win, h[::-1])
    return y[..., ::factor]


@lru_cache(maxsize=16)
def _arb_polyphase_bank(nphases: int, ntaps: int, cutoff: float) -> np.ndarray:
    """(nphases+1, ntaps) fractional-delay filter bank: row p holds a
    windowed-sinc interpolation kernel at delay p/nphases (the analog of
    `srslte_resample_arb_polyfilt`, resample_arb.c:29 — generated instead
    of tabulated).  Row nphases == row 0 delayed one full sample, so phase
    interpolation never wraps."""
    center = ntaps // 2 - 1
    beta = 8.0
    half = ntaps / 2
    bank = np.zeros((nphases + 1, ntaps), np.float64)
    for p in range(nphases + 1):
        u = np.arange(ntaps) - center - p / nphases
        # continuous Kaiser window evaluated at the fractional delay
        w = np.where(
            np.abs(u) <= half,
            np.i0(beta * np.sqrt(np.maximum(0.0, 1 - (u / half) ** 2))) / np.i0(beta),
            0.0,
        )
        h = np.sinc(u * 2 * cutoff) * w
        bank[p] = h / h.sum()  # unit DC gain per phase
    return bank.astype(np.float32)


def resample_arb(x, rate: float, nphases: int = 32, ntaps: int = 8):
    """Arbitrary-ratio polyphase resampler (`resample_arb.c`): output k is
    the input at time k/rate, interpolated by an 8-tap fractional-delay
    filter with linear blending between the 32 bank phases.

    Batched form: ONE gather of (n_out, ntaps) windows + one einsum against the
    blended coefficients — no shift register, no per-sample loop.
    x: (..., n) → (..., floor(n*rate)).
    """
    n = x.shape[-1]
    n_out = int(np.floor(n * rate))
    # anti-alias when decimating: scale the kernel cutoff by the rate
    cutoff = 0.5 * min(1.0, rate)
    bank = jnp.asarray(_arb_polyphase_bank(nphases, ntaps, cutoff))
    t = np.arange(n_out, dtype=np.float64) / rate
    idx = np.floor(t).astype(np.int32)
    mu = (t - idx) * nphases
    p0 = np.floor(mu).astype(np.int32)
    frac = jnp.asarray((mu - p0).astype(np.float32))
    center = ntaps // 2 - 1
    pad = [(0, 0)] * (x.ndim - 1) + [(center, ntaps - center)]
    xe = jnp.pad(x, pad)
    win = xe[..., jnp.asarray(idx)[:, None] + jnp.arange(ntaps)[None, :]]
    c = bank[p0] * (1.0 - frac)[:, None] + bank[p0 + 1] * frac[:, None]
    return jnp.einsum("...kt,kt->...k", win, c).astype(x.dtype)
