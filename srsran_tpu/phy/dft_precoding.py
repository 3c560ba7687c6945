"""Transform (DFT) precoding for SC-FDMA, TS 36.211 §5.3.3.

Re-design of `lib/src/phy/dft/dft_precoding.c`.  Sizes are 12*n with n
composed of factors 2/3/5 (`srslte_dft_precoding_valid_prb`), so instead of
non-power-of-2 FFT plans we apply a precomputed DFT matrix — an (M, M)
complex matmul per symbol batch, which batches well at these sizes
(M ≤ 1200).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

def valid_nof_prb(n: int) -> bool:
    """n must factor into 2/3/5 (TS 36.211 §5.3.3)."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


@lru_cache(maxsize=64)
def _dft_matrix(m: int, inverse: bool) -> np.ndarray:
    n = np.arange(m)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(n, n) / m) / np.sqrt(m)
    return w.astype(np.complex64)


def dft_precode(symbols):
    """(..., nsym, M) → DFT along last axis (normalized)."""
    m = symbols.shape[-1]
    return jnp.matmul(symbols, jnp.asarray(_dft_matrix(m, False)))


def dft_predecode(symbols):
    """Inverse transform (IDFT), used at the receiver."""
    m = symbols.shape[-1]
    return jnp.matmul(symbols, jnp.asarray(_dft_matrix(m, True)))


def idft_bluestein(x, m, n_fft: int = 4096):
    """IDFT along the last axis with a TRACED length m (Bluestein).

    The windowed PUSCH pipeline needs one program for every allocation
    width, so the transform length must be data — a per-m DFT matrix
    would be a trace constant.  Bluestein's identity nk = (n²+k²-(n-k)²)/2
    turns the length-m IDFT into a chirp multiply → one linear
    convolution at a STATIC power-of-2 FFT size → chirp multiply; the
    chirps are elementwise functions of m.

    x: (..., M_MAX) complex64, data in columns [0, m), anything beyond is
    ignored.  Returns (..., M_MAX): IDFT values in [0, m), zeros beyond.
    Normalized by 1/sqrt(m) (matches `_dft_matrix(m, True)`).
    n_fft must be >= 2*M_MAX - 1.
    """
    M = x.shape[-1]
    assert n_fft >= 2 * M - 1

    def chirp(t):
        # exp(+j*pi*t^2/m) with the square reduced mod 2m in int32 so the
        # phase stays small and float32-exact (t^2/m reaches ~1e5 rad)
        num = (t * t) % (2 * m)
        return jnp.exp(1j * jnp.pi * num.astype(jnp.float32) / m)

    k = jnp.arange(M, dtype=jnp.int32)
    in_mask = k < m
    u = jnp.where(in_mask, x, 0.0) * chirp(k)
    u_pad = jnp.concatenate(
        [u, jnp.zeros(x.shape[:-1] + (n_fft - M,), x.dtype)], axis=-1)
    l = jnp.arange(n_fft, dtype=jnp.int32)
    d = jnp.where(l < M, l, l - n_fft)  # circular placement of lags
    w = jnp.where(jnp.abs(d) < M, jnp.conj(chirp(d)), 0.0)
    conv = jnp.fft.ifft(jnp.fft.fft(u_pad, axis=-1) * jnp.fft.fft(w), axis=-1)
    out = chirp(k) * conv[..., :M] / jnp.sqrt(m.astype(jnp.float32))
    return jnp.where(in_mask, out, 0.0).astype(jnp.complex64)


def dft_bluestein(x, m, n_fft: int = 4096):
    """Forward DFT with a TRACED length m (the TX transform precoding of
    the windowed PUSCH generator).  DFT = conj(IDFT(conj(x))) under the
    symmetric 1/sqrt(m) normalization, so this reuses the Bluestein
    machinery of `idft_bluestein` unchanged."""
    return jnp.conj(idft_bluestein(jnp.conj(x), m, n_fft))
