"""PSS generation and detection, TS 36.211 §6.11.1.

Re-design of `lib/src/phy/sync/pss.c`: detection is FFT-based
cross-correlation against the three time-domain Zadoff-Chu replicas
(`pss.c:191-197`, `srslte_pss_find_pss` :451), CFO estimated from the phase
between the two half-replica dot products (`srslte_pss_cfo_compute`).

Batched: all three N_id_2 roots are correlated in ONE batched FFT multiply —
a (3, nfft) elementwise product instead of three serial convolutions — and
cell search over frequencies/cells batches further up.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

PSS_ROOTS = (25, 29, 34)  # u for N_id_2 = 0, 1, 2
PSS_LEN = 62


@lru_cache(maxsize=8)
def pss_freq_np(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 (TS 36.211 §6.11.1.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    a = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    b = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return np.concatenate([a, b]).astype(np.complex64)


@lru_cache(maxsize=32)
def pss_time_np(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica of length fft_size (pss.c generation)."""
    d = pss_freq_np(n_id_2)
    grid = np.zeros(fft_size, np.complex64)
    grid[1 : 32] = d[31:]  # positive freqs (skip DC)... careful: LTE maps
    # d[0..30] to subcarriers -31..-1 and d[31..61] to +1..+31
    grid[1:32] = d[31:62]
    grid[fft_size - 31 :] = d[0:31]
    t = np.fft.ifft(grid) * fft_size
    return (t / np.sqrt(np.sum(np.abs(t) ** 2))).astype(np.complex64)


def put_pss_grid(grid: np.ndarray, n_id_2: int, nof_prb: int, symbol: int):
    """Place PSS into a (nsymb, nre) grid at the given symbol (tx side)."""
    d = pss_freq_np(n_id_2)
    nre = nof_prb * 12
    k0 = nre // 2 - 31
    grid[symbol, k0 : k0 + 62] = d
    return grid


def pss_correlate(samples, fft_size: int = 128):
    """Correlate samples against all 3 PSS replicas.

    samples: (..., n) complex64.  Returns |corr| (..., 3, n) — peak index i
    means the PSS replica aligns starting at sample i.
    """
    n = samples.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + fft_size)))
    reps = np.stack([pss_time_np(i, fft_size) for i in range(3)])
    rep_f = np.conj(np.fft.fft(reps, nfft, axis=-1)).astype(np.complex64)
    x_f = jnp.fft.fft(samples, nfft, axis=-1)
    corr = jnp.fft.ifft(x_f[..., None, :] * jnp.asarray(rep_f), axis=-1)
    return jnp.abs(corr[..., :n])


def pss_find(samples, fft_size: int = 128):
    """Find the best (n_id_2, offset, metric) in a sample window.

    Returns (n_id_2 (...,), offset (...,), peak_value (...,), avg (...,)).
    Metric = peak / mean (proxy of the reference's peak-to-sidelobe).
    """
    c = pss_correlate(samples, fft_size)
    flat = c.reshape(c.shape[:-2] + (-1,))
    arg = jnp.argmax(flat, axis=-1)
    n = c.shape[-1]
    n_id_2 = arg // n
    offset = arg % n
    peak = jnp.take_along_axis(flat, arg[..., None], axis=-1)[..., 0]
    avg = jnp.mean(c, axis=(-1, -2))
    return n_id_2, offset, peak, avg


def pss_cfo_estimate(samples, n_id_2, fft_size: int = 128):
    """CFO (in subcarrier-spacing units) from a PSS-aligned symbol.

    samples: (..., fft_size) starting exactly at the PSS symbol.
    Phase between the two half-symbol correlations with the local replica
    (pss.c srslte_pss_cfo_compute).
    """
    rep = jnp.asarray(np.stack([pss_time_np(i, fft_size) for i in range(3)]))
    r = rep[n_id_2]
    half = fft_size // 2
    prod = samples * jnp.conj(r)
    y0 = jnp.sum(prod[..., :half], axis=-1)
    y1 = jnp.sum(prod[..., half:], axis=-1)
    return jnp.angle(jnp.conj(y0) * y1) / jnp.pi
