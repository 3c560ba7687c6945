"""SSS generation and detection, TS 36.211 §6.11.2.

The reference detects m0/m1 separately with partial correlations
(`lib/src/phy/sync/find_sss.c:31-136`).  Matmul design: precompute the
full hypothesis matrix of all 168 N_id_1 sequences (for each N_id_2 and
subframe 0/5) and detect with ONE matmul — 336x62 against the received SSS
symbol, batched over carriers/windows; there
is no data-dependent control flow.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

SSS_LEN = 62


def _mseq(poly_taps, init) -> np.ndarray:
    """Length-31 binary m-sequence x(i+5) = sum(taps) mod 2."""
    x = np.zeros(31, np.int64)
    x[:5] = init
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in poly_taps) % 2
    return 1 - 2 * x  # ±1


@lru_cache(maxsize=1)
def _base_sequences():
    s_t = _mseq((0, 2), [0, 0, 0, 0, 1])  # x^5+x^2+1
    c_t = _mseq((0, 3), [0, 0, 0, 0, 1])  # x^5+x^3+1
    z_t = _mseq((0, 1, 2, 4), [0, 0, 0, 0, 1])  # x^5+x^4+x^2+x+1
    return s_t, c_t, z_t


def _m0m1(n_id_1: int) -> tuple[int, int]:
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


def sss_sequence_np(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """SSS d(n), n=0..61, ±1 floats (subframe 0 or 5)."""
    s_t, c_t, z_t = _base_sequences()
    m0, m1 = _m0m1(n_id_1)
    n = np.arange(31)
    s0 = s_t[(n + m0) % 31]
    s1 = s_t[(n + m1) % 31]
    c0 = c_t[(n + n_id_2) % 31]
    c1 = c_t[(n + n_id_2 + 3) % 31]
    z1_m0 = z_t[(n + (m0 % 8)) % 31]
    z1_m1 = z_t[(n + (m1 % 8)) % 31]
    d = np.zeros(62)
    if sf_idx == 0:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d.astype(np.float32)


@lru_cache(maxsize=8)
def sss_hypothesis_matrix(n_id_2: int) -> np.ndarray:
    """(2, 168, 62): all N_id_1 sequences for sf 0 and 5."""
    out = np.zeros((2, 168, 62), np.float32)
    for sf_i, sf in enumerate((0, 5)):
        for nid1 in range(168):
            out[sf_i, nid1] = sss_sequence_np(nid1, n_id_2, sf)
    return out


def put_sss_grid(grid: np.ndarray, n_id_1: int, n_id_2: int, sf_idx: int, nof_prb: int, symbol: int):
    d = sss_sequence_np(n_id_1, n_id_2, sf_idx)
    nre = nof_prb * 12
    k0 = nre // 2 - 31
    grid[symbol, k0 : k0 + 62] = d
    return grid


def sss_detect(sss_re, n_id_2, ce=None):
    """Detect N_id_1 and frame half from a received SSS symbol.

    sss_re: (..., 62) complex — the 62 SSS subcarriers (channel-compensated
    if `ce` is None, else raw with `ce` (..., 62) the channel estimate from
    the adjacent PSS symbol).
    n_id_2: static int (hypothesis matrix selection).
    Returns (n_id_1 (...,), sf_is_5 (...,) bool, metric (...,)).
    """
    if ce is not None:
        sss_re = sss_re * jnp.conj(ce) / (jnp.abs(ce) ** 2 + 1e-9)
    h = jnp.asarray(sss_hypothesis_matrix(int(n_id_2)))  # (2,168,62)
    # coherent correlation: real part of <rx, d> (d is real ±1)
    corr = jnp.einsum("...k,snk->...sn", sss_re, h.astype(jnp.complex64))
    metric = jnp.abs(corr)
    flat = metric.reshape(metric.shape[:-2] + (-1,))
    arg = jnp.argmax(flat, axis=-1)
    n_id_1 = arg % 168
    sf_is_5 = (arg // 168).astype(bool)
    peak = jnp.take_along_axis(flat, arg[..., None], axis=-1)[..., 0]
    return n_id_1, sf_is_5, peak / (jnp.mean(flat, axis=-1) + 1e-12)
