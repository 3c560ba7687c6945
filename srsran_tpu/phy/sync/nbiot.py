"""NB-IoT synchronization signals: NPSS and NSSS, TS 36.211 §10.2.7
(re-design of `lib/src/phy/sync/npss.c` / `nsss.c`).

NB-IoT occupies one PRB (12 subcarriers, 180 kHz). NPSS: a length-11
Zadoff-Chu (root 5) on subcarriers 0-10 of OFDM symbols 3-13 in subframe
5 of every frame, with the per-symbol cover code S(l). NSSS: a
length-131 ZC (root from the cell id) with a binary scrambling b_q(m)
and phase rotation θ_f, on the last 11 symbols of subframe 9 of even
frames — conveying N_id_ncell (0..503) and the 80 ms frame position.

Detection is batched frequency-domain correlation (the same design as
the LTE PSS path): all roots/hypotheses correlated in one einsum.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)
NPSS_SYMS = 11  # symbols 3..13 of the subframe
NSSS_LEN = 131
NSSS_SYMS = 11


@lru_cache(maxsize=1)
def npss_freq_np() -> np.ndarray:
    """(11 symbols, 11 subcarriers) NPSS frequency-domain sequence."""
    u = 5
    n = np.arange(11)
    zc = np.exp(-1j * np.pi * u * n * (n + 1) / 11).astype(np.complex64)
    return NPSS_COVER[:, None] * zc[None, :]


def put_npss_grid(grid: np.ndarray):
    """Insert NPSS into a (14, 12) NB-IoT subframe grid (subframe 5)."""
    seq = npss_freq_np()
    for i in range(NPSS_SYMS):
        grid[3 + i, :11] = seq[i]
    return grid


@lru_cache(maxsize=512)
def nsss_sequence_np(n_id_ncell: int, frame4: int) -> np.ndarray:
    """NSSS d(n), n = 0..131 (TS 36.211 §10.2.7.2.1).

    frame4 = (nf/2) mod 4 selects the phase rotation θ_f.
    """
    u = n_id_ncell % 126 + 3
    q = n_id_ncell // 126
    n = np.arange(132)
    m = n % 128
    nn = n % NSSS_LEN
    # binary scrambling b_q(m): Hadamard-like sequences (the spec's table);
    # generated as rows of the 128-Walsh matrix indexed by q*32
    b = _walsh128()[q * 32][m]
    theta = 33.0 / 132.0 * frame4
    d = (
        b
        * np.exp(-2j * np.pi * theta * n)
        * np.exp(-1j * np.pi * u * nn * (nn + 1) / NSSS_LEN)
    )
    return d.astype(np.complex64)


@lru_cache(maxsize=1)
def _walsh128() -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < 128:
        h = np.block([[h, h], [h, -h]])
    return h.astype(np.float32)


def put_nsss_grid(grid: np.ndarray, n_id_ncell: int, frame4: int):
    """Insert NSSS into a (14, 12) grid (subframe 9, even frame)."""
    d = nsss_sequence_np(n_id_ncell, frame4)
    k = 0
    for l in range(14 - NSSS_SYMS, 14):
        grid[l, :12] = d[k : k + 12]
        k += 12
    return grid


def npss_correlate(grid_syms):
    """Correlate (nsf, 14, 12) candidate subframes against the NPSS.

    Returns (metric (nsf,), best_sf): normalized coherent correlation over
    the 11 NPSS symbols — peak at the true subframe-5 alignment.
    """
    seq = jnp.asarray(np.conj(npss_freq_np()))
    region = grid_syms[..., 3 : 3 + NPSS_SYMS, :11]
    corr = jnp.abs(jnp.sum(region * seq, axis=(-1, -2)))
    energy = jnp.sqrt(jnp.sum(jnp.abs(region) ** 2, axis=(-1, -2)) + 1e-12)
    metric = corr / (energy * np.sqrt(11.0 * 11.0))
    return metric, jnp.argmax(metric)


@lru_cache(maxsize=1)
def _nsss_hypothesis_matrix() -> np.ndarray:
    """(504*4, 132) conjugated NSSS hypotheses for one-shot detection."""
    rows = []
    for nid in range(504):
        for f4 in range(4):
            rows.append(np.conj(nsss_sequence_np(nid, f4)))
    return np.stack(rows)


def nsss_detect(grid):
    """Detect (n_id_ncell, frame4) from a (14, 12) subframe-9 grid.

    One 2016x132 hypothesis matmul (the §A.3 SSS-matmul design
    scaled to NB-IoT's full 504-cell space).
    """
    d_rx = jnp.concatenate(
        [grid[l, :12] for l in range(14 - NSSS_SYMS, 14)], axis=-1
    )  # (132,)
    hyp = jnp.asarray(_nsss_hypothesis_matrix())
    corr = jnp.abs(hyp @ d_rx)
    best = jnp.argmax(corr)
    return best // 4, best % 4, corr[best] / (jnp.linalg.norm(d_rx) * np.sqrt(132.0))


def nbiot_cell_search(sf_grids):
    """Anchor-carrier cell search over a stream of (nsf, 14, 12) subframe
    grids (the `ue_cell_search_nbiot.c` flow, grid domain): find the NPSS
    subframe phase, then detect (n_id_ncell, frame position) from the
    NSSS 4 subframes later (sf 9 of even frames).

    Returns (n_id_ncell, sf5_index, frame4, confidence) or None.
    """
    metric, best = npss_correlate(sf_grids)
    best = int(np.asarray(best))
    if float(np.asarray(metric[best])) < 0.5:
        return None
    nsss_idx = best + 4  # sf 9 of the same frame
    if nsss_idx >= sf_grids.shape[0]:
        nsss_idx = best - 6  # previous frame's sf 9 (even-frame caveat)
    if nsss_idx < 0:
        return None
    nid, f4, conf = nsss_detect(sf_grids[nsss_idx])
    if float(np.asarray(conf)) < 0.4:
        return None
    return int(np.asarray(nid)), best, int(np.asarray(f4)), float(np.asarray(conf))
