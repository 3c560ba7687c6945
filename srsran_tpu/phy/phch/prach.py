"""PRACH: preamble generation and detection, TS 36.211 §5.7.

Re-design of `lib/src/phy/phch/prach.c`: Zadoff-Chu roots in logical order
(spec tables in `prach_data.py`), preambles as cyclic shifts of N_cs, 839-
subcarrier mapping at 1.25 kHz, time-domain generation by zero-padded IFFT
(`prach.c:531-568`); detection by frequency-domain conjugate multiply +
length-839 IDFT and per-zone peak search (`prach.c:581-621`).

Design: detection for ALL 64 preambles of a config is one batched
(n_roots, 839) x (839, 839) DFT-matrix matmul + per-zone segmented max —
no per-preamble loop.  Format 0 only for round 1 (the FDD default).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..common import Cell
from .prach_data import NCS_UNRESTRICTED, ZC_ROOT_ORDER

NZC = 839
DELTA_F_RA = 1250.0  # PRACH subcarrier spacing [Hz]
TSEQ_S = 24576 / 30.72e6  # format 0 sequence duration (800 us)
TCP_S = 3168 / 30.72e6  # format 0 CP (103.13 us)


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    root_seq_index: int = 0  # RACH_ROOT_SEQUENCE (logical)
    zero_corr_zone: int = 1  # zeroCorrelationZoneConfig (unrestricted)
    freq_offset: int = 0  # prach-FrequencyOffset (PRB)
    nof_preambles: int = 64

    @property
    def n_cs(self) -> int:
        return NCS_UNRESTRICTED[self.zero_corr_zone]


@lru_cache(maxsize=64)
def _roots_and_shifts(cfg: PrachConfig):
    """Physical roots + per-preamble (root_idx, shift) for 64 preambles."""
    n_cs = cfg.n_cs
    shifts_per_root = NZC // n_cs if n_cs > 0 else 1
    pre = []
    roots = []
    logical = cfg.root_seq_index
    while len(pre) < cfg.nof_preambles:
        u = ZC_ROOT_ORDER[logical % 838]
        roots.append(u)
        for v in range(shifts_per_root):
            if len(pre) >= cfg.nof_preambles:
                break
            pre.append((len(roots) - 1, v * n_cs))
        logical += 1
    return tuple(roots), tuple(pre)


@lru_cache(maxsize=256)
def zc_freq_np(u: int) -> np.ndarray:
    """DFT of the root ZC sequence (closed form: ZC is self-DFT up to
    conjugation/scaling; we just FFT numerically)."""
    n = np.arange(NZC)
    x = np.exp(-1j * np.pi * u * n * (n + 1) / NZC)
    return np.fft.fft(x).astype(np.complex64) / np.sqrt(NZC)


def prach_nfft(cell: Cell) -> int:
    """Time samples of the 800 us sequence at the cell sample rate."""
    return int(round(cell.srate * TSEQ_S))


def prach_cp_len(cell: Cell) -> int:
    return int(round(cell.srate * TCP_S))


@lru_cache(maxsize=64)
def _freq_map(cell: Cell, cfg: PrachConfig) -> np.ndarray:
    """Indices of the 839 PRACH bins inside the length-prach_nfft FFT.

    PRACH occupies 6 PRB starting at freq_offset: center of that block,
    1.25 kHz spacing → bin k of the big FFT = (k0*12*12 + ...) computed in
    1.25 kHz units: big-FFT bin spacing = srate/nfft = 1250 Hz exactly
    (nfft = 0.8 ms * srate).  First PRACH subcarrier sits 7.5 kHz + PRB
    offset above the grid edge (prach.c K*delta placement, simplified).
    """
    nfft = prach_nfft(cell)
    k_0 = cfg.freq_offset * 12 - cell.nof_prb * 6  # in 15 kHz units, from DC
    k0_ra = int(k_0 * 12 + 7)  # 1.25 kHz units: K*k0 + phi, phi=7 (fmt 0-3)
    bins = (k0_ra + np.arange(NZC)) % nfft
    return bins.astype(np.int32)


def prach_generate_np(cell: Cell, cfg: PrachConfig, preamble_idx: int) -> np.ndarray:
    """Time-domain preamble (CP + sequence) at the cell sample rate."""
    roots, pre = _roots_and_shifts(cfg)
    root_i, shift = pre[preamble_idx]
    u = roots[root_i]
    n = np.arange(NZC)
    x = np.exp(-1j * np.pi * u * ((n + shift) % NZC) * (((n + shift) % NZC) + 1) / NZC)
    xf = np.fft.fft(x) / np.sqrt(NZC)
    nfft = prach_nfft(cell)
    grid = np.zeros(nfft, np.complex64)
    grid[_freq_map(cell, cfg)] = xf.astype(np.complex64)
    seq = np.fft.ifft(grid) * np.sqrt(nfft)
    cp = prach_cp_len(cell)
    return np.concatenate([seq[-cp:], seq]).astype(np.complex64)


@lru_cache(maxsize=64)
def _idft839() -> np.ndarray:
    n = np.arange(NZC)
    return (np.exp(2j * np.pi * np.outer(n, n) / NZC) / np.sqrt(NZC)).astype(np.complex64)


@lru_cache(maxsize=64)
def _detect_fn(cell: Cell, cfg: PrachConfig):
    """Cached jitted detector for one (cell, cfg): FFT → root conjugate
    multiply → 839-point IDFT matmul → one (64, n_cs) zone gather +
    segmented max.  All 64 preamble zones are extracted with a single
    precomputed index matrix (no per-preamble Python loop — the eager
    version cost ~170 ms/call on the host control path)."""
    import jax

    nfft = prach_nfft(cell)
    fmap = _freq_map(cell, cfg)
    roots, pre = _roots_and_shifts(cfg)
    rootmat = np.stack([np.conj(zc_freq_np(u)) for u in roots])  # (R, 839)
    n_cs = cfg.n_cs
    # a preamble with cyclic shift s and propagation delay d (ZC-sample
    # units) peaks at profile index m = (d - s) mod NZC, so preamble v's
    # zone is [NZC-s, NZC-s+Ncs) with delay = m - (NZC-s).
    root_idx = np.array([r for r, _ in pre], np.int32)  # (64,)
    zone_idx = np.stack(
        [((NZC - s) % NZC + np.arange(n_cs)) % NZC for _, s in pre]
    ).astype(np.int32)  # (64, n_cs)

    @jax.jit
    def fn(samples, threshold):
        x = samples[..., :nfft]
        xf = jnp.fft.fft(x, axis=-1)[..., fmap]
        prod = xf[..., None, :] * rootmat  # (..., R, 839)
        prof = jnp.abs(jnp.matmul(prod, _idft839())) ** 2  # (..., R, 839)
        mean_p = jnp.mean(prof, axis=-1)  # (..., R)
        zprof = prof[..., root_idx[:, None], zone_idx]  # (..., 64, n_cs)
        metric = jnp.max(zprof, axis=-1) / mean_p[..., root_idx]
        delay = jnp.argmax(zprof, axis=-1).astype(jnp.int32)
        return metric, delay, metric > threshold

    return fn


def prach_detect(cell: Cell, cfg: PrachConfig, samples, threshold: float = 15.0):
    """Detect preambles in a window starting at the PRACH sequence.

    samples: (..., >= nfft) time samples (CP already skipped).
    Returns (metric (..., 64), delay_samples (..., 64), detected (..., 64));
    metric = zone peak power / global mean power per root.
    """
    return _detect_fn(cell, cfg)(jnp.asarray(samples), threshold)
