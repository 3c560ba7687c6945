"""Adaptive Wiener DL channel estimator (role of `wiener_dl.c`).

The reference's SRSLTE_ESTIMATOR_ALG_WIENER measures the channel's
frequency autocorrelation online from LS pilot estimates (random 2-PRB
subbands into FIFOs, FFT low-pass, 8x8 matrix inverse per update —
wiener_dl.c:546-751) and filters pilots through the resulting Wiener
matrices.  This is the batched redesign of the same idea:

- state is an explicit pytree (EMA of the 3-RE-lag autocorrelation),
  not FIFOs — functional and jit/scan-friendly;
- the autocorrelation is measured at 3-subcarrier resolution by
  interleaving the two CRS shifts (v, v+3) of each slot, the same
  trick as the reference's `hlsv` interleave (wiener_dl.c:613-620);
- the power-delay profile comes from one DFT of the symmetrized
  autocorrelation (the reference's fft→filter→ifft smoothing,
  wiener_dl.c:664-667, becomes a clamp to non-negative delay power);
- the full-band Wiener matrix W = R_dp (R_pp + n I)^-1 is ONE
  `jnp.linalg.inv` + matmul per subframe instead of
  per-subband 8x8 inverses.

Use `wiener_init()` once, then `chest_dl_adaptive(...)` per subframe,
threading the returned state.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..common import Cell
from .chest_dl import ChestDlConfig, _time_interp_matrix
from .refsignal_dl import crs_positions, crs_sequence_port

DEFAULT_NLAGS = 32  # autocorrelation lags kept (in units of 3 subcarriers)


def wiener_init(nlags: int = DEFAULT_NLAGS) -> dict:
    """Fresh estimator state.  `r3[m]` is the EMA of the channel
    frequency autocorrelation at a lag of 3*m subcarriers; r3[0]=1
    (flat prior) so the first subframes behave like the averaging
    estimator until adaptation kicks in."""
    r3 = jnp.zeros(nlags, jnp.complex64).at[0].set(1.0)
    return {"r3": r3, "count": jnp.zeros((), jnp.float32)}


def _measure_r3(ls: jnp.ndarray, v_first: bool, nlags: int) -> jnp.ndarray:
    """Autocorrelation of the channel across frequency at 3-RE lags.

    ls: (..., 4, npil) LS estimates on the port-0/1 CRS layout (symbol
    shifts alternate v, v+3).  Interleaves each slot's symbol pair into
    a 3-RE-spaced vector (..., 2, 2*npil) and correlates."""
    s0 = ls[..., 0::2, :]  # shift v   (..., 2, npil)
    s1 = ls[..., 1::2, :]  # shift v+3
    pair = (s0, s1) if v_first else (s1, s0)
    h3 = jnp.stack(pair, axis=-1).reshape(*ls.shape[:-2], 2, -1)  # (..., 2, K)
    k = h3.shape[-1]
    idx = np.arange(k)[None, :] + np.arange(nlags)[:, None]  # (nlags, K)
    valid = (idx < k).astype(np.float32)
    shifted = h3[..., None, :].take(jnp.asarray(idx.clip(max=k - 1)), axis=-1)
    prod = jnp.conj(h3)[..., None, :] * shifted[..., 0, :, :] * jnp.asarray(valid)
    r3 = prod.sum(axis=tuple(range(prod.ndim - 2)) + (-1,)) / (
        valid.sum(-1) * np.prod(ls.shape[:-2]) * 2 + 1e-9
    )
    return (r3 / jnp.maximum(jnp.abs(r3[0]), 1e-12)).astype(jnp.complex64)


def _pdp(r3: jnp.ndarray) -> jnp.ndarray:
    """Delay-power profile: one DFT of the tapered, symmetrized
    autocorrelation, clamped to non-negative power and renormalized to
    r(0) (the reference's fft->filter->ifft smoothing, wiener_dl.c:
    664-667).  A Hann taper over lags keeps leakage sidelobes from
    surviving the clamp as phantom delay power."""
    nlags = r3.shape[0]
    n = 2 * nlags - 1
    m = np.arange(-(nlags - 1), nlags)
    taper = np.cos(np.pi * np.abs(m) / (2 * nlags)) ** 2
    r_sym = jnp.concatenate([jnp.conj(r3[:0:-1]), r3]) * jnp.asarray(taper)
    analysis = jnp.asarray(np.exp(2j * np.pi * np.outer(m, np.arange(n)) / n) / n,
                           jnp.complex64)
    pdp = jnp.maximum(jnp.real(r_sym @ analysis), 0.0)  # (n,)
    return pdp * jnp.abs(r3[0]) / jnp.maximum(pdp.sum(), 1e-12)


def _delay_bins(nlags: int) -> np.ndarray:
    """Signed delay values per PDP bin: the top half of the DFT grid is
    NEGATIVE delay (timing skew).  At integer lags the two readings agree
    (aliasing is exact); at fractional RE lags only the signed form
    extrapolates correctly."""
    n = 2 * nlags - 1
    d = np.arange(n)
    return np.where(d < n / 2, d, d - n)


def _basis(pos: np.ndarray, nlags: int) -> jnp.ndarray:
    """Synthesis basis E[i,d] = exp(-j*2*pi*pos_i*d/(3n)) so that any
    correlation submatrix factors as r(pos_a - pos_b) = (E_a*pdp) E_b^H —
    keeps the Wiener build at O(len*n) instead of materializing lag
    matrices per RE x pilot pair."""
    n = 2 * nlags - 1
    return jnp.asarray(
        np.exp(-2j * np.pi * np.outer(pos / 3.0, _delay_bins(nlags)) / n), jnp.complex64
    )


def wiener_adapt(state: dict, ls: jnp.ndarray, v_first: bool = True,
                 alpha: float = 0.25) -> dict:
    """EMA-update the state from this subframe's LS pilot estimates."""
    r3_new = _measure_r3(ls, v_first, state["r3"].shape[0])
    count = state["count"]
    a = jnp.maximum(alpha, 1.0 / (count + 1.0))  # fast initial convergence
    return {"r3": ((1 - a) * state["r3"] + a * r3_new).astype(jnp.complex64),
            "count": count + 1.0}


def chest_dl_adaptive(grid, cell: Cell, sf_idx: int, state: dict,
                      cfg: ChestDlConfig = ChestDlConfig(),
                      nof_ports: int | None = None):
    """Like `chest_dl.chest_dl`, but frequency filtering uses Wiener
    matrices built from the runtime-adapted autocorrelation in `state`.
    Returns (result_dict, new_state)."""
    nof_ports = nof_ports or min(cell.nof_ports, 2)
    nre = cell.nof_re_per_symbol
    k = np.arange(nre, dtype=np.float64)
    ces, noises, rsrps, lss = [], [], [], []
    port_tabs = []
    for p in range(nof_ports):
        syms, freqs = crs_positions(cell, p)
        seq = crs_sequence_port(cell, sf_idx, p)
        port_tabs.append((syms, freqs, seq))
        pilots = grid[..., jnp.asarray(syms)[:, None], jnp.asarray(freqs)]
        ls = pilots * jnp.asarray(np.conj(seq))
        lss.append(ls)
        resid = ls[..., 1:-1] - 0.5 * (ls[..., 2:] + ls[..., :-2])
        noises.append(jnp.mean(jnp.abs(resid) ** 2, axis=(-1, -2)) / 1.5)
        rsrps.append(jnp.mean(jnp.abs(ls) ** 2, axis=(-1, -2)))

    # The [-1/2, 1, -1/2] residual contains channel curvature as well as
    # noise; the adapted autocorrelation lets us subtract it:
    # E|resid|^2 = 1.5*noise + (1.5 - 2*Re r(6) + 0.5*Re r(12)) * signal.
    pdp_prev = _pdp(state["r3"]).astype(jnp.complex64)
    e_c = _basis(np.array([0.0, 6.0, 12.0]), state["r3"].shape[0])
    r_c = jnp.real((e_c * pdp_prev).sum(-1))
    curv = jnp.maximum(1.5 * r_c[0] - 2.0 * r_c[1] + 0.5 * r_c[2], 0.0)
    rsrp_all = jnp.stack(rsrps)
    noises = [jnp.maximum(n - curv * r / 1.5, 0.02 * n)
              for n, r in zip(noises, rsrps)]

    # adapt on port 0 (reference averages cV over tx/rx — port 0's CRS
    # density is what sets the filter; others share the statistics)
    v0 = int(port_tabs[0][1][0][0])
    v1 = int(port_tabs[0][1][1][0])
    new_state = wiener_adapt(state, lss[0], v_first=v0 < v1)

    # Subband Wiener, the reference's estimate_wiener geometry
    # (wiener_dl.c:503-530): 8-pilot windows -> 48-RE edge bands + 24-RE
    # sliding center blocks.  Subbands keep every RE-pilot lag below the
    # delay-basis period (3*(2*nlags-1)/2 subcarriers), where the
    # synthesized correlation is valid; they also make the matrix build
    # one 8x8 inverse + three small matmuls, batched over blocks.
    nlags = new_state["r3"].shape[0]
    pdp = _pdp(new_state["r3"]).astype(jnp.complex64)
    nref = 8  # SRSLTE_WIENER_DL_MIN_REF
    e_p6 = _basis(np.arange(nref) * 6.0, nlags)
    r_pp = (e_p6 * pdp) @ e_p6.conj().T
    noise_rel = jnp.maximum(jnp.mean(jnp.stack(noises)) /
                            jnp.maximum(jnp.mean(jnp.stack(rsrps)), 1e-12), 1e-3)
    r_inv = jnp.linalg.inv(r_pp + noise_rel * jnp.eye(nref, dtype=jnp.complex64))

    def wiener_matrix(re_pos: np.ndarray, pil_pos: np.ndarray) -> jnp.ndarray:
        e_re, e_pil = _basis(re_pos, nlags), _basis(pil_pos, nlags)
        return ((e_re * pdp) @ e_pil.conj().T) @ r_inv

    npil = port_tabs[0][1].shape[1]
    nblk = max(0, (cell.nof_prb - 4) // 2)  # center 24-RE blocks
    blk_starts = 2 + 2 * np.arange(nblk)  # PRB index of each block
    pil_win = ((blk_starts - 1) * 2)[:, None] + np.arange(nref)  # (nblk, 8)

    for p in range(nof_ports):
        syms, freqs, _seq = port_tabs[p]
        wt = _time_interp_matrix(syms.astype(np.float64), cell.nsymb_per_sf, cfg.time_interp)
        per_sym = []
        for s in range(len(syms)):
            v = float(freqs[s][0])
            ls = lss[p][..., s, :].astype(jnp.complex64)
            # lower/upper 48-RE edge bands share one matrix (same lags)
            w_edge = wiener_matrix(np.arange(48.0), v + 6.0 * np.arange(nref))
            lower = jnp.einsum("np,...p->...n", w_edge, ls[..., :nref])
            upper = jnp.einsum("np,...p->...n", w_edge, ls[..., npil - nref:])
            h = jnp.zeros((*ls.shape[:-1], nre), jnp.complex64)
            h = h.at[..., :48].set(lower)
            h = h.at[..., nre - 48:].set(upper)
            if nblk:
                w_ctr = wiener_matrix(12.0 + np.arange(24.0), v + 6.0 * np.arange(nref))
                wins = ls[..., jnp.asarray(pil_win)]  # (..., nblk, 8)
                ctr = jnp.einsum("np,...bp->...bn", w_ctr, wins)
                ctr = ctr.reshape(*ls.shape[:-1], nblk * 24)
                h = h.at[..., 24:24 + nblk * 24].set(ctr)
            per_sym.append(h)
        per_sym = jnp.stack(per_sym, axis=-2)  # (..., nsym, nre)
        ces.append(jnp.einsum("ls,...sn->...ln", jnp.asarray(wt), per_sym))

    ce = jnp.stack(ces, axis=-3).astype(jnp.complex64)
    noise = jnp.stack(noises, axis=-1)
    rsrp = jnp.stack(rsrps, axis=-1)
    return dict(ce=ce, noise=noise, rsrp=rsrp,
                snr=rsrp / jnp.maximum(noise, 1e-12)), new_state
