"""MIMO: layer mapping, precoding, and ZF/MMSE predecoding, TS 36.211 §6.3.3-4.

Functional re-design of `lib/src/phy/mimo/{layermap,precoding}.c`:

* layer map/demap for 1-4 layers, 1-2 codewords (`layermap.h:40-70`)
* precoding: single port, 2-port transmit diversity (SFBC/Alamouti,
  TS 36.211 §6.3.4.3), 2-port spatial multiplexing with the TS 36.211
  Table 6.3.4.2.3-1 codebook (+ CDD for TM3)
* predecoding: MRC for single layer, SFBC combining, and batched ZF/MMSE
  (`precoding.c:847-1177`) — expressed as closed-form 2x2 complex solves,
  elementwise over the RE axis (vectorized; no per-RE loops), with the
  CSI output used for LLR weighting just like the reference.

Shape conventions (RE-last, batch-first):
  symbols  (..., nof_re)                 one codeword's modulated symbols
  layers   (..., nof_layers, nof_re)
  ports    (..., nof_ports, nof_re)
  channel  (..., nof_rx, nof_ports, nof_re)  estimated H per RE
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SQRT2_INV = np.float32(1.0 / np.sqrt(2.0))


# --- layer mapping (TS 36.211 Table 6.3.3.2-1) ------------------------------


def layermap(codewords: list, nof_layers: int):
    """List of per-codeword symbol arrays → (..., nof_layers, M_layer)."""
    n_cw = len(codewords)
    if n_cw == 1:
        x = codewords[0]
        m = x.shape[-1] // nof_layers
        return x.reshape(x.shape[:-1] + (m, nof_layers)).swapaxes(-1, -2)
    if n_cw == 2:
        per_cw = (nof_layers // 2, nof_layers - nof_layers // 2)
        outs = []
        for cw, nl in zip(codewords, per_cw):
            m = cw.shape[-1] // nl
            outs.append(cw.reshape(cw.shape[:-1] + (m, nl)).swapaxes(-1, -2))
        return jnp.concatenate(outs, axis=-2)
    raise ValueError("1 or 2 codewords")


def layerdemap(layers, nof_codewords: int):
    """(..., nof_layers, M) → list of codeword arrays (inverse of layermap)."""
    nof_layers = layers.shape[-2]
    if nof_codewords == 1:
        x = layers.swapaxes(-1, -2)
        return [x.reshape(x.shape[:-2] + (-1,))]
    n0 = nof_layers // 2
    parts = (layers[..., :n0, :], layers[..., n0:, :])
    outs = []
    for p in parts:
        x = p.swapaxes(-1, -2)
        outs.append(x.reshape(x.shape[:-2] + (-1,)))
    return outs


# --- precoding ---------------------------------------------------------------


def precode_single(layers):
    """(..., 1, M) → (..., 1, M): single antenna port, identity."""
    return layers


def precode_diversity2(symbols):
    """SFBC for 2 ports: (..., M) codeword symbols → (..., 2, M).

    TS 36.211 §6.3.4.3 / `precoding.c` tx diversity: per symbol pair
    (x0, x1): port0 transmits (x0, x1)/sqrt(2), port1 (-x1*, x0*)/sqrt(2).
    """
    m = symbols.shape[-1]
    x = symbols.reshape(symbols.shape[:-1] + (m // 2, 2))
    x0, x1 = x[..., 0], x[..., 1]
    p0 = jnp.stack([x0, x1], axis=-1).reshape(symbols.shape) * SQRT2_INV
    p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(symbols.shape) * SQRT2_INV
    return jnp.stack([p0, p1], axis=-2)


# 2-port spatial-multiplexing codebook, TS 36.211 Table 6.3.4.2.3-1
# index 0: 1/sqrt(2) [[1,0],[0,1]]; 1: 1/2 [[1,1],[1,-1]]; 2: 1/2 [[1,1],[j,-j]]
def _codebook_2x2(pmi: int, nof_layers: int) -> np.ndarray:
    if nof_layers == 1:
        vecs = {
            0: np.array([1, 1]),
            1: np.array([1, -1]),
            2: np.array([1, 1j]),
            3: np.array([1, -1j]),
        }[pmi]
        return (vecs / np.sqrt(2.0)).reshape(2, 1).astype(np.complex64)
    mats = {
        0: np.array([[1, 0], [0, 1]]) / np.sqrt(2.0),
        1: np.array([[1, 1], [1, -1]]) / 2.0,
        2: np.array([[1, 1], [1j, -1j]]) / 2.0,
    }[pmi]
    return mats.astype(np.complex64)


def precode_cdd2(layers):
    """Large-delay CDD for 2 layers / 2 ports (TM3), TS 36.211 §6.3.4.2.2.

    y = W * D(i) * U * x with W = I/sqrt(2), alternating phase on layer 2.
    """
    m = layers.shape[-1]
    u = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    x = jnp.einsum("lk,...km->...lm", jnp.asarray(u), layers)
    # D(i) = diag(1, e^{-j*2*pi*i/2}) = diag(1, (-1)^i)
    signs = jnp.asarray(np.where(np.arange(m) % 2 == 0, 1.0, -1.0), jnp.complex64)
    x = x.at[..., 1, :].multiply(signs)
    return x * SQRT2_INV


def precode_spatialmux(layers, pmi: int):
    """Closed-loop spatial multiplexing (TM4), 2 ports."""
    nl = layers.shape[-2]
    w = jnp.asarray(_codebook_2x2(pmi, nl))
    return jnp.einsum("pl,...lm->...pm", w, layers)


# --- predecoding (equalization) ----------------------------------------------


def predecode_single_mrc(y, h, noise_est=0.0):
    """MRC: y (..., nrx, M), h (..., nrx, M) → (x_hat, csi) each (..., M).

    Matches `srslte_predecoding_single` (precoding.c): x = h^H y / (|h|^2+n).
    """
    hh = jnp.sum(jnp.abs(h) ** 2, axis=-2) + noise_est
    x = jnp.sum(jnp.conj(h) * y, axis=-2) / hh
    return x, hh


def predecode_diversity2(y, h):
    """SFBC combining: y (..., nrx, M), h (..., nrx, 2, M) → symbols (..., M).

    Alamouti combining per RE pair, inverse of `precode_diversity2`.
    """
    m = y.shape[-1]
    shp = y.shape[:-1] + (m // 2, 2)
    yp = y.reshape(shp)  # (..., nrx, M/2, 2)
    h0 = h[..., 0, :].reshape(shp)
    h1 = h[..., 1, :].reshape(shp)
    # channel assumed constant over the pair: use first RE's estimate average
    h0p = (h0[..., 0] + h0[..., 1]) * 0.5
    h1p = (h1[..., 0] + h1[..., 1]) * 0.5
    y0, y1 = yp[..., 0], yp[..., 1]
    hh = jnp.abs(h0p) ** 2 + jnp.abs(h1p) ** 2 + 1e-12
    x0 = jnp.conj(h0p) * y0 + h1p * jnp.conj(y1)
    x1 = jnp.conj(h0p) * y1 - h1p * jnp.conj(y0)
    # sum over rx antennas
    x0 = jnp.sum(x0, axis=-2)
    x1 = jnp.sum(x1, axis=-2)
    csi = jnp.sum(hh, axis=-2)
    scale = np.float32(np.sqrt(2.0)) / csi
    x = jnp.stack([x0 * scale, x1 * scale], axis=-1).reshape(y.shape[:-2] + (m,))
    csi_full = jnp.repeat(csi, 2, axis=-1)
    return x, csi_full


def select_pmi(h, nof_layers: int, noise_est=1e-3):
    """PMI selection for 2-port closed loop (ref precoding.h:113-120,
    srslte_precoding_pmi_select): evaluate the post-equalization SINR proxy
    for every codebook entry in one batched computation, return
    (best_pmi, per_pmi_capacity, condition_number_db).

    h: (..., nrx, 2, M) channel estimates over the REs of interest.
    """
    n_pmi = 4 if nof_layers == 1 else 3
    caps = []
    for pmi in range(n_pmi):
        w = jnp.asarray(_codebook_2x2(pmi, nof_layers))
        heff = jnp.einsum("...rpm,pl->...rlm", h, w)
        if nof_layers == 1:
            g = jnp.sum(jnp.abs(heff[..., 0, :]) ** 2, axis=-2)  # (..., M)
            sinr = g / noise_est
            caps.append(jnp.mean(jnp.log2(1.0 + sinr), axis=-1))
        else:
            hc = jnp.conj(heff)
            a00 = jnp.sum(jnp.abs(heff[..., 0, :]) ** 2, axis=-2) + noise_est
            a11 = jnp.sum(jnp.abs(heff[..., 1, :]) ** 2, axis=-2) + noise_est
            a01 = jnp.sum(hc[..., 0, :] * heff[..., 1, :], axis=-2)
            det = jnp.real(a00 * a11) - jnp.abs(a01) ** 2
            sinr0 = det / (a11 * noise_est)
            sinr1 = det / (a00 * noise_est)
            caps.append(
                jnp.mean(jnp.log2(1.0 + sinr0) + jnp.log2(1.0 + sinr1), axis=-1)
            )
    cap = jnp.stack(caps, axis=-1)
    best = jnp.argmax(cap, axis=-1)
    # condition number (dB) of the Gram matrix, averaged over REs
    hc = jnp.conj(h)
    # Gram over rx antennas: h is (..., nrx, ports, M); select port then sum rx
    g00 = jnp.sum(jnp.abs(h[..., 0, :]) ** 2, axis=-2)
    g11 = jnp.sum(jnp.abs(h[..., 1, :]) ** 2, axis=-2)
    g01 = jnp.abs(jnp.sum(hc[..., 0, :] * h[..., 1, :], axis=-2))
    tr = g00 + g11
    d = jnp.sqrt(jnp.maximum((g00 - g11) ** 2 + 4 * g01**2, 0.0))
    lam_max = (tr + d) / 2
    lam_min = jnp.maximum((tr - d) / 2, 1e-12)
    cond_db = 10.0 * jnp.log10(jnp.mean(lam_max / lam_min, axis=-1))
    return best, cap, cond_db


def _solve2x2(a00, a01, a10, a11, b0, b1):
    det = a00 * a11 - a01 * a10
    inv_det = 1.0 / det
    x0 = (a11 * b0 - a01 * b1) * inv_det
    x1 = (a00 * b1 - a10 * b0) * inv_det
    return x0, x1


def predecode_zf_mmse(y, h, nof_layers: int, noise_est=0.0, pmi: int | None = None):
    """ZF (noise_est=0) / MMSE equalizer for 1-2 layers over 2 TX ports.

    y (..., nrx, M); h (..., nrx, nports, M).  If `pmi` is given the codebook
    precoder is folded into H (closed-loop TM4).  Returns (x_hat, csi) with
    x_hat (..., nof_layers, M).  Mirrors `srslte_predecoding_type` with
    SRSLTE_MIMO_DECODER_MMSE (`precoding.c:847-1177`).
    """
    if pmi is not None:
        w = jnp.asarray(_codebook_2x2(pmi, nof_layers))
        h = jnp.einsum("...rpm,pl->...rlm", h, w)
    if nof_layers == 1:
        heff = h[..., 0, :] if h.shape[-2] == 1 else h.sum(axis=-2)
        x, csi = predecode_single_mrc(y, heff, noise_est)
        return x[..., None, :], csi[..., None, :]

    # Gram matrix A = H^H H + sigma2 I per RE (2x2), b = H^H y
    hc = jnp.conj(h)
    a00 = jnp.sum(hc[..., :, 0, :] * h[..., :, 0, :], axis=-2) + noise_est
    a11 = jnp.sum(hc[..., :, 1, :] * h[..., :, 1, :], axis=-2) + noise_est
    a01 = jnp.sum(hc[..., :, 0, :] * h[..., :, 1, :], axis=-2)
    a10 = jnp.conj(a01)
    b0 = jnp.sum(hc[..., :, 0, :] * y, axis=-2)
    b1 = jnp.sum(hc[..., :, 1, :] * y, axis=-2)
    x0, x1 = _solve2x2(a00, a01, a10, a11, b0, b1)
    x = jnp.stack([x0, x1], axis=-2)
    # CSI: diagonal of the equalized SNR proxy (reference uses 1/diag(A^-1))
    det = a00 * a11 - a01 * a10
    csi0 = jnp.real(det / a11)
    csi1 = jnp.real(det / a00)
    csi = jnp.stack([csi0, csi1], axis=-2)
    return x, csi


def precode_diversity4(symbols):
    """SFBC-FSTD for 4 ports (TS 36.211 §6.3.4.3, precoding.c tx-div 4):
    (..., M) with M % 4 == 0 → (..., 4, M).

    Per group of 4 symbols (x0..x3) over 4 REs: ports (0,2) carry the
    Alamouti pair of (x0,x1) on REs 0-1; ports (1,3) carry (x2,x3) on
    REs 2-3; the other ports are zero on those REs.
    """
    m = symbols.shape[-1]
    x = symbols.reshape(symbols.shape[:-1] + (m // 4, 4))
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    z = jnp.zeros_like(x0)
    p0 = jnp.stack([x0, x1, z, z], axis=-1)
    p1 = jnp.stack([z, z, x2, x3], axis=-1)
    p2 = jnp.stack([-jnp.conj(x1), jnp.conj(x0), z, z], axis=-1)
    p3 = jnp.stack([z, z, -jnp.conj(x3), jnp.conj(x2)], axis=-1)
    out = jnp.stack([p0, p1, p2, p3], axis=-3) * SQRT2_INV
    return out.reshape(symbols.shape[:-1] + (4, m))


def predecode_diversity4(y, h):
    """SFBC-FSTD receiver: y (nrx, M), h (nrx, 4, M) → (x (M,), csi (M,))."""
    m = y.shape[-1]
    yg = y.reshape(y.shape[:-1] + (m // 4, 4))
    hg = h.reshape(h.shape[:-2] + (4, m // 4, 4))
    out_pairs = []
    csi_pairs = []
    for pair, (pa, pb) in ((0, (0, 2)), (1, (1, 3))):
        y0 = yg[..., 2 * pair]
        y1 = yg[..., 2 * pair + 1]
        h0 = hg[..., pa, :, 2 * pair]
        h1 = hg[..., pb, :, 2 * pair]
        gain = jnp.sum(jnp.abs(h0) ** 2 + jnp.abs(h1) ** 2, axis=0)
        xa = jnp.sum(jnp.conj(h0) * y0 + h1 * jnp.conj(y1), axis=0) / (gain + 1e-12)
        xb = jnp.sum(jnp.conj(h0) * y1 - h1 * jnp.conj(y0), axis=0) / (gain + 1e-12)
        out_pairs.append((xa, xb))
        csi_pairs.append(gain)
    x = jnp.stack(
        [out_pairs[0][0], out_pairs[0][1], out_pairs[1][0], out_pairs[1][1]], axis=-1
    ).reshape(m) * np.sqrt(2.0)
    csi = jnp.stack(
        [csi_pairs[0], csi_pairs[0], csi_pairs[1], csi_pairs[1]], axis=-1
    ).reshape(m)
    return x.astype(jnp.complex64), csi


def predecode_cdd2(y, h, noise_est=0.0):
    """TM3 open-loop (large-delay CDD) receiver: fold W·D(i)·U into H per
    RE parity, then the 2x2 MMSE solve. y (nrx, M), h (nrx, 2, M) →
    (layers (2, M), csi (2, M))."""
    m = y.shape[-1]
    u = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2.0)
    signs = jnp.asarray(np.where(np.arange(m) % 2 == 0, 1.0, -1.0), jnp.complex64)
    # effective precoder per RE: P(i) = (1/sqrt2) * diag(1, (-1)^i) applied
    # after U; fold into H: heff[:, l, :] = sum_k h[:, k, :] * M_kl(i)
    # with M(i) = (1/sqrt2) * D(i) @ U acting on layers
    d_row0 = jnp.asarray(u[0]) * SQRT2_INV  # port row applied to layers
    d_row1 = jnp.asarray(u[1]) * SQRT2_INV
    heff_l0 = h[..., 0, :] * d_row0[0] + h[..., 1, :] * d_row1[0] * signs
    heff_l1 = h[..., 0, :] * d_row0[1] + h[..., 1, :] * d_row1[1] * signs
    heff = jnp.stack([heff_l0, heff_l1], axis=-2)
    return predecode_zf_mmse(y, heff, 2, noise_est, pmi=None)


# --- 4-port codebook spatial multiplexing (TM3/TM4 on 4 antenna ports) -------

_U4 = None


def _codebook_4(idx: int, nof_layers: int) -> np.ndarray:
    """4-port precoder W_n^{(cols)} (TS 36.211 Table 6.3.4.2.3-2;
    reference precoding.c:847-1177 4-port paths).

    W_n = I - 2 u_n u_n^H / (u_n^H u_n); the rank-r precoder takes the
    table's column set of W_n scaled by 1/sqrt(r).  Returns (4, r).
    """
    global _U4
    if _U4 is None:
        s2 = 1.0 / np.sqrt(2.0)
        _U4 = np.array([
            [1, -1, -1, -1],
            [1, -1j, 1, 1j],
            [1, 1, -1, 1],
            [1, 1j, 1, -1j],
            [1, (-1 - 1j) * s2, -1j, (1 - 1j) * s2],
            [1, (1 - 1j) * s2, 1j, (-1 - 1j) * s2],
            [1, (1 + 1j) * s2, -1j, (-1 + 1j) * s2],
            [1, (-1 + 1j) * s2, 1j, (1 + 1j) * s2],
            [1, -1, 1, 1],
            [1, -1j, -1, -1j],
            [1, 1, 1, -1],
            [1, 1j, -1, 1j],
            [1, -1, -1, 1],
            [1, -1, 1, -1],
            [1, 1, -1, -1],
            [1, 1, 1, 1],
        ], np.complex64)
    # column sets (1-based, Table 6.3.4.2.3-2)
    cols_r2 = ["14", "12", "12", "12", "14", "14", "13", "13",
               "12", "14", "13", "13", "12", "13", "13", "12"]
    cols_r3 = ["124", "123", "123", "123", "124", "124", "134", "134",
               "124", "134", "123", "134", "123", "123", "123", "123"]
    cols_r4 = ["1234", "1234", "3214", "3214", "1234", "1234", "1324", "1324",
               "1234", "1234", "1324", "1324", "1234", "1324", "3214", "1234"]
    u = _U4[idx].reshape(4, 1)
    w = np.eye(4, dtype=np.complex64) - 2.0 * (u @ u.conj().T) / float((u.conj().T @ u).real)
    if nof_layers == 1:
        cols = [0]
    else:
        table = {2: cols_r2, 3: cols_r3, 4: cols_r4}[nof_layers]
        cols = [int(c) - 1 for c in table[idx]]
    return (w[:, cols] / np.sqrt(nof_layers)).astype(np.complex64)


def precode_spatialmux4(layers, codebook_idx: int):
    """Closed-loop spatial multiplexing on 4 ports: layers (..., L, M) →
    ports (..., 4, M)."""
    nl = layers.shape[-2]
    w = jnp.asarray(_codebook_4(codebook_idx, nl))
    return jnp.einsum("pl,...lm->...pm", w, layers)


def predecode_mmse_nl(y, heff, noise_est=0.0):
    """Generic N-layer MMSE predecode: y (..., nrx, M),
    heff (..., nrx, L, M) effective channel (precoder folded in).
    Returns (x (..., L, M), csi (..., L, M)) — the NxN generalization of
    `_solve2x2` (reference's generic MMSE, precoding.c srslte_predecoding
    _multiplex N-layer path)."""
    L = heff.shape[-2]
    hm = jnp.moveaxis(heff, -1, -3)  # (..., M, nrx, L)
    ym = jnp.moveaxis(y, -1, -2)[..., None]  # (..., M, nrx, 1)
    a = jnp.einsum("...mrl,...mrk->...mlk", jnp.conj(hm), hm)
    a = a + noise_est * jnp.eye(L, dtype=a.dtype)
    b = jnp.einsum("...mrl,...mro->...mlo", jnp.conj(hm), ym)  # (..., M, L, 1)
    x = jnp.linalg.solve(a, b)[..., 0]  # (..., M, L)
    # csi from the diagonal of A^-1: post-MMSE SNR proxy 1/[A^-1]_ll
    ainv = jnp.linalg.inv(a)
    csi = 1.0 / jnp.maximum(jnp.real(jnp.diagonal(ainv, axis1=-2, axis2=-1)), 1e-12)
    return jnp.moveaxis(x, -1, -2), jnp.moveaxis(csi, -1, -2)


def predecode_spatialmux4(y, h, nof_layers: int, codebook_idx: int, noise_est=0.0):
    """4-port codebook receiver: fold W into H, N-layer MMSE.
    y (..., nrx, M); h (..., nrx, 4, M)."""
    w = jnp.asarray(_codebook_4(codebook_idx, nof_layers))
    heff = jnp.einsum("...rpm,pl->...rlm", h, w)
    return predecode_mmse_nl(y, heff, noise_est)
