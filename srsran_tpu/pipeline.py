"""Fully-jittable subframe pipelines and multi-carrier sharding.

This is the batched analog of the reference's app PHY workers
(`srsue/src/phy/cc_worker.cc` per-carrier processing): instead of one thread
per carrier, carriers are a **batch/shard axis** of one compiled program.

`ue_dl_subframe(cell, sf_idx, cfi, grant)` builds a pure function
``samples (nrx, sf_len) -> (tb_bits, crc_ok, snr)`` covering
OFDM demod → CRS channel estimation → equalize → demod → descramble →
de-rate-match → turbo decode → CRC, entirely under jit.

`multi_carrier_ue_dl(...)` vmaps it over a leading carrier axis and shards
the carrier axis over a `jax.sharding.Mesh` — the SURVEY §2.6 "carrier
parallelism" mapping (one cc_worker per carrier → shard axis).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .phy.common import Cell
from .phy.chest.chest_dl import chest_dl
from .phy.mimo import (
    layerdemap,
    predecode_diversity2,
    predecode_single_mrc,
    predecode_zf_mmse,
)
from .phy.modem import demod_soft
from .phy.ofdm import OfdmConfig, ofdm_rx_sf, ofdm_tx_sf
from .phy.phch.pdsch import DlGrant, DlGrant2, pdsch_cinit, pdsch_re_indices
from .phy.phch.sch import TbCoding, dlsch_decode_device, dlsch_decode_multi_device
from .phy.scrambling import scramble_soft
from .phy.sequence import gold_sequence_signs


def ue_dl_subframe(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant, max_iterations: int = 5):
    """Build the jittable UE DL subframe decode function.

    Returns fn(samples (nrx, sf_len) complex64) ->
      (tb_bits (tbs,) uint8, crc_ok bool, snr_db float32)
    """
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    n_re = len(idx)
    nof_layers = grant.nof_layers if grant.tx_scheme == "spatialmux" else 1
    g = n_re * grant.qm * nof_layers
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv, nof_layers=nof_layers)
    signs = gold_sequence_signs(pdsch_cinit(grant.rnti, sf_idx, cell.id), g)
    nof_ports = 2 if grant.tx_scheme in ("diversity", "spatialmux") else 1

    def fn(samples):
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (nrx, nsymb, nre)
        res = chest_dl(rx_grid, cell, sf_idx, nof_ports=nof_ports)
        noise = jnp.mean(res["noise"])
        ce = res["ce"]
        y = rx_grid.reshape(rx_grid.shape[0], -1)[:, jnp.asarray(idx)]
        h = ce.reshape(ce.shape[0], ce.shape[1], -1)[:, :, jnp.asarray(idx)]
        if grant.tx_scheme == "port0":
            x, csi = predecode_single_mrc(y, h[:, 0], noise)
        elif grant.tx_scheme == "diversity":
            x, csi = predecode_diversity2(y, h)
        elif grant.tx_scheme == "spatialmux":
            xl, csil = predecode_zf_mmse(y, h, grant.nof_layers, noise, pmi=grant.pmi)
            x = layerdemap(xl, 1)[0]
            csi = layerdemap(csil.astype(jnp.complex64), 1)[0].real
        else:
            raise NotImplementedError(grant.tx_scheme)
        llr = demod_soft(grant.mod, x)
        llr = llr * jnp.repeat(csi, grant.qm, axis=-1)
        llr = scramble_soft(llr, signs)
        tb, ok = dlsch_decode_device(llr, coding, max_iterations)
        snr_db = 10.0 * jnp.log10(jnp.mean(res["snr"]))
        return tb, ok, snr_db

    return fn


def ue_dl_subframe_mimo(
    cell: Cell, sf_idx: int, cfi: int, grant: DlGrant2, max_iterations: int = 5
):
    """Jittable 2x2 spatial-multiplexing (TM3/TM4) subframe decode — the
    reference's 150 Mbps headline config (README.md:47).

    Returns fn(samples (2, sf_len) complex64) ->
      ((tb1, ok1), (tb2, ok2), snr_db)
    """
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    n_re = len(idx)
    signs = [
        gold_sequence_signs(
            pdsch_cinit(grant.rnti, sf_idx, cell.id, q=q), n_re * qm
        )
        for q, qm in ((0, grant.qm1), (1, grant.qm2))
    ]
    codings = [
        TbCoding(tbs=grant.tbs1, g=n_re * grant.qm1, qm=grant.qm1, rv=grant.rv1, nof_layers=1),
        TbCoding(tbs=grant.tbs2, g=n_re * grant.qm2, qm=grant.qm2, rv=grant.rv2, nof_layers=1),
    ]

    def fn(samples):
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (2 rx, nsymb, nre)
        res = chest_dl(rx_grid, cell, sf_idx, nof_ports=2)
        noise = jnp.mean(res["noise"])
        y = rx_grid.reshape(rx_grid.shape[0], -1)[:, jnp.asarray(idx)]
        h = res["ce"].reshape(2, 2, -1)[:, :, jnp.asarray(idx)]
        x, csi = predecode_zf_mmse(y, h, 2, noise, pmi=grant.pmi)
        sym_cws = layerdemap(x, 2)
        csi_cws = layerdemap(csi.astype(jnp.complex64), 2)
        llrs = []
        for q, (mod, qm) in enumerate(((grant.mod1, grant.qm1), (grant.mod2, grant.qm2))):
            llr = demod_soft(mod, sym_cws[q])
            llr = llr * jnp.repeat(csi_cws[q].real, qm, axis=-1)
            llrs.append(scramble_soft(llr, signs[q]))
        # both codewords' CBs decode in ONE batched turbo call per distinct
        # K (dlsch_decode_multi_device) — not per-codeword chains
        outs = dlsch_decode_multi_device(llrs, codings, max_iterations)
        snr_db = 10.0 * jnp.log10(jnp.mean(res["snr"]))
        return outs[0], outs[1], snr_db

    return fn


def enb_ul_subframe(cell: Cell, sf_idx: int, grant, max_iterations: int = 5):
    """Jittable eNB UL PUSCH subframe decode — the reference's 50 Mbps UL
    headline (README.md:67): SC-FDMA demod (-0.5 subcarrier shift) → DMRS
    chest → MRC equalize → DFT de-precode → demod → de-interleave →
    UL-SCH turbo decode.

    Returns fn(samples (nrx, sf_len) complex64) -> (tb_bits, crc_ok, snr_db)
    """
    from .phy.chest.chest_ul import chest_ul
    from .phy.dft_precoding import dft_predecode
    from .phy.phch.pusch import (
        _interleaver_indices,
        pusch_cinit,
        pusch_symbols_data,
    )

    ofdm = OfdmConfig.from_cell(cell, normalize=True, freq_shift_f=-0.5)
    m_sc = 12 * grant.nof_prb
    k0 = grant.prb_start * 12
    data_syms = pusch_symbols_data(cell)
    g = len(data_syms) * m_sc * grant.qm
    coding = TbCoding(tbs=grant.tbs, g=g, qm=grant.qm, rv=grant.rv)
    signs = gold_sequence_signs(pusch_cinit(grant.rnti, sf_idx, cell.id), g)
    deint_idx = jnp.asarray(_interleaver_indices(g, grant.qm))

    def fn(samples):
        rx_grid = ofdm_rx_sf(ofdm, samples)  # (nrx, nsymb, nre)
        ce, noise = chest_ul(rx_grid, cell, grant.prb_start, grant.nof_prb)
        noise = jnp.mean(noise)
        y = rx_grid[..., jnp.asarray(data_syms), k0 : k0 + m_sc]
        h = ce[..., jnp.asarray(data_syms), :]
        xf, csi = predecode_single_mrc(
            y.reshape(y.shape[0], -1), h.reshape(h.shape[0], -1), noise
        )
        xf = xf.reshape(len(data_syms), m_sc)
        csi = csi.reshape(len(data_syms), m_sc)
        x = dft_predecode(xf)
        llr = demod_soft(grant.mod, x.reshape(-1))
        csi_t = jnp.repeat(jnp.mean(csi, axis=-1, keepdims=True), m_sc, axis=-1)
        llr = llr * jnp.repeat(csi_t.reshape(-1), grant.qm)
        llr = scramble_soft(llr, signs)
        deint = jnp.zeros_like(llr).at[deint_idx].set(llr)
        tb, ok = dlsch_decode_device(deint, coding, max_iterations)
        sig = jnp.mean(jnp.abs(ce) ** 2)
        snr_db = 10.0 * jnp.log10(sig / (noise + 1e-12))
        return tb, ok, snr_db

    return fn


def multi_carrier_ue_dl(
    cell: Cell,
    sf_idx: int,
    cfi: int,
    grant: DlGrant,
    mesh: Mesh | None = None,
    axis: str = "carriers",
    max_iterations: int = 5,
):
    """Vmapped + mesh-sharded carrier pipeline.

    Returns fn(samples (n_carriers, nrx, sf_len)) ->
      (tb (n_carriers, tbs), ok (n_carriers,), total_ok ())
    With a mesh, the carrier axis is sharded and `total_ok` is a cross-chip
    psum-style reduction (a collective between devices).
    """
    single = ue_dl_subframe(cell, sf_idx, cfi, grant, max_iterations)

    def all_carriers(samples):
        tb, ok, snr = jax.vmap(single)(samples)
        return tb, ok, jnp.sum(ok.astype(jnp.int32))

    if mesh is None:
        return jax.jit(all_carriers)
    in_sharding = NamedSharding(mesh, P(axis, None, None))
    out_sharding = (
        NamedSharding(mesh, P(axis, None)),
        NamedSharding(mesh, P(axis)),
        NamedSharding(mesh, P()),
    )
    return jax.jit(all_carriers, in_shardings=in_sharding, out_shardings=out_sharding)


def enb_dl_subframe_encode(cell: Cell, sf_idx: int, cfi: int, grant: DlGrant):
    """Jittable eNB DL data-subframe encoder — the reference's 75 Mbps DL
    headline config (README.md:66) as DEVICE code: CRC24A (+ per-CB
    CRC24B) as GF(2) matmuls → batched windowed turbo ENCODER
    (`turbo_encode_device`: lw + nw sequential steps instead of K) →
    rate-match gathers → scramble → modulate → PDSCH RE scatter → CRS
    overlay → batched IFFT.  The reference encodes serially per CB on the
    host CPU (`sch.c:351 encode_tb`).

    Returns fn(tb_bits (tbs,) uint8) -> samples (nports, sf_len) complex64.
    """
    from .phy.common import LTE_CRC24A, LTE_CRC24B
    from .phy.crc import crc_matrix_np
    from .phy.chest.refsignal_dl import put_crs_np
    from .phy.fec.rate_match import turbo_rm_indices
    from .phy.fec.turbo import turbo_encode_device
    from .phy.modem import modulate
    from .phy.phch.sch import _e_split
    from .phy.fec.cbsegm import cbsegm
    from .phy.scrambling import scramble_bits
    from .phy.sequence import gold_sequence

    assert grant.tx_scheme == "port0", "bench encoder: SISO path"
    idx = pdsch_re_indices(cell, sf_idx, cfi, grant.prb)
    n_re = len(idx)
    g = n_re * grant.qm
    segm = cbsegm(grant.tbs)
    es = _e_split(g, segm.C, grant.qm, 1)
    ka = segm.cb_sizes[0]
    assert all(kk == ka for kk in segm.cb_sizes), "equal-K batch (bench TBS)"
    tbl_a = jnp.asarray(crc_matrix_np(LTE_CRC24A, grant.tbs).astype(np.float32))
    tbl_b = jnp.asarray(crc_matrix_np(LTE_CRC24B, ka - 24).astype(np.float32))
    rm_idx = [jnp.asarray(turbo_rm_indices(ka, es[i], grant.rv,
                                           segm.F if i == 0 else 0))
              for i in range(segm.C)]
    seq = jnp.asarray(np.asarray(
        gold_sequence(pdsch_cinit(grant.rnti, sf_idx, cell.id), g)).astype(np.uint8))
    # grid template with CRS (+ empty control region) precomputed
    tmpl = np.zeros((max(cell.nof_ports, 1), cell.nsymb_per_sf,
                     cell.nof_re_per_symbol), np.complex64)
    put_crs_np(tmpl, cell, sf_idx)
    tmpl_ri = jnp.asarray(np.stack([tmpl.real, tmpl.imag], -1))
    ofdm = OfdmConfig.from_cell(cell, normalize=True)

    def crc_bits(x, table):
        acc = jnp.matmul(x.astype(jnp.float32), table,
                         preferred_element_type=jnp.float32)
        return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)

    def fn(tb_bits):
        b = jnp.concatenate([tb_bits.astype(jnp.uint8),
                             crc_bits(tb_bits, tbl_a)])
        # segment (+ filler zeros on CB 0, + CRC24B per CB when C > 1)
        cbs = []
        pos = 0
        for i in range(segm.C):
            f = segm.F if i == 0 else 0
            take = ka - f - (24 if segm.C > 1 else 0)
            cb = jnp.concatenate([jnp.zeros((f,), jnp.uint8), b[pos : pos + take]])
            pos += take
            if segm.C > 1:
                cb = jnp.concatenate([cb, crc_bits(cb, tbl_b)])
            cbs.append(cb)
        d = turbo_encode_device(jnp.stack(cbs), ka)  # (C, 3, ka+4)
        flat = d.reshape(segm.C, -1)
        e = jnp.concatenate([flat[i][rm_idx[i]] for i in range(segm.C)])
        scr = e ^ seq
        sym = modulate(grant.mod, scr)
        grid_ri = tmpl_ri.reshape(tmpl.shape[0], -1, 2)
        sym_ri = jnp.stack([jnp.real(sym), jnp.imag(sym)], -1)
        grid_ri = grid_ri.at[0, jnp.asarray(idx)].set(sym_ri)
        grid = (grid_ri[..., 0] + 1j * grid_ri[..., 1]).reshape(tmpl.shape)
        return ofdm_tx_sf(ofdm, grid)

    return fn
