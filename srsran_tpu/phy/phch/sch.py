"""DL-SCH / UL-SCH transport-block coding chain, TS 36.212 §5.3.2.

Re-design of `lib/src/phy/phch/sch.c` (`encode_tb` :351, `decode_tb` :503):
TB CRC24A → segmentation (+ per-CB CRC24B when C>1, filler bits) → turbo
code → rate matching with per-CB E split → concatenation.

Batched shape: codeblocks of equal size decode as ONE batched turbo decode; the
per-CB loop of the reference (`decode_tb_cb` sch.c:363-487) becomes a batch
axis.  Filler bits are pinned with strong LLRs on the decoder side (the
known-bits trick, mirroring the reference's NULL handling).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..common import LTE_CRC24A, LTE_CRC24B
from ..crc import crc_attach_np, crc_check_np, crc_matrix_np
from ..fec.cbsegm import CbSegm, cbsegm
from ..fec.rate_match import turbo_rate_match_rx, turbo_rate_match_tx
from ..fec.turbo import turbo_decode, turbo_encode_np

FILLER_LLR = np.float32(-1e4)  # filler bits are known 0 (LLR>0 ⇒ 1)


def _e_split(g: int, c: int, qm: int, nof_layers: int = 1) -> list[int]:
    """Per-codeblock rate-matching output sizes (TS 36.212 §5.1.4.1.2)."""
    g_prime = g // (nof_layers * qm)
    gamma = g_prime % c
    e_minus = nof_layers * qm * (g_prime // c)
    e_plus = nof_layers * qm * int(np.ceil(g_prime / c))
    return [e_minus if i <= c - 1 - gamma else e_plus for i in range(c)]


@dataclasses.dataclass(frozen=True)
class TbCoding:
    """Static coding layout for one transport block."""

    tbs: int
    g: int  # total bits available on the channel
    qm: int  # modulation order (2/4/6/8)
    rv: int = 0
    nof_layers: int = 1

    @property
    def segm(self) -> CbSegm:
        return cbsegm(self.tbs)

    def e_sizes(self) -> list[int]:
        return _e_split(self.g, self.segm.C, self.qm, self.nof_layers)


def dlsch_encode_np(tb_bits: np.ndarray, cfg: TbCoding) -> np.ndarray:
    """Host encoder: TB bits (tbs,) → codeword bits (g,). For tests/tx."""
    s = cfg.segm
    assert len(tb_bits) == cfg.tbs
    b = crc_attach_np(tb_bits.astype(np.uint8), LTE_CRC24A)
    # segment
    cbs = []
    pos = 0
    for i, k in enumerate(s.cb_sizes):
        f = s.F if i == 0 else 0
        take = k - f - (24 if s.C > 1 else 0)
        cb = b[pos : pos + take]
        pos += take
        if s.C > 1:
            cb = crc_attach_np(np.concatenate([np.zeros(f, np.uint8), cb]), LTE_CRC24B)
        else:
            cb = np.concatenate([np.zeros(f, np.uint8), cb])
        cbs.append(cb)
    assert pos == len(b)
    # encode + rate match
    es = cfg.e_sizes()
    out = []
    for i, cb in enumerate(cbs):
        d = turbo_encode_np(cb).astype(np.float32)
        f = s.F if i == 0 else 0
        e = np.asarray(turbo_rate_match_tx(d, es[i], cfg.rv, n_filler=f))
        out.append(e.astype(np.uint8))
    return np.concatenate(out)


def dlsch_decode_multi_device(llrs, cfgs, max_iterations: int = 5):
    """Fully-jittable decode of ≥1 codewords JOINTLY.

    llrs: list of codeword LLR vectors (g_i,); cfgs: matching TbCoding list.
    Returns [(tb_bits, ok)] per codeword.

    All codeblocks of all codewords merge into ONE batched turbo decode per
    distinct (K, crc-poly) — for a 2-codeword TM3/TM4 subframe that is
    typically 1-2 sequential turbo calls instead of the 4-6 the previous
    per-(K, E, F)-group form made (e− and e+ CBs of the same K decode
    together since rate matching is per-CB static anyway).  The reference
    decodes every CB serially (`sch.c:363-487 decode_tb_cb`).
    """
    # (cw, cb index, k, e, f, codeword offset, crc_poly)
    entries = []
    for ci, cfg in enumerate(cfgs):
        s = cfg.segm
        es = cfg.e_sizes()
        offs = np.concatenate([[0], np.cumsum(es)])
        poly = LTE_CRC24B if s.C > 1 else LTE_CRC24A
        for i, k in enumerate(s.cb_sizes):
            f = s.F if i == 0 else 0
            entries.append((ci, i, k, es[i], f, int(offs[i]), poly))

    groups: dict[tuple[int, int], list[tuple]] = {}
    for ent in entries:
        groups.setdefault((ent[2], ent[6]), []).append(ent)

    decoded: dict[tuple[int, int], jnp.ndarray] = {}
    ok: dict[tuple[int, int], jnp.ndarray] = {}
    for (k, poly), ents in groups.items():
        rows = []
        for (ci, i, _k, e, f, off, _p) in ents:
            d = turbo_rate_match_rx(
                llrs[ci][off : off + e], k, cfgs[ci].rv, n_filler=f)
            if f:
                d = d.at[0, :f].set(FILLER_LLR)
            rows.append(d)
        d_llr = jnp.stack(rows)
        table = jnp.asarray(crc_matrix_np(poly, k).astype(np.float32))
        bits, _post, _n_it = turbo_decode(
            d_llr, k, max_iterations, crc_table=table)
        acc = jnp.matmul(
            bits.astype(jnp.float32), table, preferred_element_type=jnp.float32
        )
        cb_ok = jnp.all((acc.astype(jnp.int32) & 1) == 0, axis=-1)
        for j, (ci, i, *_rest) in enumerate(ents):
            decoded[(ci, i)] = bits[j]
            ok[(ci, i)] = cb_ok[j]

    out = []
    for ci, cfg in enumerate(cfgs):
        s = cfg.segm
        parts = []
        for i, k in enumerate(s.cb_sizes):
            f = s.F if i == 0 else 0
            parts.append(decoded[(ci, i)][f : k - (24 if s.C > 1 else 0)])
        b = jnp.concatenate(parts)
        tb = b[: cfg.tbs]
        tb_table = jnp.asarray(
            crc_matrix_np(LTE_CRC24A, cfg.tbs).astype(np.float32))
        crc_calc = (
            jnp.matmul(tb.astype(jnp.float32), tb_table,
                       preferred_element_type=jnp.float32).astype(jnp.int32)
            & 1
        ).astype(jnp.uint8)
        tb_ok = jnp.all(crc_calc == b[cfg.tbs :].astype(jnp.uint8))
        cw_ok = jnp.all(jnp.stack([ok[(ci, i)] for i in range(s.C)]))
        out.append((tb, jnp.logical_and(tb_ok, cw_ok)))
    return out


def dlsch_decode_device(llr, cfg: TbCoding, max_iterations: int = 5):
    """Fully-jittable TB decode: codeword LLRs (g,) → (tb_bits (tbs,), ok).

    Same chain as `dlsch_decode` but with the CRC checks and desegmentation
    done on device, so a whole subframe/carrier pipeline can live under one
    `jax.jit` and be sharded with `shard_map` (no host sync per TB).
    """
    return dlsch_decode_multi_device([llr], [cfg], max_iterations)[0]


def dlsch_decode(llr, cfg: TbCoding, max_iterations: int = 5, softbuffers=None):
    """Decode one TB from codeword LLRs (g,) float32 (positive ⇒ bit 1).

    Returns (tb_bits (tbs,) uint8 numpy, crc_ok bool, softbuffers).
    `softbuffers`: optional list of (3, K+4) arrays per CB for HARQ.

    Note: this is a host-orchestrated function (python loop over the ≤2
    distinct CB-size groups); the heavy work (de-rate-match + batched turbo
    decode + CRC) is jitted device code.
    """
    s = cfg.segm
    es = cfg.e_sizes()
    offsets = np.concatenate([[0], np.cumsum(es)])
    assert offsets[-1] == cfg.g

    # group codeblocks by (K, E, F) for batched decode
    groups: dict[tuple[int, int, int], list[int]] = {}
    for i, k in enumerate(s.cb_sizes):
        f = s.F if i == 0 else 0
        groups.setdefault((k, es[i], f), []).append(i)

    new_softbuffers = [None] * s.C
    decoded = [None] * s.C
    ok = [False] * s.C
    for (k, e, f), idxs in groups.items():
        batch = jnp.stack([llr[offsets[i] : offsets[i] + e] for i in idxs])
        if softbuffers is not None and softbuffers[idxs[0]] is not None:
            sb = jnp.stack([softbuffers[i] for i in idxs])
        else:
            sb = None
        d_llr = turbo_rate_match_rx(batch, k, cfg.rv, softbuffer=sb, n_filler=f)
        if f:
            d_llr = d_llr.at[:, 0, :f].set(FILLER_LLR)
        crc_poly = LTE_CRC24B if s.C > 1 else LTE_CRC24A
        table = jnp.asarray(crc_matrix_np(crc_poly, k).astype(np.float32))
        bits, post, n_it = turbo_decode(d_llr, k, max_iterations, crc_table=table)
        bits = np.asarray(bits)
        for j, i in enumerate(idxs):
            new_softbuffers[i] = d_llr[j]
            decoded[i] = bits[j]
            ok[i] = crc_check_np(bits[j], crc_poly)

    # desegment
    parts = []
    for i, k in enumerate(s.cb_sizes):
        f = s.F if i == 0 else 0
        cb = decoded[i][f : k - (24 if s.C > 1 else 0)]
        parts.append(cb)
    b = np.concatenate(parts)
    tb, crc = b[:-24], b[-24:]
    tb_ok = all(ok) and crc_check_np(b, LTE_CRC24A)
    return tb.astype(np.uint8), bool(tb_ok), new_softbuffers
