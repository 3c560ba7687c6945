"""UCI coding: Reed-Muller block codes for CQI/ACK, TS 36.212 §5.2.2.6 / §5.2.3.3.

Re-design of `lib/src/phy/phch/uci.c` / `cqi.c`: the (32, O) and (20, A)
codes are linear — encoding is a GF(2) matmul with the spec basis matrices,
decoding is ML over all 2^O codewords as ONE correlation matmul (O ≤ 11/13).
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from .uci_data import RM20_BASIS, RM32_BASIS


def rm_encode(bits: np.ndarray, n_out: int, basis=RM32_BASIS) -> np.ndarray:
    """Encode O ≤ width(b) bits → n_out bits (circular repetition)."""
    basis = np.asarray(basis, np.uint8)
    o = len(bits)
    cw = (basis[:, :o] @ np.asarray(bits, np.uint8)) % 2
    reps = -(-n_out // len(cw))
    return np.tile(cw, reps)[:n_out].astype(np.uint8)


@lru_cache(maxsize=32)
def _codebook(o: int, n_out: int, use20: bool) -> np.ndarray:
    """(2^o, n_out) ±1 codeword matrix for ML decoding."""
    basis = np.asarray(RM20_BASIS if use20 else RM32_BASIS, np.uint8)
    msgs = ((np.arange(2**o)[:, None] >> np.arange(o)[None, :]) & 1).astype(np.uint8)
    cw = (msgs @ basis[:, :o].T) % 2  # (2^o, 32|20)
    reps = -(-n_out // cw.shape[1])
    cw = np.tile(cw, (1, reps))[:, :n_out]
    return (1.0 - 2.0 * cw).astype(np.float32)


def rm_decode(llr, o: int, use20: bool = False):
    """ML decode (..., E) LLRs (positive ⇒ bit 1) → ((..., o) bits, metric).

    One matmul against the full codebook — a batched brute force over 2^O.
    """
    e = llr.shape[-1]
    book = jnp.asarray(_codebook(o, e, use20))  # (2^o, E) in ±1 (bit0→+1)
    # LLR>0 ⇒ bit 1 ⇒ soft value -LLR matches +1 for bit 0
    corr = jnp.einsum("...e,ce->...c", -llr, book)
    best = jnp.argmax(corr, axis=-1)
    bits = ((best[..., None] >> jnp.arange(o)) & 1).astype(jnp.uint8)
    metric = jnp.max(corr, axis=-1) / (jnp.sum(jnp.abs(llr), axis=-1) + 1e-9)
    return bits, metric


# ---------------------------------------------------------------------------
# Subband CQI reporting (cqi.c:41-118, TS 36.213 §7.2 / 36.212 §5.2.2.6)
# ---------------------------------------------------------------------------

# differential subband CQI offset level (TS 36.213 Table 7.2.1-2):
# field value -> (subband CQI - wideband CQI), value 3 encodes "<= -1"
CQI_DIFF_LEVEL = (0, 1, 2, -1)


def cqi_hl_subband_size(nof_prb: int) -> int:
    """Subband size k (TS 36.213 Table 7.2.1-3; cqi.c:608-621)."""
    if nof_prb < 7:
        return 0
    if nof_prb <= 26:
        return 4
    if nof_prb <= 63:
        return 6
    if nof_prb <= 110:
        return 8
    raise ValueError(nof_prb)


def cqi_hl_nof_subbands(nof_prb: int) -> int:
    """N, the higher-layer-configured subband count (cqi.c:626-634)."""
    k = cqi_hl_subband_size(nof_prb)
    return -(-nof_prb // k) if k else 0


def cqi_diff_encode(sb_cqi: int, wb_cqi: int) -> int:
    """Quantize (subband - wideband) to the Table 7.2.1-2 field value."""
    d = sb_cqi - wb_cqi
    if d <= -1:
        return 3
    return min(d, 2)


def cqi_hl_subband_pack(wb_cqi: int, sb_diffs) -> np.ndarray:
    """Higher-layer-configured subband report (aperiodic mode 3-0/3-1
    single codeword, no PMI): 4-bit wideband + N x 2-bit differential
    offsets (cqi.c:41-75, TS 36.212 Table 5.2.2.6.2-1)."""
    bits = [int(b) for b in np.binary_repr(wb_cqi, 4)]
    for d in sb_diffs:
        bits += [int(b) for b in np.binary_repr(int(d) & 3, 2)]
    return np.array(bits, np.uint8)


def cqi_hl_subband_unpack(bits, n: int) -> tuple[int, list[int]]:
    """-> (wideband_cqi, [per-subband CQI offsets as field values])."""
    bits = np.asarray(bits).astype(int)
    wb = int("".join(map(str, bits[:4])), 2)
    diffs = [int("".join(map(str, bits[4 + 2 * i: 6 + 2 * i])), 2)
             for i in range(n)]
    return wb, diffs


def cqi_ue_subband_pack(wb_cqi: int, sb_diff: int, label: int,
                        label_bits: int) -> np.ndarray:
    """UE-selected subband report (aperiodic mode 2-0/2-2): 4-bit
    wideband + 2-bit differential for the preferred subbands + L-bit
    position label (cqi.c:77-96, cqi.h:82-90)."""
    bits = [int(b) for b in np.binary_repr(wb_cqi, 4)]
    bits += [int(b) for b in np.binary_repr(int(sb_diff) & 3, 2)]
    if label_bits:
        bits += [int(b) for b in np.binary_repr(label, label_bits)]
    return np.array(bits, np.uint8)


def cqi_ue_subband_unpack(bits, label_bits: int):
    bits = np.asarray(bits).astype(int)
    wb = int("".join(map(str, bits[:4])), 2)
    diff = int("".join(map(str, bits[4:6])), 2)
    label = (int("".join(map(str, bits[6:6 + label_bits])), 2)
             if label_bits else 0)
    return wb, diff, label


def cqi_f2_subband_pack(sb_cqi: int, label: int,
                        label_2_bits: bool) -> np.ndarray:
    """PUCCH format-2 subband report of the periodic reporting cycle:
    4-bit subband CQI + 1/2-bit bandwidth-part label (cqi.c:113-118,
    cqi.h:110-118)."""
    bits = [int(b) for b in np.binary_repr(sb_cqi, 4)]
    bits += [int(b) for b in np.binary_repr(label, 2 if label_2_bits else 1)]
    return np.array(bits, np.uint8)


def cqi_f2_subband_unpack(bits, label_2_bits: bool):
    bits = np.asarray(bits).astype(int)
    nl = 2 if label_2_bits else 1
    return (int("".join(map(str, bits[:4])), 2),
            int("".join(map(str, bits[4:4 + nl])), 2))
