"""LTE CRC (24A/24B/16/8), TS 36.212 §5.1.1.

Parity with the reference table-driven CRC (`lib/src/phy/fec/crc.c`; polys at
`lib/include/srslte/phy/common/phy_common.h:71-74`), re-designed as a matmul:

CRC over GF(2) is linear, so for a fixed message length N the checksum is a
binary matrix product:  crc = bits @ M  (mod 2), where row i of M is
x^(N-1-i+L) mod g(x).  On device that is a single (B, N) x (N, L) matmul,
batchable across codeblocks, instead of a bit-serial loop.  The
matrix is precomputed on host and cached per (poly, N).

Convention: checksum bits are emitted MSB-first (coefficient of x^(L-1)
first), matching how the reference appends `checksum` bytes to the message.
"""

from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from .common import LTE_CRC8, LTE_CRC16, LTE_CRC24A, LTE_CRC24B

_ORDERS = {LTE_CRC24A: 24, LTE_CRC24B: 24, LTE_CRC16: 16, LTE_CRC8: 8}


def crc_order(poly: int) -> int:
    return _ORDERS[poly]


def _xpow_mod(poly: int, order: int, e: int) -> int:
    """x^e mod g(x) as an integer with bit k = coeff of x^k."""
    r = 1
    for _ in range(e):
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
    return r & ((1 << order) - 1)


@lru_cache(maxsize=512)
def crc_matrix_np(poly: int, length: int) -> np.ndarray:
    """(length, order) uint8 matrix M with crc = bits @ M mod 2 (MSB first)."""
    order = _ORDERS[poly]
    # incremental: contribution of bit i is x^(length-1-i+order) mod g.
    # compute highest power once then walk down by "dividing by x" — but
    # division is awkward; instead walk up from e=order for the LAST bit.
    m = np.zeros((length, order), dtype=np.uint8)
    r = _xpow_mod(poly, order, order)  # contribution of bit length-1
    for i in range(length - 1, -1, -1):
        # bits of r: coeff of x^k at bit k; row stores MSB first
        for j in range(order):
            m[i, j] = (r >> (order - 1 - j)) & 1
        # next (previous message bit) multiplies by x
        r <<= 1
        if (r >> order) & 1:
            r ^= poly
        r &= (1 << order) - 1
    return m


def crc_attach_np(bits: np.ndarray, poly: int) -> np.ndarray:
    """Host: append CRC to a {0,1} uint8 bit array."""
    m = crc_matrix_np(poly, len(bits))
    crc = (bits.astype(np.uint32) @ m.astype(np.uint32)) & 1
    return np.concatenate([bits.astype(np.uint8), crc.astype(np.uint8)])


def crc_compute_np(bits: np.ndarray, poly: int) -> np.ndarray:
    m = crc_matrix_np(poly, len(bits))
    return ((bits.astype(np.uint32) @ m.astype(np.uint32)) & 1).astype(np.uint8)


def crc_check_np(bits_with_crc: np.ndarray, poly: int) -> bool:
    """Host: True iff trailing CRC matches."""
    order = _ORDERS[poly]
    msg, crc = bits_with_crc[:-order], bits_with_crc[-order:]
    return bool(np.array_equal(crc_compute_np(msg, poly), crc.astype(np.uint8)))


# --- device-side -----------------------------------------------------------


def crc_compute(bits, poly: int):
    """CRC of {0,1} bits along the last axis; any leading batch dims.

    `bits` float32/int32 of shape (..., N).  Returns (..., order) uint8.
    The matmul accumulates exact small integers in float32 (N ≤ 6144 << 2^24).
    """
    n = bits.shape[-1]
    m = jnp.asarray(crc_matrix_np(poly, n), dtype=jnp.float32)
    acc = jnp.matmul(bits.astype(jnp.float32), m, preferred_element_type=jnp.float32)
    return (acc.astype(jnp.int32) & 1).astype(jnp.uint8)


def crc_ok(bits_with_crc, poly: int):
    """Vectorized check: (..., N+order) bits -> (...,) bool."""
    order = _ORDERS[poly]
    msg = bits_with_crc[..., :-order]
    crc = bits_with_crc[..., -order:].astype(jnp.uint8)
    return jnp.all(crc_compute(msg, poly) == crc, axis=-1)
