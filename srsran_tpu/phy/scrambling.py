"""Scrambling: Gold-sequence XOR on bits / sign flip on LLRs and symbols.

Parity with `lib/src/phy/scrambling/scrambling.c` — here the sequence is a
precomputed array (see `sequence.py`), and descrambling soft values is an
elementwise multiply by (1-2c), fused by XLA into adjacent ops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np



def scramble_bits(bits, seq):
    """(bits + c) mod 2; shapes broadcast along the last axis."""
    return jnp.bitwise_xor(
        bits.astype(jnp.uint8), jnp.asarray(seq, jnp.uint8)
    )


def scramble_soft(values, seq_signs):
    """Apply (1-2c) signs to float LLRs or complex symbols."""
    return values * jnp.asarray(seq_signs)


def pdsch_cinit(rnti: int, q: int, sf_idx: int, cell_id: int) -> int:
    """c_init for PDSCH/PUSCH scrambling, TS 36.211 §6.3.1."""
    return (rnti << 14) + (q << 13) + ((2 * sf_idx) // 2 << 9) + cell_id


def pbch_cinit(cell_id: int) -> int:
    return cell_id
