"""PBCH: MIB coding and (blind) decoding, TS 36.211 §6.6 / TS 36.212 §5.3.1.

Re-design of `lib/src/phy/phch/pbch.c` (decode at :444): 40-bit MIB+CRC16
(CRC masked by the antenna-port pattern), K=7 tail-biting conv code, rate
matched to 1920 bits (normal CP), scrambled over a 40 ms TTI, QPSK on the
central 6 PRB of slot-1 symbols 0-3 (4-port CRS positions always reserved).

Batched shape: the UE-side blind decode over {4 frame offsets} x {1,2,4 antenna
ports} runs as ONE batched Viterbi decode of 12 hypotheses, then a vector
CRC check — no serial retry loop.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from ..common import LTE_CRC16, Cell
from ..crc import crc_compute_np
from ..fec.conv import convcoder_encode_np, viterbi_decode
from ..fec.rate_match import conv_rate_match_rx, conv_rate_match_tx
from ..modem import Mod, demod_soft, modulate
from ..sequence import gold_sequence, gold_sequence_signs

PBCH_TTI_BITS = 1920  # normal CP, 40 ms
PBCH_FRAME_BITS = PBCH_TTI_BITS // 4  # 480
PBCH_SYMS_FRAME = PBCH_FRAME_BITS // 2  # 240 QPSK symbols

# TS 36.212 Table 5.3.1.1-1 CRC masks per nof tx antennas
CRC_MASKS = {1: [0] * 16, 2: [1] * 16, 4: [0, 1] * 8}


@dataclasses.dataclass
class Mib:
    nof_prb: int = 6
    phich_length: int = 0
    phich_resources: int = 1  # index 0..3 → 1/6, 1/2, 1, 2
    sfn: int = 0  # system frame number (full 10 bits; 8 MSBs in MIB)

    def pack(self) -> np.ndarray:
        bw = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}[self.nof_prb]
        bits = []
        bits += [(bw >> (2 - i)) & 1 for i in range(3)]
        bits += [self.phich_length & 1]
        bits += [(self.phich_resources >> (1 - i)) & 1 for i in range(2)]
        sfn8 = (self.sfn >> 2) & 0xFF
        bits += [(sfn8 >> (7 - i)) & 1 for i in range(8)]
        bits += [0] * 10
        return np.array(bits, np.uint8)

    @classmethod
    def unpack(cls, bits: np.ndarray) -> "Mib":
        bw = int("".join(map(str, bits[:3])), 2)
        nof_prb = {0: 6, 1: 15, 2: 25, 3: 50, 4: 75, 5: 100}[bw]
        phich_len = int(bits[3])
        phich_res = int("".join(map(str, bits[4:6])), 2)
        sfn8 = int("".join(map(str, bits[6:14])), 2)
        return cls(nof_prb, phich_len, phich_res, sfn8 << 2)


@lru_cache(maxsize=128)
def pbch_re_indices(cell: Cell) -> np.ndarray:
    """Flat grid indices of the 240 PBCH REs (slot 1, symbols 0-3,
    central 72 subcarriers, skipping 4-port CRS positions in symbols 0-1)."""
    nre = cell.nof_re_per_symbol
    k0 = nre // 2 - 36
    vshift = cell.id % 6
    out = []
    for l in range(4):
        sym = cell.nsymb_per_slot + l
        ks = np.arange(k0, k0 + 72)
        if l < 2:
            keep = (ks % 3) != (vshift % 3)
            ks = ks[keep]
        out.append(sym * nre + ks)
    idx = np.concatenate(out).astype(np.int32)
    assert len(idx) == PBCH_SYMS_FRAME
    return idx


def pbch_encode_np(mib: Mib, cell: Cell, nof_ports: int) -> np.ndarray:
    """Encode the 40 ms PBCH TTI → (4, 240) QPSK symbols (one row/frame).

    Transmit row `(sfn % 4)` each radio frame.  Single-port signal (the
    caller applies tx diversity across ports if nof_ports > 1).
    """
    from ..fec.rate_match import conv_rm_indices

    bits = mib.pack()
    crc = crc_compute_np(bits, LTE_CRC16)
    crc ^= np.array(CRC_MASKS[nof_ports], np.uint8)
    b40 = np.concatenate([bits, crc])
    coded = convcoder_encode_np(b40)  # (3, 40)
    # pure numpy end to end: this runs once per FRAME on the stack's
    # control path, and a device modulate here is a sync round-trip
    e = coded.reshape(-1)[conv_rm_indices(coded.shape[-1],
                                          PBCH_TTI_BITS)].astype(np.uint8)
    seq = gold_sequence(cell.id, PBCH_TTI_BITS)
    scrambled = (e ^ seq).astype(np.uint8)
    s = (1.0 - 2.0 * scrambled.astype(np.float32)) * np.float32(
        1.0 / np.sqrt(2.0))
    sym = (s[0::2] + 1j * s[1::2]).astype(np.complex64)
    return sym.reshape(4, PBCH_SYMS_FRAME)


def pbch_decode(sym_eq, cell: Cell):
    """Blind MIB decode from ONE frame's 240 equalized PBCH symbols.

    sym_eq: (240,) complex equalized symbols.
    Tries 4 frame offsets x 3 port counts as a single batched Viterbi.
    Returns (mib_bits (24,) uint8, nof_ports int, frame_offset int, ok bool)
    — all numpy/python (host decision point, like pbch.c:444).
    """
    llr = np.asarray(demod_soft(Mod.QPSK, sym_eq))  # (480,)
    signs = gold_sequence_signs(cell.id, PBCH_TTI_BITS)
    hyp_llrs = []
    for off in range(4):
        full = np.zeros(PBCH_TTI_BITS, np.float32)
        full[off * PBCH_FRAME_BITS : (off + 1) * PBCH_FRAME_BITS] = llr
        full *= signs
        d = np.asarray(conv_rate_match_rx(jnp.asarray(full), 40))
        hyp_llrs.append(d)
    batch = jnp.asarray(np.stack(hyp_llrs))  # (4, 3, 40)
    bits = np.asarray(viterbi_decode(batch, 40))  # (4, 40)
    for off in range(4):
        b = bits[off]
        crc_rx = b[24:]
        crc_calc = crc_compute_np(b[:24], LTE_CRC16)
        for nports, mask in CRC_MASKS.items():
            if np.array_equal(crc_rx ^ np.array(mask, np.uint8), crc_calc):
                return b[:24], nports, off, True
    return bits[0][:24], 0, 0, False
