"""Extended cyclic prefix: control region, PHICH durations, PUCCH, and a
full-stack attach (reference regs.c:286,331-337).
"""

import numpy as np
import pytest

from srsran_tpu.phy.common import CP, Cell
from srsran_tpu.phy.phch.phich import (nof_phich_groups, nof_phich_sequences,
                                       phich_decode, phich_nsf, phich_put_np,
                                       phich_re_indices)
from srsran_tpu.phy.phch.regs import (build_regs, nof_phich_groups_true,
                                      pdcch_re_indices_true,
                                      phich_group_re_indices_true)


def test_ext_cp_reg_structure():
    """Extended CP: symbol 3 of a 4-symbol control region carries CRS →
    2 REGs there; group count doubles; group pairs split each REG."""
    cn = Cell(nof_prb=6, nof_ports=1, id=7)
    ce = Cell(nof_prb=6, nof_ports=1, id=7, cp=CP.EXT)
    rn = build_regs(cn)
    re_ = build_regs(ce)
    n_l3 = lambda r: len([x for x in r["regs"] if x["l"] == 3])
    assert n_l3(rn) == 3 * 6  # normal CP: no CRS at l=3
    assert n_l3(re_) == 2 * 6  # extended CP: CRS at l=3 (nsymb-3)
    assert nof_phich_groups_true(ce) == 2 * nof_phich_groups_true(cn)
    g0 = phich_group_re_indices_true(ce, 0)
    g1 = phich_group_re_indices_true(ce, 1)
    assert len(g0) == len(g1) == 6  # NSF 2: six REs per group
    assert not set(g0.tolist()) & set(g1.tolist())


def test_extended_phich_duration_mapping():
    """Extended PHICH duration: a group's three REGs land in symbols
    0, 1 and 2 (TS 36.211 §6.9.3; regs.c:331-337 li = i)."""
    c = Cell(nof_prb=15, nof_ports=1, id=7, phich_length=1)
    idx = phich_group_re_indices_true(c, 0)
    nre = c.nof_re_per_symbol
    assert sorted(set(idx // nre)) == [0, 1, 2]
    # PDCCH must not collide with any control channel
    pd = set(pdcch_re_indices_true(c, 3).tolist())
    assert not pd & set(idx.tolist())


@pytest.mark.parametrize("cell", [
    Cell(nof_prb=15, nof_ports=1, id=7, cp=CP.EXT),
    Cell(nof_prb=15, nof_ports=1, id=7, phich_length=1),
    Cell(nof_prb=15, nof_ports=1, id=7, cp=CP.EXT, phich_length=1),
])
def test_phich_roundtrip_variants(cell):
    """PHICH encode→decode across every (group, sequence) for extended
    CP (NSF 2) and extended duration."""
    rng = np.random.default_rng(1)
    nre = cell.nof_re_per_symbol
    for group in range(nof_phich_groups(cell)):
        for n_seq in range(nof_phich_sequences(cell)):
            for ack in (0, 1):
                grid = np.zeros((cell.nsymb_per_sf, nre), np.complex64)
                phich_put_np(grid, cell, 4, group, n_seq, ack)
                idx = phich_re_indices(cell, group)
                sym = grid[idx // nre, idx % nre]
                sym = sym + 0.05 * (rng.standard_normal(len(sym))
                                    + 1j * rng.standard_normal(len(sym)))
                hi, metric = phich_decode(sym.astype(np.complex64), cell, 4, n_seq)
                assert int(np.asarray(hi)) == ack


def test_pucch_ext_cp_roundtrips():
    """Formats 1a and 2 with the extended-CP slot structure."""
    from srsran_tpu.phy.phch.pucch import (PucchConfig,
                                           pucch_format1_decode,
                                           pucch_format1_encode_np,
                                           pucch_format2_decode,
                                           pucch_format2_encode_np)

    cell = Cell(nof_prb=15, nof_ports=1, id=7, cp=CP.EXT)
    rng = np.random.default_rng(2)
    for n_pucch in (0, 5, 11):
        cfg = PucchConfig(n_pucch=n_pucch)
        for bit in (0, 1):
            g = pucch_format1_encode_np(cell, cfg, 3, [bit])
            g = g + 0.05 * (rng.standard_normal(g.shape)
                            + 1j * rng.standard_normal(g.shape))
            bits, metric = pucch_format1_decode(
                np.asarray(g, np.complex64), cell, cfg, 3, 1)
            assert int(np.asarray(bits)[0]) == bit
            assert float(np.asarray(metric)) > 0.25
        cqi = rng.integers(0, 2, 4).astype(np.uint8)
        g = pucch_format2_encode_np(cell, cfg, 3, cqi)
        g = g + 0.05 * (rng.standard_normal(g.shape)
                        + 1j * rng.standard_normal(g.shape))
        bits, metric = pucch_format2_decode(
            np.asarray(g, np.complex64), cell, cfg, 3, 4)
        assert np.array_equal(np.asarray(bits), cqi)


def test_ext_cp_full_stack_attach_and_traffic():
    """Complete attach + bidirectional IP traffic on an extended-CP cell
    — control region, PBCH, PRACH, PUCCH, PHICH and the data chain all
    at 12-symbol subframes."""
    from srsran_tpu.apps.full_stack import EnbStack, UeStack
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    IMSI = "001010123456789"
    KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
    OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    cell = Cell(nof_prb=15, nof_ports=1, id=7, cp=CP.EXT)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5)
    ue = UeStack(cell, Usim(IMSI, KEY, OPC))
    ul = None
    for tti in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if (ue.rrc_state == UeStack.RRC_ACTIVE
                and ue.nas.state == ue.nas.REGISTERED):
            break
    assert ue.nas.state == ue.nas.REGISTERED
    pkts = [bytes([i]) * 60 for i in range(3)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for _ in range(40):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    up = [bytes([0x50 + i]) * 40 for i in range(2)]
    for p in up:
        ue.send_ip_packet(p)
    for _ in range(40):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(spgw.sgi_rx) >= len(up):
            break
    got = [pl for _, pl in spgw.sgi_rx]
    assert got[: len(up)] == up
