"""Golden-vector parity: decode the reference's captured I/Q test files
(vendored from lib/src/phy/phch/test/, the same captures its
pbch_file_test / pdsch_pdcch_file_test decode).

These are REAL eNodeB signals — passing them validates the whole receive
chain (OFDM, chest, PCFICH, the REG quadruplet interleaver, PDCCH blind
search with spec DCI sizes, SI-RNTI grant rules, PDSCH demap, rate
matching, turbo decode, CRC) against the air interface, not just against
our own transmitter.
"""

import os

import numpy as np
import pytest

from srsran_tpu.phy.common import Cell

VEC = os.path.join(os.path.dirname(__file__), "vectors")
SI_RNTI = 0xFFFF

# pbch_file_test.c expectation (bch_payload_file)
MIB_PAYLOAD = np.array(
    [0, 1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.uint8
)


def _load(name):
    return np.fromfile(os.path.join(VEC, name), np.complex64)


def test_pbch_file_mib():
    """signal.1.92M.dat: MIB decodes with 2 tx ports, SFN offset 0, and the
    exact payload the reference test expects (pbch_file_test.c:235)."""
    from srsran_tpu.phy.ue.ue_sync import mib_search

    x = _load("signal.1.92M.dat")
    cell = Cell(nof_prb=6, nof_ports=1, id=150)
    res = mib_search(x, cell, sf0_start=0)
    assert res is not None
    mib, nports, sfn_off = res
    assert nports == 2
    assert sfn_off == 0
    np.testing.assert_array_equal(mib.pack(), MIB_PAYLOAD)
    assert mib.nof_prb == 50 and mib.sfn == 28


def test_pdcch_file_cell_search():
    """signal.1.92M.amar.dat: cell search finds PCI 1 at subframe 0 (the
    pdcch_file_test -c 1 configuration)."""
    from srsran_tpu.phy.ue.ue_sync import cell_search

    res = cell_search(_load("signal.1.92M.amar.dat"), 6)
    assert res is not None and res.cell_id == 1 and res.sf_idx == 0
    assert res.psr > 10


def test_pcfich_file_cfi():
    """CFI = 3 decodes in every subframe of the amar capture (the -f 3
    file-test configuration), with a strong correlation margin."""
    from srsran_tpu.phy.chest.chest_dl import chest_dl
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_rx_sf
    from srsran_tpu.phy.phch.pcfich import pcfich_decode, pcfich_re_indices

    x = _load("signal.1.92M.amar.dat")
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    for sf in range(10):
        grid = np.asarray(ofdm_rx_sf(ofdm, x[sf * 1920 : (sf + 1) * 1920][None]))
        ch = chest_dl(grid, cell, sf, nof_ports=1)
        ce = np.asarray(ch["ce"])[0, 0].reshape(-1)
        noise = float(np.asarray(ch["noise"]).reshape(-1)[0])
        idx = pcfich_re_indices(cell)
        flat = grid[0].reshape(-1)
        eq = flat[idx] * np.conj(ce[idx]) / (np.abs(ce[idx]) ** 2 + noise)
        cfi, corr = pcfich_decode(eq, cell, sf)
        assert int(np.asarray(cfi)) == 3
        c = np.asarray(corr)
        assert c[2] > 2 * abs(c[0]) and c[2] > 2 * abs(c[1])


def test_pdsch_pdcch_file_sib_decode():
    """The pdsch_pdcch_file_test scenario: blind-search SI-RNTI in the
    common search space and turbo-decode the SIB transport blocks with
    CRC pass — true over-the-air parity for the full DL chain."""
    from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe

    x = _load("signal.1.92M.amar.dat")
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    decoded = {}
    for sf in range(10):
        res = ue_dl_decode_subframe(
            cell, x[sf * 1920 : (sf + 1) * 1920][None], sf, SI_RNTI, known_cfi=3
        )
        for tb, ok in res.tbs:
            if ok:
                decoded[sf] = np.packbits(np.asarray(tb)).tobytes()
    # SIB1 in subframe 5, another SI message in subframe 2
    assert 5 in decoded and 2 in decoded, sorted(decoded)
    assert len(decoded[5]) * 8 == 144
    assert len(decoded[2]) * 8 == 256
    # stable payloads (regression pin, first bytes of the BCCH messages)
    assert decoded[5].hex().startswith("604004")
    assert decoded[2].hex().startswith("00800c")


@pytest.mark.gpu
def test_golden_vectors_on_card(gpu):
    """The four captures above decode on the card as on the CPU: MIB, cell
    search, CFI and both SIB transport blocks CRC-OK.  On the card float32
    matmuls may run in TF32; these are the decisions it could move."""
    import jax

    assert jax.default_backend() == "gpu"
    test_pbch_file_mib()
    test_pdcch_file_cell_search()
    test_pcfich_file_cfi()
    test_pdsch_pdcch_file_sib_decode()
