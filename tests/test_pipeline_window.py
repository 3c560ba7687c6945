"""Windowed dynamic pipeline: one fixed program set decodes any W-TTI
grant mix (pipeline_window.WindowedUeDl)."""

import numpy as np
import jax.numpy as jnp

from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu.pipeline_window import WindowedUeDl

W = 4


def _mix(cell, rng, n, ofdm, noise_amp=0.02):
    out = []
    while len(out) < n:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 27))
        l = int(rng.integers(4, cell.nof_prb + 1))
        st = int(rng.integers(0, cell.nof_prb + 1 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
        put_crs_np(grid, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
        rx = (tx + noise_amp * (rng.standard_normal(len(tx))
                                + 1j * rng.standard_normal(len(tx)))
              ).astype(np.complex64)
        out.append((rx, sf_idx, grant, tb))
    return out


def test_window_decodes_random_mix():
    rng = np.random.default_rng(7)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=2)

    for round_i in range(2):  # second window: same programs, new grants
        mix = _mix(cell, rng, W, ofdm)
        samples = np.stack([m[0] for m in mix])[:, None, :]
        res, _soft = ue.decode_window(
            samples, [m[1] for m in mix], [m[2] for m in mix])
        for (rx, sf, grant, tb), (tb_hat, ok, n_it) in zip(mix, res):
            assert ok, f"round {round_i}: CRC failed (tbs {grant.tbs})"
            np.testing.assert_array_equal(tb_hat, tb)
    assert ue.stats["ttis"] == 2 * W and ue.stats["crc_ok"] == 2 * W


def test_window_compile_budget():
    """The windowed pipeline's core contract: a fresh random mix every
    window, yet the program set stays bounded — stage A/B hold exactly
    ONE executable each, and stage C at most one per dense-occupancy
    bucket (slot count / layout-class count / fold depth)."""
    from srsran_tpu.pipeline_window import _build_win_c

    rng = np.random.default_rng(11)
    cell = Cell(nof_prb=25, nof_ports=1, id=5)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=2, max_iterations=2)

    before = _build_win_c.cache_info().currsize
    keys = set()
    for _ in range(3):
        mix = _mix(cell, rng, 2, ofdm)
        samples = np.stack([m[0] for m in mix])[:, None, :]
        p = ue.dispatch_window(samples, [m[1] for m in mix],
                               [m[2] for m in mix])
        keys.add(p.pack.key)
        res = ue.results(p)
        assert all(r[1] for r in res)
    assert ue._a._cache_size() == 1
    # one per (RE-class bucket, present-Qm subset): the Qm set key lets a
    # uniform window demodulate once instead of four one-hot times; both
    # factors are small and bounded
    assert len(ue._b_cache) <= 2 * 4
    grown = _build_win_c.cache_info().currsize - before
    assert grown <= len(keys) <= 3


def test_bluestein_idft_matches_matrix():
    """Traced-length Bluestein IDFT == the per-width IDFT matrix for all
    PUSCH-valid widths."""
    import jax.numpy as jnp
    from srsran_tpu.phy.dft_precoding import _dft_matrix, idft_bluestein

    rng = np.random.default_rng(0)
    M = 1200
    for m in (12, 36, 180, 300, 600, 960, 1200):
        x = np.zeros((3, M), np.complex64)
        x[:, :m] = (rng.standard_normal((3, m))
                    + 1j * rng.standard_normal((3, m))).astype(np.complex64)
        ref = x[:, :m] @ _dft_matrix(m, True)
        got = np.asarray(idft_bluestein(jnp.asarray(x), jnp.int32(m)))
        np.testing.assert_allclose(got[:, :m], ref, atol=1e-4)
        assert not got[:, m:].any()


def test_window_enb_ul_random_mix():
    """WindowedEnbUl: W PUSCH grants of mixed widths/MCS per dispatch —
    Bluestein IDFT de-precoding, closed-form de-interleave, shared
    grouped stage C."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline_window import WindowedEnbUl

    rng = np.random.default_rng(9)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    enb = WindowedEnbUl(cell, w=W, max_iterations=3)

    mix = []
    widths = (4, 9, 25, 50)
    while len(mix) < W:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, cell.nof_prb - nprb + 1))
        tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if tbs == 0:
            continue
        grant = UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs),
                        tbs=tbs, rv=0, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))
        rx = (tx + 0.02 * (rng.standard_normal(len(tx))
                           + 1j * rng.standard_normal(len(tx)))
              ).astype(np.complex64)
        mix.append((rx, sf_idx, grant, tb))

    samples = np.stack([m[0] for m in mix])[:, None, :]
    res, _ = enb.decode_window(samples, [m[1] for m in mix],
                               [m[2] for m in mix])
    for (rx, sf, grant, tb), (tb_hat, ok, n_it) in zip(mix, res):
        assert ok, f"UL CRC failed (nprb {grant.nof_prb}, tbs {grant.tbs})"
        np.testing.assert_array_equal(tb_hat, tb)


def test_window_harq_cross_window_routing():
    """A retransmission lands in a LATER window at a DIFFERENT slot:
    extract_softbuffer/make_softbuffer route the HARQ state between
    windows entirely device-side."""
    from srsran_tpu.pipeline_window import extract_softbuffer, make_softbuffer

    rng = np.random.default_rng(6)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=4)

    mcs, l = 16, 15
    tbs = dl_tbs(mcs, l)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    amp = 0.42

    def tx_of(rv, sf):
        g = DlGrant(prb=tuple(range(l)), mod=dl_mcs_to_mod(mcs), tbs=tbs,
                    rnti=0x46, rv=rv)
        grid = pdsch_encode_np(cell, sf, 1, g, tb)
        put_crs_np(grid, cell, sf)
        t = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
        return (t + amp * (rng.standard_normal(cell.sf_len)
                           + 1j * rng.standard_normal(cell.sf_len))
                ).astype(np.complex64), g

    # window 1: failing rv0 at slot 1
    rx0, g0 = tx_of(0, 2)
    filler1 = _mix(cell, rng, W - 1, ofdm)
    mix1 = [filler1[0]] + [(rx0, 2, g0)] + [m[:3] for m in filler1[1:]]
    samples1 = np.stack([m[0] for m in mix1])[:, None, :]
    p1 = ue.dispatch_window(samples1, [m[1] for m in mix1],
                            [m[2] for m in mix1])
    res1 = ue.results(p1)
    assert not res1[1][1], "rv0 unexpectedly decoded"
    carry = extract_softbuffer(p1, 1)

    # window 2: rv2 retransmission at slot 3, fresh buffers elsewhere
    rx2, g2 = tx_of(2, 5)
    filler2 = _mix(cell, rng, W - 1, ofdm)
    mix2 = [m[:3] for m in filler2[:3]] + [(rx2, 5, g2)]
    samples2 = np.stack([m[0] for m in mix2])[:, None, :]
    soft2 = make_softbuffer([None, None, None, carry])
    res2, _ = ue.decode_window(samples2, [m[1] for m in mix2],
                               [m[2] for m in mix2], softbuffer=soft2)
    assert res2[3][1], "cross-window rv0+rv2 combining failed"
    np.testing.assert_array_equal(res2[3][0], tb)


def test_window_tm2_diversity_mix():
    """scheme="diversity": a W-mix of SFBC grants on a 2-port cell —
    2-port chest in stage A, Alamouti combining in stage B, same fixed
    program set."""
    from srsran_tpu.phy.modem import Mod

    rng = np.random.default_rng(21)
    cell = Cell(nof_prb=25, nof_ports=2, id=7)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=3, scheme="diversity")
    h = np.array([[0.9 + 0.3j, -0.5 + 0.7j]], np.complex64)  # 1rx x 2tx

    mix = []
    while len(mix) < W:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(2, 20))
        l = int(rng.integers(4, 26))
        st = int(rng.integers(0, 26 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=0x46, tx_scheme="diversity")
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)  # (2, nsymb, nre)
        put_crs_np(grid, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))  # (2, sf_len)
        rx = np.einsum("rp,pt->rt", h, tx)
        rx = (rx + 0.02 * (rng.standard_normal(rx.shape)
                           + 1j * rng.standard_normal(rx.shape))
              ).astype(np.complex64)
        mix.append((rx, sf_idx, grant, tb))

    samples = np.stack([m[0] for m in mix])  # (W, 1, sf_len)
    res, _ = ue.decode_window(samples, [m[1] for m in mix],
                              [m[2] for m in mix])
    for (rx, sf, grant, tb), (tb_hat, ok, _) in zip(mix, res):
        assert ok, f"TM2 CRC failed (tbs {grant.tbs})"
        np.testing.assert_array_equal(tb_hat, tb)


def test_window_mimo_two_codewords():
    """WindowedUeDlMimo: W TTIs of 2-codeword spatial-multiplexing grants
    (TM4 codebook PMIs and one TM3 CDD slot, mixed MCS per codeword)
    decode through the shared stage C at width 2W."""
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.pipeline_window import WindowedUeDlMimo

    rng = np.random.default_rng(31)
    cell = Cell(nof_prb=25, nof_ports=2, id=77)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDlMimo(cell, cfi=1, w=W, max_iterations=4)
    h = np.array([[1.0 + 0.1j, 0.2 - 0.3j],
                  [-0.25 + 0.15j, 0.8 - 0.4j]], np.complex64)

    mix = []
    schemes = ["spatialmux", "spatialmux", "spatialmux", "cdd"]
    for i in range(W):
        sf_idx = int(rng.integers(0, 10))
        mcs1, mcs2 = int(rng.integers(4, 16)), int(rng.integers(4, 16))
        l = int(rng.integers(10, 26))
        st = int(rng.integers(0, 26 - l))
        tbs1, tbs2 = dl_tbs(mcs1, l), dl_tbs(mcs2, l)
        grant = DlGrant2(prb=tuple(range(st, st + l)),
                         mod1=dl_mcs_to_mod(mcs1), tbs1=tbs1,
                         mod2=dl_mcs_to_mod(mcs2), tbs2=tbs2,
                         pmi=int(rng.integers(0, 3)), rnti=0x46,
                         tx_scheme=schemes[i % len(schemes)])
        tb1 = rng.integers(0, 2, tbs1).astype(np.uint8)
        tb2 = rng.integers(0, 2, tbs2).astype(np.uint8)
        grid = pdsch_encode2_np(cell, sf_idx, 1, grant, tb1, tb2)
        full = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol),
                        np.complex64)
        full += grid
        put_crs_np(full, cell, sf_idx)
        tx = np.asarray(ofdm_tx_sf(ofdm, full))  # (2, sf_len)
        rx = np.einsum("rp,pt->rt", h, tx)
        rx = (rx + 0.01 * (rng.standard_normal(rx.shape)
                           + 1j * rng.standard_normal(rx.shape))
              ).astype(np.complex64)
        mix.append((rx, sf_idx, grant, tb1, tb2))

    samples = np.stack([m[0] for m in mix])  # (W, 2, sf_len)
    res, _ = ue.decode_window(samples, [m[1] for m in mix],
                              [m[2] for m in mix])
    for (rx, sf, grant, tb1, tb2), ((t1, ok1), (t2, ok2), _n) in zip(mix, res):
        assert ok1 and ok2, (
            f"{grant.tx_scheme} pmi={grant.pmi} cw ok=({ok1},{ok2})")
        np.testing.assert_array_equal(t1, tb1)
        np.testing.assert_array_equal(t2, tb2)


def test_window_enb_ul_multi_ue_same_tti():
    """The window axis doubles as the eNB's multi-UE axis: W different
    UEs' PUSCH grants from the SAME TTI (disjoint allocations, distinct
    RNTIs) decode in one dispatch — the cc_worker work_ul role at
    window throughput."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline_window import WindowedEnbUl

    rng = np.random.default_rng(3)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    enb = WindowedEnbUl(cell, w=W, max_iterations=3)

    sf_idx = 4
    starts = (0, 12, 24, 36)
    mix = []
    for u in range(W):
        mcs = int(rng.integers(4, 20))
        nprb = 9
        tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        grant = UlGrant(prb_start=starts[u], nof_prb=nprb,
                        mod=ul_mcs_to_mod(mcs), tbs=tbs, rv=0,
                        rnti=0x46 + u)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(grant, tb)))
        mix.append((tx, grant, tb))

    # one received subframe carrying all four UEs' PUSCH
    rx_sum = sum(m[0] for m in mix)
    rx = (rx_sum + 0.02 * (rng.standard_normal(len(rx_sum))
                           + 1j * rng.standard_normal(len(rx_sum)))
          ).astype(np.complex64)
    samples = np.tile(rx[None, None, :], (W, 1, 1))
    res, _ = enb.decode_window(samples, [sf_idx] * W,
                               [m[1] for m in mix])
    for (tx, grant, tb), (tb_hat, ok, _) in zip(mix, res):
        assert ok, f"UE rnti {grant.rnti:#x} failed"
        np.testing.assert_array_equal(tb_hat, tb)


def test_window_harq_combining():
    """rv0 at heavy noise fails; rv2 retransmission combined through the
    window softbuffer succeeds (on-device scatter-add HARQ)."""
    rng = np.random.default_rng(5)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=4)

    mcs, l = 16, 15
    tbs = dl_tbs(mcs, l)
    grant0 = DlGrant(prb=tuple(range(l)), mod=dl_mcs_to_mod(mcs), tbs=tbs,
                     rnti=0x46, rv=0)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)

    def tx_of(g, sf):
        grid = pdsch_encode_np(cell, sf, 1, g, tb)
        put_crs_np(grid, cell, sf)
        return np.asarray(ofdm_tx_sf(ofdm, grid))[0]

    amp = 0.42
    filler = _mix(cell, rng, W - 1, ofdm)

    rx0 = (tx_of(grant0, 2) + amp * (
        rng.standard_normal(cell.sf_len) + 1j * rng.standard_normal(cell.sf_len)
    )).astype(np.complex64)
    mix0 = [(rx0, 2, grant0)] + [(m[0], m[1], m[2]) for m in filler]
    samples0 = np.stack([m[0] for m in mix0])[:, None, :]
    res0, soft0 = ue.decode_window(
        samples0, [m[1] for m in mix0], [m[2] for m in mix0])
    assert not res0[0][1], "rv0 unexpectedly decoded at this SNR"

    grant2 = DlGrant(prb=grant0.prb, mod=grant0.mod, tbs=tbs, rnti=0x46, rv=2)
    rx2 = (tx_of(grant2, 3) + amp * (
        rng.standard_normal(cell.sf_len) + 1j * rng.standard_normal(cell.sf_len)
    )).astype(np.complex64)
    mix2 = [(rx2, 3, grant2)] + [(m[0], m[1], m[2]) for m in filler]
    samples2 = np.stack([m[0] for m in mix2])[:, None, :]
    res2, _ = ue.decode_window(
        samples2, [m[1] for m in mix2], [m[2] for m in mix2],
        softbuffer=soft0)
    assert res2[0][1], "rv0+rv2 combining failed"
    np.testing.assert_array_equal(res2[0][0], tb)


def test_windowed_enb_dl_generation_roundtrip():
    """WindowedEnbDl (the sf_worker TX half as window programs): W TTIs
    of arbitrary port0 grants encode in one dispatch — payload bytes →
    CRC/segment → dynamic-K closed-form turbo → class-shared TX rate
    match → modulate → grid+IFFT — and the WindowedUeDl decode windows
    recover every payload over an AWGN link."""
    from srsran_tpu.pipeline_window import WindowedEnbDl

    rng = np.random.default_rng(13)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    enb = WindowedEnbDl(cell, cfi=1, w=W)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=3)

    for round_i in range(2):  # same programs, fresh grants
        sfs, grants, tbs = [], [], []
        while len(grants) < W:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 27))
            l = int(rng.integers(4, cell.nof_prb + 1))
            st = int(rng.integers(0, cell.nof_prb + 1 - l))
            t = dl_tbs(mcs, l)
            if t == 0:
                continue
            sfs.append(sf_idx)
            grants.append(DlGrant(prb=tuple(range(st, st + l)),
                                  mod=dl_mcs_to_mod(mcs), tbs=t,
                                  rnti=0x46))
            tbs.append(rng.integers(0, 2, t).astype(np.uint8))

        out = enb.dispatch_window(tbs, sfs, grants)
        tx = WindowedEnbDl.samples(out)  # (W, sf_len)
        rx = (tx + 0.02 * (rng.standard_normal(tx.shape)
                           + 1j * rng.standard_normal(tx.shape))
              ).astype(np.complex64)
        res, _ = ue.decode_window(rx[:, None, :], sfs, grants)
        for (tb, (tb_hat, ok, _n)) in zip(tbs, res):
            assert ok, f"round {round_i}: windowed TX->RX CRC failed"
            np.testing.assert_array_equal(tb_hat, tb)


def test_window_reduced_rate():
    """Windowed decode at the reduced ('non-standard') sample rate —
    50 PRB on a 768-FFT grid (srslte_symbol_sz use_standard_rates=false,
    phy_common.c:334-377; the 20 MHz analog is the ZMQ default
    23.04 Msps, which fits the deployment link where 30.72 cannot)."""
    rng = np.random.default_rng(47)
    cell = Cell(nof_prb=50, nof_ports=1, id=17, use_standard_rates=False)
    assert cell.symbol_sz == 768
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=3)
    mm = _mix(cell, rng, W, ofdm)
    samples = np.stack([m[0] for m in mm])[:, None, :]
    res, _ = ue.decode_window(samples, [m[1] for m in mm],
                              [m[2] for m in mm])
    for m, r in zip(mm, res):
        assert r[1], "reduced-rate window CRC failed"
        np.testing.assert_array_equal(r[0], m[3])


def test_window_device_loopback():
    """Device-resident loopback: generation window → on-chip channel
    (`window_channel`) → decode window with device ingest — baseband
    never crosses the host boundary (the serving topology; the
    reference's equivalent is the srsenb↔srsue ZMQ sample loop,
    lib/src/phy/rf/rf_zmq_imp.c, which this design replaces with an
    in-HBM hand-off)."""
    from srsran_tpu.pipeline_window import WindowedEnbDl, window_channel

    rng = np.random.default_rng(41)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    enb = WindowedEnbDl(cell, cfi=1, w=W)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=3)
    h = np.array([[0.9 - 0.35j]], np.complex64)

    for round_i in range(2):
        sfs, grants, tbs = [], [], []
        while len(grants) < W:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 27))
            l = int(rng.integers(4, cell.nof_prb + 1))
            st = int(rng.integers(0, cell.nof_prb + 1 - l))
            t = dl_tbs(mcs, l)
            if t == 0:
                continue
            sfs.append(sf_idx)
            grants.append(DlGrant(prb=tuple(range(st, st + l)),
                                  mod=dl_mcs_to_mod(mcs), tbs=t,
                                  rnti=0x46))
            tbs.append(rng.integers(0, 2, t).astype(np.uint8))

        tx = enb.dispatch_window(tbs, sfs, grants)   # device (W, L, 2)
        rx = window_channel(tx, h, noise_amp=0.02, seed=round_i)
        assert isinstance(rx, jnp.ndarray)
        res, _ = ue.decode_window(rx, sfs, grants)   # device ingest path
        for (tb, (tb_hat, ok, _n)) in zip(tbs, res):
            assert ok, f"round {round_i}: device loopback CRC failed"
            np.testing.assert_array_equal(tb_hat, tb)


def test_window_device_loopback_mimo():
    """2x2 MIMO device loopback: WindowedEnbDlMimo → on-chip 2x2 channel
    → WindowedUeDlMimo device ingest."""
    from srsran_tpu.phy.phch.pdsch import DlGrant2
    from srsran_tpu.pipeline_window import (
        WindowedEnbDlMimo, WindowedUeDlMimo, window_channel)

    rng = np.random.default_rng(43)
    cell = Cell(nof_prb=25, nof_ports=2, id=77)
    enb = WindowedEnbDlMimo(cell, cfi=1, w=W)
    ue = WindowedUeDlMimo(cell, cfi=1, w=W, max_iterations=4)
    h = np.array([[1.0 + 0.1j, 0.2 - 0.3j],
                  [-0.25 + 0.15j, 0.8 - 0.4j]], np.complex64)

    sfs, grants, pairs = [], [], []
    for i in range(W):
        mcs1, mcs2 = int(rng.integers(4, 16)), int(rng.integers(4, 16))
        l = int(rng.integers(10, 26))
        st = int(rng.integers(0, 26 - l))
        sfs.append(int(rng.integers(0, 10)))
        grants.append(DlGrant2(prb=tuple(range(st, st + l)),
                               mod1=dl_mcs_to_mod(mcs1),
                               tbs1=dl_tbs(mcs1, l),
                               mod2=dl_mcs_to_mod(mcs2),
                               tbs2=dl_tbs(mcs2, l),
                               pmi=int(rng.integers(0, 3)), rnti=0x46))
        pairs.append((rng.integers(0, 2, grants[-1].tbs1).astype(np.uint8),
                      rng.integers(0, 2, grants[-1].tbs2).astype(np.uint8)))

    tx = enb.dispatch_window(pairs, sfs, grants)     # device (W, 2, L, 2)
    rx = window_channel(tx, h, noise_amp=0.01)
    res, _ = ue.decode_window(rx, sfs, grants)
    for (tb1, tb2), ((t1h, ok1), (t2h, ok2), _n) in zip(pairs, res):
        assert ok1 and ok2, "MIMO device loopback failed"
        np.testing.assert_array_equal(t1h, tb1)
        np.testing.assert_array_equal(t2h, tb2)


def test_window_device_loopback_ul():
    """UL device loopback: WindowedUeUl generation → on-chip channel →
    WindowedEnbUl device ingest — the uplink half of the serving
    topology (UE TX baseband hands off in HBM, mirroring the DL
    loopback)."""
    from srsran_tpu.phy.phch.pusch import UlGrant
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.pipeline_window import (
        WindowedEnbUl, WindowedUeUl, window_channel)

    rng = np.random.default_rng(53)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ue = WindowedUeUl(cell, w=W)
    enb = WindowedEnbUl(cell, w=W, max_iterations=3)
    h = np.array([[0.85 + 0.3j]], np.complex64)

    widths = (4, 9, 25, 50)
    sfs, grants, tbs = [], [], []
    while len(grants) < W:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, cell.nof_prb - nprb + 1))
        t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if t == 0:
            continue
        sfs.append(sf_idx)
        grants.append(UlGrant(prb_start=st, nof_prb=nprb,
                              mod=ul_mcs_to_mod(mcs), tbs=t, rv=0,
                              rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))

    tx = ue.dispatch_window(tbs, sfs, grants)       # device (W, L, 2)
    rx = window_channel(tx, h, noise_amp=0.02)
    res, _ = enb.decode_window(rx, sfs, grants)     # device ingest
    for (tb, (tb_hat, ok, _n)) in zip(tbs, res):
        assert ok, "UL device loopback CRC failed"
        np.testing.assert_array_equal(tb_hat, tb)


def test_windowed_ue_ul_generation_roundtrip():
    """WindowedUeUl (the UE transmit half as window programs): W PUSCH
    grants of mixed widths/MCS encode in one dispatch — shared codeword
    core → class-shared channel interleave → scramble → Bluestein DFT
    precode → DMRS/allocation placement → SC-FDMA — and WindowedEnbUl
    decodes every payload.  All four windowed directions now close the
    loop in-graph."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.phch.pusch import UlGrant
    from srsran_tpu.pipeline_window import (
        WindowedEnbDl, WindowedEnbUl, WindowedUeUl)

    rng = np.random.default_rng(23)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ue = WindowedUeUl(cell, w=W)
    enb = WindowedEnbUl(cell, w=W, max_iterations=3)

    widths = (4, 9, 25, 50)
    for round_i in range(2):
        sfs, grants, tbs = [], [], []
        while len(grants) < W:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 24))
            nprb = int(widths[rng.integers(0, len(widths))])
            st = int(rng.integers(0, cell.nof_prb - nprb + 1))
            t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
            if t == 0:
                continue
            sfs.append(sf_idx)
            grants.append(UlGrant(prb_start=st, nof_prb=nprb,
                                  mod=ul_mcs_to_mod(mcs), tbs=t, rv=0,
                                  rnti=0x46))
            tbs.append(rng.integers(0, 2, t).astype(np.uint8))

        out = ue.dispatch_window(tbs, sfs, grants)
        tx = WindowedEnbDl.samples(out)
        rx = (tx + 0.02 * (rng.standard_normal(tx.shape)
                           + 1j * rng.standard_normal(tx.shape))
              ).astype(np.complex64)
        res, _ = enb.decode_window(rx[:, None, :], sfs, grants)
        for (tb, (tb_hat, ok, _n)) in zip(tbs, res):
            assert ok, f"round {round_i}: windowed UL TX->RX CRC failed"
            np.testing.assert_array_equal(tb_hat, tb)


def test_window_qam256_max_tb_roundtrip():
    """The largest LTE TB (256QAM MCS27 at 100 PRB: tbs 97896, 16
    codeblocks) through the generation + decode windows with int16
    ingest — exercises MAX_CB=16, the TBS_MAX=98304 packing, the widest
    rate-match classes, and the higher-SQNR ingest mode."""
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.pipeline_window import WindowedEnbDl
    from srsran_tpu.phy.phch.ra import dl_tbs

    rng = np.random.default_rng(41)
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    Wq = 2
    enb = WindowedEnbDl(cell, cfi=1, w=Wq)
    ue = WindowedUeDl(cell, cfi=1, w=Wq, max_iterations=6, ingest="int16")

    tbs = dl_tbs(27, 100, use_256qam=True)
    assert tbs == 97896
    grants = [DlGrant(prb=tuple(range(100)), mod=Mod.QAM256, tbs=tbs,
                      rnti=0x46)] * Wq
    sfs = [2, 7]
    tbs_bits = [rng.integers(0, 2, tbs).astype(np.uint8) for _ in range(Wq)]

    from srsran_tpu.pipeline_window import WindowedEnbDl as _E

    tx = _E.samples(enb.dispatch_window(tbs_bits, sfs, grants))
    rx = (tx + 0.005 * (rng.standard_normal(tx.shape)
                        + 1j * rng.standard_normal(tx.shape))
          ).astype(np.complex64)
    res, _ = ue.decode_window(rx[:, None, :], sfs, grants)
    for tb, (tb_hat, ok, _n) in zip(tbs_bits, res):
        assert ok, "max-TB 256QAM window decode failed"
        np.testing.assert_array_equal(tb_hat, tb)


def test_window_txgen_harq_rv_combining():
    """HARQ through the GENERATED link: rv0 from WindowedUeUl fails at
    heavy noise; the rv2 retransmission (different TX rate-match class,
    same payload) combines in WindowedEnbUl's softbuffer and decodes —
    end-to-end incremental redundancy with both directions in-graph."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.phch.pusch import UlGrant
    from srsran_tpu.pipeline_window import (
        WindowedEnbDl, WindowedEnbUl, WindowedUeUl)
    import dataclasses as dc

    rng = np.random.default_rng(29)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    Wq = 2
    ue = WindowedUeUl(cell, w=Wq)
    enb = WindowedEnbUl(cell, w=Wq, max_iterations=5)

    mcs, nprb = 16, 15
    tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
    g0 = UlGrant(prb_start=3, nof_prb=nprb, mod=ul_mcs_to_mod(mcs),
                 tbs=tbs, rv=0, rnti=0x46)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    filler = UlGrant(prb_start=20, nof_prb=9,
                     mod=ul_mcs_to_mod(5),
                     tbs=tbs_lookup(ul_mcs_to_itbs(5), 9), rv=0,
                     rnti=0x47)
    ftb = rng.integers(0, 2, filler.tbs).astype(np.uint8)

    amp = 0.33

    def link(grants, payloads, sfs):
        tx = WindowedEnbDl.samples(ue.dispatch_window(payloads, sfs, grants))
        return (tx + amp * (rng.standard_normal(tx.shape)
                            + 1j * rng.standard_normal(tx.shape))
                ).astype(np.complex64)

    sfs = [4, 9]
    rx0 = link([g0, filler], [tb, ftb], sfs)
    p0 = enb.dispatch_window(rx0[:, None, :], sfs, [g0, filler])
    res0 = enb.results(p0)
    assert not res0[0][1], "rv0 unexpectedly decoded at this SNR"

    g2 = dc.replace(g0, rv=2)
    rx2 = link([g2, filler], [tb, ftb], sfs)
    res2, _ = enb.decode_window(rx2[:, None, :], sfs, [g2, filler],
                                softbuffer=p0.softbuffer)
    assert res2[0][1], "rv0+rv2 TX-generated combining failed"
    np.testing.assert_array_equal(res2[0][0], tb)


def test_windowed_enb_dl_mimo_generation_roundtrip():
    """WindowedEnbDlMimo: W TTIs of 2-codeword TM4/TM3 grants (mixed
    PMIs, one CDD slot) generate in one dispatch; WindowedUeDlMimo over
    a 2x2 channel recovers every codeword pair."""
    from srsran_tpu.phy.phch.pdsch import DlGrant2
    from srsran_tpu.pipeline_window import WindowedEnbDlMimo, WindowedUeDlMimo

    rng = np.random.default_rng(37)
    cell = Cell(nof_prb=25, nof_ports=2, id=77)
    enb = WindowedEnbDlMimo(cell, cfi=1, w=W)
    ue = WindowedUeDlMimo(cell, cfi=1, w=W, max_iterations=4)
    h = np.array([[1.0 + 0.1j, 0.2 - 0.3j],
                  [-0.25 + 0.15j, 0.8 - 0.4j]], np.complex64)

    schemes = ["spatialmux", "spatialmux", "spatialmux", "cdd"]
    sfs, grants, pairs = [], [], []
    for i in range(W):
        mcs1, mcs2 = int(rng.integers(4, 16)), int(rng.integers(4, 16))
        l = int(rng.integers(10, 26))
        st = int(rng.integers(0, 26 - l))
        t1, t2 = dl_tbs(mcs1, l), dl_tbs(mcs2, l)
        sfs.append(int(rng.integers(0, 10)))
        grants.append(DlGrant2(prb=tuple(range(st, st + l)),
                               mod1=dl_mcs_to_mod(mcs1), tbs1=t1,
                               mod2=dl_mcs_to_mod(mcs2), tbs2=t2,
                               pmi=int(rng.integers(0, 3)), rnti=0x46,
                               tx_scheme=schemes[i % len(schemes)]))
        pairs.append((rng.integers(0, 2, t1).astype(np.uint8),
                      rng.integers(0, 2, t2).astype(np.uint8)))

    out = enb.dispatch_window(pairs, sfs, grants)
    ri = np.asarray(out)
    tx = (ri[..., 0] + 1j * ri[..., 1]).astype(np.complex64)  # (W,2,len)
    rx = np.einsum("rp,wpt->wrt", h, tx)
    rx = (rx + 0.01 * (rng.standard_normal(rx.shape)
                       + 1j * rng.standard_normal(rx.shape))
          ).astype(np.complex64)
    res, _ = ue.decode_window(rx, sfs, grants)
    for (tb1, tb2), ((t1h, ok1), (t2h, ok2), _n) in zip(pairs, res):
        assert ok1 and ok2, "MIMO generation window roundtrip failed"
        np.testing.assert_array_equal(t1h, tb1)
        np.testing.assert_array_equal(t2h, tb2)
