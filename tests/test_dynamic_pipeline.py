"""Dynamic-grant pipeline: any per-TTI grant with a bounded compile set.

The reference decodes arbitrary per-TTI grants inside a fixed budget with
no recompilation (`srsue/src/phy/cc_worker.cc:214-307`, `sch.c:503`);
`pipeline_dynamic.DynamicUeDl` must do the same on device via shape
buckets.  These tests are the compile-budget regression: a realistic scheduler-driven mix must decode correctly AND stay under
an explicit XLA-program budget.
"""

import numpy as np
import pytest

from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
from srsran_tpu.phy.fec.cbsegm import qpp_interleaver_np
from srsran_tpu.phy.modem import Mod
from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
from srsran_tpu.pipeline_dynamic import DynamicUeDl


def _render(cell, ofdm, sf_idx, grant, tb, rng, snr_amp=0.05, nrx=1):
    grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
    full = np.zeros(
        (max(grid.shape[0], cell.nof_ports), cell.nsymb_per_sf,
         cell.nof_re_per_symbol), np.complex64)
    full[: grid.shape[0]] += grid
    put_crs_np(full, cell, sf_idx)
    tx = np.asarray(ofdm_tx_sf(ofdm, full))  # (nports, sf_len)
    rx = np.broadcast_to(tx.sum(axis=0, keepdims=True), (nrx, tx.shape[1])).copy()
    rx += snr_amp * (rng.standard_normal(rx.shape)
                     + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


def test_dynamic_grant_mix_and_compile_budget():
    """Scheduler-driven random grant mix (MCS 0-28 x random contiguous PRB
    allocations x all subframes) through ONE facade: every TB decodes, and
    the number of distinct XLA programs stays bounded — later TTIs reuse
    earlier buckets (zero per-TTI recompiles in steady state)."""
    rng = np.random.default_rng(7)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = DynamicUeDl(cell, cfi=1)

    n = 40
    compiles_at = []
    for i in range(n):
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 29))
        l = int(rng.integers(1, 51))
        s = int(rng.integers(0, 51 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        grant = DlGrant(prb=tuple(range(s, s + l)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        rx = _render(cell, ofdm, sf_idx, grant, tb, rng)
        tb_hat, ok, _, _ = ue.decode(rx, sf_idx, grant)
        assert ok, (i, sf_idx, mcs, s, l, tbs)
        np.testing.assert_array_equal(tb_hat, tb)
        compiles_at.append(ue.total_compiles)

    # explicit compile budget: stage A ≤ 10 (one per sf_idx), stages B+C
    # bounded by the bucket grid, NOT by the number of distinct grants
    assert ue.stats["compiles_a"] <= 10
    assert ue.stats["compiles_b"] <= 12
    assert ue.stats["compiles_c"] <= 14
    # steady state: the last quarter of the mix must not add programs
    q = len(compiles_at) // 4
    assert compiles_at[-1] - compiles_at[-q] <= 1, compiles_at


def test_dynamic_harq_combining():
    """rv 0 → too little SNR → NACK; rv 2 retransmission combines in the
    softbuffer and decodes (softbuffer.c / rm_turbo RX `+=` semantics)."""
    rng = np.random.default_rng(3)
    cell = Cell(nof_prb=15, nof_ports=1, id=3)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = DynamicUeDl(cell, cfi=1, max_iterations=4)

    # high MCS at low SNR: first transmission alone must fail
    tbs = dl_tbs(16, 15)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    g0 = DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(16), tbs=tbs, rv=0)
    rx0 = _render(cell, ofdm, 1, g0, tb, rng, snr_amp=0.42)
    _, ok0, soft, _ = ue.decode(rx0, 1, g0)

    g2 = DlGrant(prb=tuple(range(15)), mod=dl_mcs_to_mod(16), tbs=tbs, rv=2)
    rx2 = _render(cell, ofdm, 2, g2, tb, rng, snr_amp=0.42)
    tb_hat, ok2, _, _ = ue.decode(rx2, 2, g2, softbuffer=soft)
    assert ok2
    np.testing.assert_array_equal(tb_hat, tb)


def test_dynamic_vs_static_parity():
    """The dynamic path must produce the same TB as the static pipeline on
    the same samples."""
    from srsran_tpu.pipeline import ue_dl_subframe

    rng = np.random.default_rng(11)
    cell = Cell(nof_prb=25, nof_ports=1, id=5)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = DynamicUeDl(cell, cfi=1)
    for mcs, sf_idx in ((4, 0), (13, 4), (22, 9)):
        tbs = dl_tbs(mcs, 25)
        grant = DlGrant(prb=tuple(range(25)), mod=dl_mcs_to_mod(mcs), tbs=tbs)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        rx = _render(cell, ofdm, sf_idx, grant, tb, rng)
        tb_dyn, ok_dyn, _, _ = ue.decode(rx, sf_idx, grant)
        static_fn = ue_dl_subframe(cell, sf_idx, 1, grant)
        tb_st, ok_st, _ = static_fn(rx)
        assert ok_dyn and bool(ok_st)
        np.testing.assert_array_equal(tb_dyn, np.asarray(tb_st))
        np.testing.assert_array_equal(tb_dyn, tb)


def test_dynamic_turbo_all_cb_sizes_sampled():
    """Dynamic-K turbo decode across sampled LTE CB sizes in one program
    per K bucket (exactness of the masked scans + tail injection)."""
    import jax.numpy as jnp

    from srsran_tpu.phy.common import LTE_CRC24A
    from srsran_tpu.phy.crc import crc_attach_np
    from srsran_tpu.phy.fec.turbo import turbo_encode_np
    from srsran_tpu.phy.fec.turbo_dyn import crc_table_ab, turbo_decode_dyn

    rng = np.random.default_rng(5)
    k_max = 2112
    ks = [40, 64, 136, 512, 528, 1024, 1056, 2048, 2112]
    b = 16
    d = np.zeros((b, 3, k_max + 4), np.float32)
    per = np.tile(np.arange(k_max, dtype=np.int32), (b, 1))
    inv = per.copy()
    k_vec = np.full(b, k_max, np.int32)
    valid = np.zeros(b, bool)
    msgs = {}
    for i, k in enumerate(ks):
        msg = rng.integers(0, 2, k - 24).astype(np.uint8)
        cb = crc_attach_np(msg, LTE_CRC24A)
        msgs[i] = cb
        enc = turbo_encode_np(cb).astype(np.float32)
        d[i, :, : k + 4] = (2 * enc - 1) * 3 + rng.normal(0, 1.0, enc.shape)
        p = qpp_interleaver_np(k)
        per[i, :k] = p
        iv = np.empty_like(p)
        iv[p] = np.arange(k, dtype=p.dtype)
        inv[i, :k] = iv
        k_vec[i] = k
        valid[i] = True
    bits, _, n_it = turbo_decode_dyn(
        jnp.asarray(d), jnp.asarray(k_vec), jnp.asarray(per), jnp.asarray(inv),
        jnp.asarray(valid), k_max, 6, crc_table=jnp.asarray(crc_table_ab(k_max)),
        crc_is_b=jnp.asarray(np.zeros(b, bool)))
    bits = np.asarray(bits)
    for i, k in enumerate(ks):
        np.testing.assert_array_equal(bits[i, :k], msgs[i], err_msg=f"K={k}")


def _dyn_kernel_case(k_max, rng):
    """A mixed-K batch for `turbo_decode_dyn`: sizes up to k_max."""
    import jax.numpy as jnp

    from srsran_tpu.phy.common import LTE_CRC24A
    from srsran_tpu.phy.crc import crc_attach_np
    from srsran_tpu.phy.fec.turbo import turbo_encode_np
    from srsran_tpu.phy.fec.turbo_dyn import crc_table_ab

    ks = [k for k in (40, 512, 1056, 2048, 5824) if k < k_max] + [k_max]
    b = len(ks) + 1
    d = np.zeros((b, 3, k_max + 4), np.float32)
    per = np.tile(np.arange(k_max, dtype=np.int32), (b, 1))
    inv = per.copy()
    k_vec = np.full(b, k_max, np.int32)
    valid = np.zeros(b, bool)
    msgs = {}
    for i in range(b):
        k = ks[i % len(ks)]
        msg = rng.integers(0, 2, k - 24).astype(np.uint8)
        cb = crc_attach_np(msg, LTE_CRC24A)
        msgs[i] = cb
        enc = turbo_encode_np(cb).astype(np.float32)
        d[i, :, : k + 4] = (2 * enc - 1) * 2 + rng.normal(0, 1.0, enc.shape)
        p = qpp_interleaver_np(k)
        iv = np.empty_like(p)
        iv[p] = np.arange(k, dtype=p.dtype)
        per[i, :k], inv[i, :k] = p, iv
        k_vec[i] = k
        valid[i] = True

    args = (jnp.asarray(d), jnp.asarray(k_vec), jnp.asarray(per),
            jnp.asarray(inv), jnp.asarray(valid))
    kw = dict(crc_table=jnp.asarray(crc_table_ab(k_max)),
              crc_is_b=jnp.asarray(np.zeros(b, bool)))
    return args, kw, k_vec, msgs


@pytest.mark.parametrize("k_max", [512, 2048, 5824, 6144])
def test_dynamic_turbo_pallas_kernel_parity(k_max):
    """The Pallas MAP kernel's dynamic-K path (per-lane mid-stream beta
    injection at `kq`) decodes a mixed-K batch identically to the XLA
    scan path (interpret mode on CPU)."""
    import jax.numpy as jnp

    from srsran_tpu.phy.fec.turbo_dyn import turbo_decode_dyn

    args, kw, k_vec, msgs = _dyn_kernel_case(k_max, np.random.default_rng(7))
    b = len(k_vec)
    bits_s, post_s, _ = turbo_decode_dyn(*args, k_max, 4, backend="scan",
                                         **kw)
    bits_p, post_p, _ = turbo_decode_dyn(
        *args, k_max, 4, backend="pallas_interpret", **kw)
    for i in range(b):
        k = int(k_vec[i])
        np.testing.assert_array_equal(np.asarray(bits_p)[i, :k], msgs[i])
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_p))
    mask = np.arange(k_max)[None, :] < np.asarray(k_vec)[:, None]
    np.testing.assert_allclose(np.asarray(post_s)[mask],
                               np.asarray(post_p)[mask], atol=2e-3)


@pytest.mark.gpu
def test_dynamic_turbo_kernel_on_card(gpu):
    """On the card: the compiled dynamic-K kernel against the scan on a
    mixed-K batch up to 6144 — identical bits, every codeblock exact,
    posteriors within 2e-3 (float32 max-log; only the order of the scan's
    fused adds may differ)."""
    from srsran_tpu.phy.fec.turbo_dyn import turbo_decode_dyn

    k_max = 6144
    args, kw, k_vec, msgs = _dyn_kernel_case(k_max, np.random.default_rng(8))
    bits_s, post_s, _ = turbo_decode_dyn(*args, k_max, 6, backend="scan",
                                         **kw)
    bits_p, post_p, _ = turbo_decode_dyn(*args, k_max, 6, backend="pallas",
                                         **kw)
    np.testing.assert_array_equal(np.asarray(bits_s), np.asarray(bits_p))
    for i, k in enumerate(k_vec):
        np.testing.assert_array_equal(np.asarray(bits_p)[i, :k], msgs[i])
    mask = np.arange(k_max)[None, :] < np.asarray(k_vec)[:, None]
    np.testing.assert_allclose(np.asarray(post_s)[mask],
                               np.asarray(post_p)[mask], atol=2e-3, rtol=0)


def _valid_pusch_l(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def test_dynamic_ul_grant_mix_and_compile_budget():
    """PUSCH mirror of the DL test: random UL grants (MCS x valid PRB
    allocations x subframes) through DynamicEnbUl under a compile budget."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline_dynamic import DynamicEnbUl

    rng = np.random.default_rng(4)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    enb = DynamicEnbUl(cell)
    ls = [l for l in range(1, 49) if _valid_pusch_l(l)]
    n = 45
    compiles_at = []
    for i in range(n):
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        l = int(rng.choice(ls))
        st = int(rng.integers(1, 50 - l))
        tbs = tbs_lookup(ul_mcs_to_itbs(mcs), l)
        if tbs == 0:
            continue
        g = UlGrant(prb_start=st, nof_prb=l, mod=ul_mcs_to_mod(mcs), tbs=tbs,
                    rv=0, rnti=0x46)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(g, tb)))
        rx = (tx + 0.04 * (rng.standard_normal(tx.shape)
                           + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)
        tbh, ok, _, _ = enb.decode(rx[None], sf_idx, g)
        assert ok, (i, sf_idx, mcs, st, l, tbs)
        np.testing.assert_array_equal(tbh, tb)
        compiles_at.append(enb.total_compiles)
    assert enb.stats["compiles_a"] == 1
    assert enb.stats["compiles_b"] <= 8
    assert enb.stats["compiles_c"] <= 14
    q = max(1, len(compiles_at) // 4)
    assert compiles_at[-1] - compiles_at[-q] <= 2, compiles_at


def test_dynamic_ul_harq_combining():
    """UL HARQ: rv0 fails alone at low SNR, rv2 retransmission combines."""
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline_dynamic import DynamicEnbUl

    rng = np.random.default_rng(6)
    cell = Cell(nof_prb=25, nof_ports=1, id=3)
    enb = DynamicEnbUl(cell, max_iterations=4)
    mcs, l = 19, 20
    tbs = tbs_lookup(ul_mcs_to_itbs(mcs), l)
    g0 = UlGrant(prb_start=1, nof_prb=l, mod=ul_mcs_to_mod(mcs), tbs=tbs,
                 rv=0, rnti=0x46)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    amp = 0.33
    tx = np.asarray(ue_ul_encode(cell, 2, pusch=(g0, tb)))
    rx0 = (tx + amp * (rng.standard_normal(tx.shape)
                       + 1j * rng.standard_normal(tx.shape))).astype(np.complex64)
    _, ok0, soft, _ = enb.decode(rx0[None], 2, g0)

    import dataclasses as dc

    g2 = dc.replace(g0, rv=2)
    tx2 = np.asarray(ue_ul_encode(cell, 3, pusch=(g2, tb)))
    rx2 = (tx2 + amp * (rng.standard_normal(tx2.shape)
                        + 1j * rng.standard_normal(tx2.shape))).astype(np.complex64)
    tbh, ok2, _, _ = enb.decode(rx2[None], 3, g2, softbuffer=soft)
    assert ok2
    np.testing.assert_array_equal(tbh, tb)


def test_facade_on_dynamic_backend():
    """The live UE facade (blind search + HARQ bookkeeping) rides the
    bucketed pipeline when given a DynamicUeDl — same TBs as the host
    path (the live stack's data path on the bucketed pipeline)."""
    from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
    from srsran_tpu.phy.phch.dci import Dci1A
    from srsran_tpu.phy.phch.ra import riv_encode
    from srsran_tpu.phy.ue.ue_dl import ue_dl_decode_subframe

    rng = np.random.default_rng(13)
    cell = Cell(nof_prb=25, nof_ports=1, id=31)
    dyn = DynamicUeDl(cell, cfi=2)
    rnti = 0x52
    for mcs, sf_idx in ((6, 1), (14, 6)):
        tbs = dl_tbs(mcs, 25)
        grant = DlGrant(prb=tuple(range(25)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=rnti)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        dci = Dci1A(riv=riv_encode(25, 0, 25), mcs=mcs, harq_pid=1)
        sched = DlSched(cfi=2)
        sched.dcis.append((dci.pack(25), rnti, 4, 0))
        sched.grants.append((grant, tb))
        _, tx = enb_dl_subframe(cell, sf_idx, sched)
        rx = (tx[:1] + 0.03 * (rng.standard_normal(tx[:1].shape)
                               + 1j * rng.standard_normal(tx[:1].shape))).astype(np.complex64)
        res_dyn = ue_dl_decode_subframe(cell, rx, sf_idx, rnti, known_cfi=2,
                                        dynamic=dyn)
        res_host = ue_dl_decode_subframe(cell, rx, sf_idx, rnti, known_cfi=2)
        assert res_dyn.tbs and res_dyn.tbs[0][1]
        assert res_host.tbs and res_host.tbs[0][1]
        np.testing.assert_array_equal(np.asarray(res_dyn.tbs[0][0]),
                                      np.asarray(res_host.tbs[0][0]))
        np.testing.assert_array_equal(np.asarray(res_dyn.tbs[0][0]), tb)
    assert dyn.stats["ttis"] == 2


def test_full_stack_on_dynamic_pipelines():
    """Live attach + IP traffic with BOTH ends' data planes on the
    bucketed device pipelines (EnbStack/UeStack dynamic_phy=True) — the
    'move the live stack's DL/UL data path onto it' done-criterion."""
    from srsran_tpu.apps.full_stack import EnbStack, UeStack
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    imsi = "001010123456789"
    key = bytes.fromhex("00112233445566778899aabbccddeeff")
    opc = sec.compute_opc(key, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    cell = Cell(nof_prb=15, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", imsi, key, opc, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    enb = EnbStack(cell, mme, spgw, mcs=5, dynamic_phy=True)
    ue = UeStack(cell, Usim(imsi, key, opc), dynamic_phy=True)

    ul = None
    for _ in range(150):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if ue.rrc_state == UeStack.RRC_ACTIVE and ue.nas.state == ue.nas.REGISTERED:
            break
    assert ue.nas.state == ue.nas.REGISTERED

    pkts = [bytes([i]) * 60 for i in range(4)]
    for p in pkts:
        spgw.sgi_tx(ue.ue_ip, p)
    for p in pkts:
        ue.send_ip_packet(p)
    for _ in range(80):
        dl = enb.run_tti(ul)
        ul = ue.run_tti(dl)
        if len(ue.ip_rx) >= len(pkts) and len(spgw.sgi_rx) >= len(pkts):
            break
    assert ue.ip_rx[: len(pkts)] == pkts
    assert [pl for _, pl in spgw.sgi_rx][: len(pkts)] == pkts
    # both dynamic pipelines actually carried the data plane
    assert ue._dyn_phy.stats["ttis"] > 0 and ue._dyn_phy.stats["crc_ok"] > 0
    assert enb._dyn_ul.stats["ttis"] > 0 and enb._dyn_ul.stats["crc_ok"] > 0


def test_dynamic_noncontiguous_allocation():
    """RA type 0 (RBG bitmap) allocations are non-contiguous PRB sets —
    the padded RE gather must handle them identically."""
    rng = np.random.default_rng(21)
    cell = Cell(nof_prb=50, nof_ports=1, id=17)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = DynamicUeDl(cell, cfi=1)
    prbs = tuple(list(range(0, 6)) + list(range(18, 27)) + list(range(42, 50)))
    mcs = 11
    tbs = dl_tbs(mcs, len(prbs))
    grant = DlGrant(prb=prbs, mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=0x46)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    rx = _render(cell, ofdm, 3, grant, tb, rng)
    tb_hat, ok, _, _ = ue.decode(rx, 3, grant)
    assert ok
    np.testing.assert_array_equal(tb_hat, tb)
