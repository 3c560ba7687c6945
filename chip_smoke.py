#!/usr/bin/env python
"""Smoke run of the LTE PHY on an NVIDIA GPU, through the public package.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four        # four cards: the carriers mesh only

One-card phases, all at 20 MHz (100 PRB) unless stated:

  turbo   K=6144 x 1024 codeblocks at Eb/N0 1.6 dB: bits and CRC against
          what was sent; the Pallas MAP kernel against the XLA scan
          (static and dynamic-K: identical bits, posteriors within 2e-3),
          both timed
  dl      DL loopback window, W=128: generation -> channel -> decode, and
          the decode's stage times
  ul      UL loopback window, W=128: generation -> channel -> decode
  mimo    2-codeword TM4 decode window, W=64
  stack   the windowed full stack (25 PRB, W=64) attaches and carries IP
          both ways
  golden  the card-only tests (`pytest -m gpu`): the reference's captured
          I/Q decoded on the card, kernel-vs-scan parity

Every phase prints its result, its compile time and its steady median
time; a failed check exits non-zero.  The last line of standard output is
one JSON object naming the device.  No accelerator, or no package beside
this script, is an error: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NOISE_AMP = 0.09  # bench.py's operating point for host-generated windows
ONE_CARD = ("turbo", "dl", "ul", "mimo", "stack", "golden")
KERNEL = "pallas"  # the MAP kernel's backend name (compiled for the card)


def log(*a):
    print(*a, flush=True)


def check(ok, what="check failed"):
    """A failed check ends the run (unlike `assert`, also under -O)."""
    if not ok:
        raise RuntimeError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def timed(fn, *args, n: int = 20, warm: int = 2):
    """(first result, compile+first seconds, steady median seconds)."""
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return out, first, statistics.median(ts)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _turbo_llrs(rng, batch, k, ebn0):
    from srsran_tpu.phy.common import LTE_CRC24B
    from srsran_tpu.phy.crc import crc_attach_np
    from srsran_tpu.phy.fec.turbo import turbo_encode_np

    msgs = rng.integers(0, 2, (batch, k - 24)).astype(np.uint8)
    cbs = np.stack([crc_attach_np(m, LTE_CRC24B) for m in msgs])
    d = np.stack([turbo_encode_np(row) for row in cbs])
    sigma2 = 1.0 / (2.0 * (1.0 / 3.0) * 10 ** (ebn0 / 10))
    y = (1.0 - 2.0 * d.astype(np.float32)) + rng.standard_normal(
        d.shape).astype(np.float32) * np.sqrt(sigma2)
    return cbs, (-2.0 * y / sigma2).astype(np.float32)


def phase_turbo(rng, k=6144, batch=1024, parity_batch=256):
    import jax.numpy as jnp

    from srsran_tpu.phy.common import LTE_CRC24B
    from srsran_tpu.phy.crc import crc_matrix_np
    from srsran_tpu.phy.fec.turbo import auto_backend, turbo_decode

    if KERNEL == "pallas":  # on the card, "auto" must take the kernel
        check(auto_backend() == "pallas", f"auto took {auto_backend()}")
    cbs, llr_np = _turbo_llrs(rng, batch, k, 1.6)
    llr = jnp.asarray(llr_np)
    crc = jnp.asarray(crc_matrix_np(LTE_CRC24B, k).astype(np.float32))
    res = {}
    for be in (KERNEL, "scan", KERNEL):
        (bits, post, n_it), first, med = timed(
            lambda x, be=be: turbo_decode(x, k, 5, crc_table=crc,
                                          backend=be), llr)
        errs = int(np.sum(np.asarray(bits) != cbs))
        log(f"turbo[{be}] K={k} B={batch}: compile+first {first:.2f} s, "
            f"median {med * 1e3:.3f} ms ({batch * k / med / 1e6:.1f} Mbps), "
            f"iterations {int(n_it)}, bit errors {errs}")
        check(errs == 0, f"turbo[{be}]: {errs} bit errors")
        res.setdefault(be, []).append(med)
    # kernel vs scan at K=6144, B=256: identical bits, posteriors within
    # 2e-3 (max-log is exact max/add in float32; only the order of the
    # XLA scan's fused adds may differ)
    small = llr[:parity_batch]
    out = {be: turbo_decode(small, k, 5, crc_table=crc, backend=be)
           for be in (KERNEL, "scan")}
    np.testing.assert_array_equal(np.asarray(out[KERNEL][0]),
                                  np.asarray(out["scan"][0]))
    dmax = float(np.max(np.abs(np.asarray(out[KERNEL][1])
                               - np.asarray(out["scan"][1]))))
    check(dmax <= 2e-3, f"max |posterior diff| {dmax}")
    log(f"turbo parity K={k} B={parity_batch}: bits identical, "
        f"max |posterior diff| {dmax:.3g}")
    _turbo_dyn_parity(rng, k, parity_batch)
    return {"kernel_ms": min(res[KERNEL]) * 1e3,
            "scan_ms": res["scan"][0] * 1e3}


def _turbo_dyn_parity(rng, k_max, b):
    import jax.numpy as jnp

    from srsran_tpu.phy.common import LTE_CRC24A
    from srsran_tpu.phy.crc import crc_attach_np
    from srsran_tpu.phy.fec.cbsegm import qpp_interleaver_np
    from srsran_tpu.phy.fec.turbo import turbo_encode_np
    from srsran_tpu.phy.fec.turbo_dyn import crc_table_ab, turbo_decode_dyn

    ks = [k for k in (40, 512, 1056, 2048, 5824, 6080, 6144) if k <= k_max]
    d = np.zeros((b, 3, k_max + 4), np.float32)
    per = np.tile(np.arange(k_max, dtype=np.int32), (b, 1))
    inv = per.copy()
    k_vec = np.zeros(b, np.int32)
    msgs = []
    for i in range(b):
        k = ks[i % len(ks)]
        cb = crc_attach_np(rng.integers(0, 2, k - 24).astype(np.uint8),
                           LTE_CRC24A)
        msgs.append(cb)
        enc = turbo_encode_np(cb).astype(np.float32)
        d[i, :, : k + 4] = (2 * enc - 1) * 2 + rng.normal(0, 1.0, enc.shape)
        p = qpp_interleaver_np(k)
        per[i, :k] = p
        inv[i, p] = np.arange(k)
        k_vec[i] = k
    args = (jnp.asarray(d), jnp.asarray(k_vec), jnp.asarray(per),
            jnp.asarray(inv), jnp.asarray(np.ones(b, bool)))
    kw = dict(crc_table=jnp.asarray(crc_table_ab(k_max)),
              crc_is_b=jnp.asarray(np.zeros(b, bool)))
    out = {}
    for be in (KERNEL, "scan"):
        (bits, post, _), first, med = timed(
            lambda *a, be=be: turbo_decode_dyn(*a, k_max, 6, backend=be,
                                               **kw), *args, n=20)
        out[be] = (np.asarray(bits), np.asarray(post))
        log(f"turbo_dyn[{be}] mixed K, B={b}: compile+first {first:.2f} s, "
            f"median {med * 1e3:.3f} ms")
    np.testing.assert_array_equal(out[KERNEL][0], out["scan"][0])
    mask = np.arange(k_max)[None, :] < k_vec[:, None]
    dmax = float(np.max(np.abs(out[KERNEL][1] - out["scan"][1])[mask]))
    check(dmax <= 2e-3, f"max |posterior diff| {dmax}")
    for i in range(b):
        np.testing.assert_array_equal(out[KERNEL][0][i, : k_vec[i]],
                                      msgs[i])
    log(f"turbo_dyn parity: bits identical and exact, max |posterior diff| "
        f"{dmax:.3g}")


def _dl_mix(rng, w, prb):
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs

    sfs, grants, tbs = [], [], []
    while len(grants) < w:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 27))
        n = int(rng.integers(min(4, prb), prb + 1))
        st = int(rng.integers(0, prb + 1 - n))
        t = dl_tbs(mcs, n)
        if t == 0:
            continue
        sfs.append(sf_idx)
        grants.append(DlGrant(prb=tuple(range(st, st + n)),
                              mod=dl_mcs_to_mod(mcs), tbs=t, rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))
    return sfs, grants, tbs


def _check_all(tbs, res, what):
    for tb, r in zip(tbs, res):
        check(r[1], f"{what}: CRC failed")
        check(np.array_equal(r[0], tb), f"{what}: payload mismatch")


def phase_dl(rng, w=128, prb=100):
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.pipeline_window import (
        WindowedEnbDl, WindowedUeDl, window_channel)

    cell = Cell(nof_prb=prb, nof_ports=1, id=301)
    sfs, grants, tbs = _dl_mix(rng, w, prb)
    enb = WindowedEnbDl(cell, cfi=1, w=w)
    ue = WindowedUeDl(cell, cfi=1, w=w, max_iterations=6)
    h = np.array([[0.95 - 0.2j]], np.complex64)

    def link():
        rx = window_channel(enb.dispatch_window(tbs, sfs, grants), h,
                            noise_amp=0.02, seed=0)
        return ue.results(ue.dispatch_window(rx, sfs, grants))

    res, first, med = timed(link, n=10)
    _check_all(tbs, res, "DL loopback")
    log(f"dl: W={w} all {w} TBs CRC-ok and bit-exact "
        f"({sum(g.tbs for g in grants)} bits); compile+first {first:.2f} s, "
        f"median {med * 1e3:.2f} ms/window ({med / w * 1e3:.3f} ms/TTI)")
    rx = window_channel(enb.dispatch_window(tbs, sfs, grants), h,
                        noise_amp=0.02, seed=0)
    st = ue.stage_times(rx, sfs, grants, n=20)
    log(f"dl stages W={w}: " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in st.items()))
    return {f"stage_{k}_ms": v * 1e3 for k, v in st.items()}


def phase_ul(rng, w=128, prb=100):
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant
    from srsran_tpu.pipeline_window import (
        WindowedEnbUl, WindowedUeUl, window_channel)

    cell = Cell(nof_prb=prb, nof_ports=1, id=301)
    widths = tuple(n for n in (9, 25, 50, 96) if n <= prb) or (prb,)
    sfs, grants, tbs = [], [], []
    while len(grants) < w:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, prb + 1 - nprb))
        t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if t == 0:
            continue
        sfs.append(sf_idx)
        grants.append(UlGrant(prb_start=st, nof_prb=nprb,
                              mod=ul_mcs_to_mod(mcs), tbs=t, rv=0,
                              rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))
    ue = WindowedUeUl(cell, w=w)
    enb = WindowedEnbUl(cell, w=w, max_iterations=6)
    h = np.array([[0.9 + 0.25j]], np.complex64)

    def link():
        rx = window_channel(ue.dispatch_window(tbs, sfs, grants), h,
                            noise_amp=0.02, seed=0)
        return enb.results(enb.dispatch_window(rx, sfs, grants))

    res, first, med = timed(link, n=10)
    _check_all(tbs, res, "UL loopback")
    log(f"ul: W={w} all {w} TBs CRC-ok and bit-exact; compile+first "
        f"{first:.2f} s, median {med * 1e3:.2f} ms/window")
    return {}


def phase_mimo(rng, w=64, prb=100):
    import jax

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedUeDlMimo

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=prb, nof_ports=2, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    h = np.array([[1.0 + 0.1j, 0.25 - 0.55j],
                  [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
    mix = []
    with jax.default_device(cpu):  # the transmitter is host reference code
        while len(mix) < 16:
            sf_idx = int(rng.integers(0, 10))
            mcs1, mcs2 = int(rng.integers(4, 25)), int(rng.integers(4, 25))
            n = int(rng.integers(min(20, prb), prb + 1))
            st = int(rng.integers(0, prb + 1 - n))
            tbs1, tbs2 = dl_tbs(mcs1, n), dl_tbs(mcs2, n)
            if tbs1 == 0 or tbs2 == 0:
                continue
            grant = DlGrant2(prb=tuple(range(st, st + n)),
                             mod1=dl_mcs_to_mod(mcs1), tbs1=tbs1,
                             mod2=dl_mcs_to_mod(mcs2), tbs2=tbs2,
                             pmi=int(rng.integers(0, 3)), rnti=0x46)
            tb1 = rng.integers(0, 2, tbs1).astype(np.uint8)
            tb2 = rng.integers(0, 2, tbs2).astype(np.uint8)
            full = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol),
                            np.complex64)
            full += pdsch_encode2_np(cell, sf_idx, 1, grant, tb1, tb2)
            put_crs_np(full, cell, sf_idx)
            tx = np.asarray(ofdm_tx_sf(ofdm, full))
            rx = np.einsum("rp,pt->rt", h, tx)
            rx = (rx + NOISE_AMP / 2 * (rng.standard_normal(rx.shape) + 1j
                  * rng.standard_normal(rx.shape))).astype(np.complex64)
            mix.append((rx, sf_idx, grant, tb1, tb2))
    mm = (mix * (-(-w // len(mix))))[:w]
    samples = np.stack([m[0] for m in mm])
    sfs = [m[1] for m in mm]
    grants = [m[2] for m in mm]
    ue = WindowedUeDlMimo(cell, cfi=1, w=w, max_iterations=6)
    res, first, med = timed(
        lambda: ue.results(ue.dispatch_window(samples, sfs, grants)), n=10)
    n_ok = 0
    for m, r in zip(mm, res):
        for cw, tb in ((r[0], m[3]), (r[1], m[4])):
            if cw[1]:
                n_ok += 1
                check(np.array_equal(cw[0], tb), "MIMO codeword mismatch")
    check(n_ok >= 2 * w * 3 // 4, f"MIMO: only {n_ok}/{2 * w} codewords")
    log(f"mimo: W={w} {n_ok}/{2 * w} codewords CRC-ok, all bit-exact; "
        f"compile+first {first:.2f} s, median {med * 1e3:.2f} ms/window")
    return {}


def phase_stack(rng, w=64):
    import jax

    from srsran_tpu.apps.windowed_stack import (
        WindowedCtrlEnb, WindowedCtrlUe, WindowedDeviceLoopback)
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    imsi = "001010123456789"
    key = bytes.fromhex("00112233445566778899aabbccddeeff")
    opc = sec.compute_opc(key, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    dev = jax.devices()[0]
    cell = Cell(nof_prb=25, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", imsi, key, opc, amf=b"\x80\x00",
                                  sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    with jax.default_device(dev):
        enb = WindowedCtrlEnb(cell, mme, spgw, mcs=8, ctrl_window=w,
                              phy_device=dev)
        ue = WindowedCtrlUe(cell, Usim(imsi, key, opc), ctrl_window=w,
                            phy_device=dev)
        link = WindowedDeviceLoopback(enb, ue, snr_db=30.0)
        t = time.perf_counter()
        for tti in range(9000):
            link.step()
            if (ue.rrc_state == WindowedCtrlUe.RRC_ACTIVE
                    and ue.nas.state == ue.nas.REGISTERED):
                break
        check(ue.nas.state == ue.nas.REGISTERED, "attach failed")
        attach_s = time.perf_counter() - t
        spgw.sgi_rx.clear()
        n0 = len(ue.ip_rx)
        for i in range(24):
            spgw.sgi_tx(ue.ue_ip, bytes([i]) * 400)
        for i in range(8):
            ue.send_ip_packet(bytes([0x45, i]) * 60)
        t = time.perf_counter()
        for k in range(60 * w):
            link.step()
            if len(ue.ip_rx) - n0 >= 24 and len(spgw.sgi_rx) >= 8:
                break
        ip_s = time.perf_counter() - t
    check(len(ue.ip_rx) - n0 >= 24, f"DL IP: {len(ue.ip_rx) - n0}/24")
    check(len(spgw.sgi_rx) >= 8, f"UL IP: {len(spgw.sgi_rx)}/8")
    log(f"stack: REGISTERED at TTI {tti} ({attach_s:.2f} s incl. compiles); "
        f"24 DL + 8 UL IP packets delivered in {k + 1} TTIs ({ip_s:.2f} s, "
        f"{ip_s / (k + 1) * 1e3:.3f} ms/TTI)")
    return {}


def phase_golden(_rng):
    import pytest

    files = ["tests/test_golden_vectors.py", "tests/test_turbo.py",
             "tests/test_dynamic_pipeline.py"]
    t = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", "-o", "addopts=",
                      *[os.path.join(HERE, f) for f in files]])
    check(rc == 0, f"card-only tests failed (pytest exit {rc})")
    log(f"golden: card-only tests passed ({time.perf_counter() - t:.1f} s)")
    return {}


# --------------------------------------------------------------------------
# four cards: the carriers mesh
# --------------------------------------------------------------------------


def four_cards(rng, w=128, prb=100):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from srsran_tpu.parallel.halo import sharded_resample_fft
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.phy.resampling import resample_fft_blocks
    from srsran_tpu.pipeline import multi_carrier_ue_dl
    from srsran_tpu.pipeline_window import (
        WindowedEnbDl, WindowedUeDl, window_channel)

    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    mesh = Mesh(np.asarray(devs), ("carriers",))
    cell = Cell(nof_prb=prb, nof_ports=1, id=301)

    # (1) the DL loopback window sharded over the carriers mesh against
    # the same window on one card
    sfs, grants, tbs = _dl_mix(rng, w, prb)
    enb = WindowedEnbDl(cell, cfi=1, w=w)
    ue = WindowedUeDl(cell, cfi=1, w=w, max_iterations=6)
    h = np.array([[0.95 - 0.2j]], np.complex64)
    with jax.default_device(devs[0]):
        rx1 = window_channel(enb.dispatch_window(tbs, sfs, grants), h,
                             noise_amp=0.02, seed=0)
    shard = NamedSharding(mesh, P("carriers"))
    rx4 = jax.device_put(rx1, NamedSharding(mesh, P("carriers", None, None,
                                                    None)))
    packed1, first1, med1 = timed(
        lambda: ue.dispatch_window(rx1, sfs, grants).packed, n=10)
    packed4, first4, med4 = timed(
        lambda: ue.dispatch_window(rx4, sfs, grants, sharding=shard).packed,
        n=10)
    check("carriers" in str(packed4.sharding), packed4.sharding)
    check(np.array_equal(np.asarray(packed1), np.asarray(packed4)),
          "sharded window differs from one card")
    _check_all(tbs, ue.results(ue.dispatch_window(rx1, sfs, grants)),
               "one-card window")
    _check_all(tbs, ue.results(ue.dispatch_window(rx4, sfs, grants,
                                                  sharding=shard)),
               "sharded window")
    log(f"four: DL window W={w} sharded over 4 cards bit-exact with one "
        f"card, every TB CRC-ok and exact; one card median "
        f"{med1 * 1e3:.2f} ms, four {med4 * 1e3:.2f} ms (compile+first "
        f"{first1:.2f} / {first4:.2f} s)")

    # (2) multi_carrier_ue_dl: 4 carriers at 100 PRB, one per card
    tbs20 = dl_tbs(10, prb)
    g20 = DlGrant(prb=tuple(range(prb)), mod=Mod.QAM16, tbs=tbs20)
    tb20 = rng.integers(0, 2, tbs20).astype(np.uint8)
    with jax.default_device(jax.devices("cpu")[0]):
        grid = pdsch_encode_np(cell, 2, 1, g20, tb20)
        put_crs_np(grid, cell, 2)
        tx = np.asarray(ofdm_tx_sf(OfdmConfig.from_cell(cell, normalize=True),
                                   grid))
    s = np.tile(tx[None], (4, 1, 1)).astype(np.complex64)
    fn = multi_carrier_ue_dl(cell, 2, 1, g20, mesh=mesh)
    (tb_hat, ok, total), first, med = timed(fn, s, n=10)
    check(int(total) == 4 and np.asarray(ok).all(), "multi-carrier CRC")
    for c in range(4):
        np.testing.assert_array_equal(np.asarray(tb_hat)[c], tb20)
    ref = multi_carrier_ue_dl(cell, 2, 1, g20)(s)
    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(tb_hat))
    log(f"four: multi_carrier_ue_dl 4 x {prb} PRB all CRC-ok, equal to one "
        f"card; compile+first {first:.2f} s, median {med * 1e3:.2f} ms")

    # (3) halo-exchanged resampler against the unsharded one
    mesh_s = Mesh(np.asarray(devs), ("samples",))
    blk, halo = 4096, 64
    x = (rng.standard_normal(4 * blk)
         + 1j * rng.standard_normal(4 * blk)).astype(np.complex64)
    y = np.asarray(sharded_resample_fft(x.reshape(4, blk), 2, 1, mesh_s,
                                        halo=halo))
    ref = np.asarray(resample_fft_blocks(jnp.asarray(x.reshape(4, blk)), 2,
                                         1, halo=halo))
    err = float(np.max(np.abs(y - ref)))
    check(err <= 1e-4, f"resampler max |diff| {err}")
    log(f"four: halo-exchanged resampler max |diff| {err:.3g} (<= 1e-4)")


# --------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card carriers-mesh phases only")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    import jax

    import srsran_tpu

    pkg = os.path.dirname(os.path.abspath(srsran_tpu.__file__))
    if pkg != os.path.join(HERE, "srsran_tpu"):
        sys.exit(f"srsran_tpu is not beside this script (found {pkg})")
    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.four:
        four_cards(rng)
    else:
        summary = {}
        for name in ONE_CARD:
            t = time.perf_counter()
            summary[name] = globals()[f"phase_{name}"](rng)
            log(f"phase {name}: ok in {time.perf_counter() - t:.1f} s")
        log(f"summary: {json.dumps(summary)}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
