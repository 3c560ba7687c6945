#!/usr/bin/env python
"""Benchmark: per-chip throughput on every reference baseline row.

Reference numbers (README.md:29,47-49,65-67): >150 Mbps turbo decode,
75 Mbps UE DL 20 MHz SISO, 150 Mbps UE DL 20 MHz MIMO TM3/TM4,
50 Mbps eNB UL 20 MHz.  All decode benches run at an HONEST operating
point — ~1-2 dB above the config's measured waterfall (at ~40 dB SNR
turbo collapses to 1 iteration) —
calibrated on this pipeline: MCS26/QAM64 fails at noise amp 0.12,
passes at 0.10, so the headline runs at amp 0.09 (~18 dB chest SNR).

Additional round-2 metric: the dynamic-grant pipeline's real-time factor —
a scheduler-driven random grant mix (MCS 0-28 x random PRB allocations)
decoded with ZERO per-TTI recompiles, reported as decoded-TTIs/sec against
the 1 ms budget (cc_worker.cc:214-307 property).

Prints ONE JSON line: the headline metric, with every other row in
"all_metrics" (each with its own vs_baseline).  Runs on an NVIDIA GPU
only: it prints the card's name and power limit first, and exits with an
error when JAX finds no GPU.  Host-side signal generation (the per-TTI
reference transmitter) runs on the CPU device.
"""

import json
import os
import subprocess
import sys
import time

# the persistent compilation cache replays CPU AOT executables with a
# multi-KB machine-feature E-log per load (same-host, benign) — keep the
# bench output parseable
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import numpy as np

BASELINES = {
    "ue_dl_siso": 75.0,     # README.md:48
    "ue_dl_mimo": 150.0,    # README.md:47
    "ue_dl_siso_q256": 98.0,   # README.md:48 (QAM256)
    "ue_dl_mimo_q256": 195.0,  # README.md:47 (QAM256)
    "enb_dl": 75.0,         # README.md:66
    "enb_ul": 50.0,         # README.md:67
    "turbo": 150.0,         # README.md:29
    "dynamic_rtf": 1.0,     # real-time = 1 TTI / ms (cc_worker budget)
    "window_rtf": 1.0,      # same budget, windowed multi-TTI pipeline
    "window_onchip_rtf": 1.0,  # device-compute-only realtime factor
    "window_ul_rtf": 1.0,   # eNB-side windowed PUSCH (multi-UE uplink)
    "window_ul_onchip_rtf": 1.0,   # same, device-compute only
    "window_mimo_rtf": 1.0,  # 2-codeword TM4 windows (the 150 Mbps config)
    "window_mimo_onchip_rtf": 1.0,  # same, device-compute only
    "window_redrate_rtf": 1.0,  # 23.04 Msps reduced-rate ingest window
    "window_loopback_rtf": 1.0,  # eNB gen → on-chip channel → UE decode
    "window_ul_loopback_rtf": 1.0,  # UE PUSCH gen → channel → eNB decode
    "window_dlgen_rtf": 1.0,  # eNB DL GENERATION window (sf_worker TX half)
    "window_ulgen_rtf": 1.0,  # UE PUSCH GENERATION window (ue_ul TX half)
    "stack_window_rtf": 1.0,  # FULL STACK loop with the windowed data plane
    # the reference sustains one real-time 20 MHz carrier per machine;
    # this row is how many a single card sustains (full UE DL decode)
    "carriers_per_chip": 1.0,
    # multi-carrier WINDOWED dispatch (C carriers x T TTIs as one window):
    # sustained real-time 20 MHz carriers per chip
    # through the flagship windowed engine — headline at a typical
    # loaded-cell MCS (8), plus mid (16) and saturated (26,
    # turbo-throughput-bound) operating points
    "window_carriers_per_chip": 1.0,
    "window_carriers_per_chip_mcs16": 1.0,
    "window_carriers_per_chip_mcs26": 1.0,
}

NOISE_AMP = 0.09  # ~18 dB chest SNR at MCS26/QAM64 — 1-2 dB over waterfall


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(x):
    import jax.numpy as jnp

    # a scalar readback waits for the computation that produced x
    return float(jnp.sum(jnp.ravel(x)[:1].astype(jnp.float32)))


def measure(fn, arg, n=40, trials=3):
    # best of `trials` averages over n back-to-back calls and one sync
    r = fn(arg)
    sync(r)
    best = float("inf")
    for _ in range(trials):
        t = time.time()
        for _ in range(n):
            r = fn(arg)
        sync(r)
        best = min(best, (time.time() - t) / n)
    return best


def _awgn(rng, x, amp):
    return (x + amp * (rng.standard_normal(x.shape)
                       + 1j * rng.standard_normal(x.shape))).astype(np.complex64)


def bench_ue_dl_siso(jax, jnp, rng):
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import ue_dl_subframe

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    tbs = dl_tbs(26, 100)
    grant = DlGrant(prb=tuple(range(100)), mod=Mod.QAM64, tbs=tbs)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    with jax.default_device(cpu):
        grid = pdsch_encode_np(cell, 2, 1, grant, tb)
        put_crs_np(grid, cell, 2)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]

    B = 128
    s = _awgn(rng, np.tile(tx[None, None, :], (B, 1, 1)), NOISE_AMP)
    sri = jnp.asarray(np.stack([s.real, s.imag], -1).astype(np.float32))

    single = ue_dl_subframe(cell, 2, 1, grant, max_iterations=6)
    fn = jax.jit(
        lambda x: jax.vmap(single)(x[..., 0] + 1j * x[..., 1])[1].astype(jnp.int32)
    )
    t = time.time()
    nok = int(np.asarray(fn(sri)).sum())
    log(f"ue_dl_siso compile+first: {time.time()-t:.1f}s crc_ok={nok}/{B}")
    dt = measure(fn, sri)
    mbps = nok * tbs / dt / 1e6  # count only CRC-passing TBs (honest SNR)
    log(f"ue_dl_siso: {dt*1e3:.2f} ms for {B} x 20MHz sf (tbs {tbs}) -> {mbps:.1f} Mbps")
    # B subframes = B carrier-milliseconds of air time processed in dt
    return mbps, B * 1e-3 / dt


def bench_ue_dl_siso_q256(jax, jnp, rng):
    """20 MHz SISO QAM256 — the reference's 98 Mbps row (README.md:48).
    QAM256 needs ~8 dB more SNR than QAM64; amp 0.033 ≈ 26.6 dB chest
    SNR, 1-2 dB over this pipeline's MCS27/256QAM waterfall (0.045 sat
    ON the waterfall: 42/128 TBs)."""
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import ue_dl_subframe

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    tbs = dl_tbs(27, 100, use_256qam=True)
    grant = DlGrant(prb=tuple(range(100)), mod=Mod.QAM256, tbs=tbs)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    with jax.default_device(cpu):
        grid = pdsch_encode_np(cell, 2, 1, grant, tb)
        put_crs_np(grid, cell, 2)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]

    B = 128
    s = _awgn(rng, np.tile(tx[None, None, :], (B, 1, 1)), 0.033)
    sri = jnp.asarray(np.stack([s.real, s.imag], -1).astype(np.float32))

    single = ue_dl_subframe(cell, 2, 1, grant, max_iterations=6)
    fn = jax.jit(
        lambda x: jax.vmap(single)(x[..., 0] + 1j * x[..., 1])[1].astype(jnp.int32)
    )
    t = time.time()
    nok = int(np.asarray(fn(sri)).sum())
    log(f"ue_dl_siso_q256 compile+first: {time.time()-t:.1f}s crc_ok={nok}/{B}")
    dt = measure(fn, sri)
    mbps = nok * tbs / dt / 1e6
    log(f"ue_dl_siso_q256: {dt*1e3:.2f} ms for {B} sf (tbs {tbs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_ue_dl_mimo_q256(jax, jnp, rng):
    """20 MHz 2x2 TM4 QAM256 — the reference's 195 Mbps row
    (README.md:47)."""
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import ue_dl_subframe_mimo

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=2, id=301)
    tbs = dl_tbs(27, 100, use_256qam=True)
    grant = DlGrant2(prb=tuple(range(100)), mod1=Mod.QAM256, tbs1=tbs,
                     mod2=Mod.QAM256, tbs2=tbs, pmi=1)
    tb1 = rng.integers(0, 2, tbs).astype(np.uint8)
    tb2 = rng.integers(0, 2, tbs).astype(np.uint8)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    with jax.default_device(cpu):
        grid = pdsch_encode2_np(cell, 2, 1, grant, tb1, tb2)
        put_crs_np(grid, cell, 2)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))
    h = np.array([[1.0 + 0.1j, 0.25 - 0.55j],
                  [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
    rx1 = np.einsum("rp,pt->rt", h, tx)

    B = 64
    s = _awgn(rng, np.tile(rx1[None, :, :], (B, 1, 1)), 0.016)
    sri = jnp.asarray(np.stack([s.real, s.imag], -1).astype(np.float32))

    single = ue_dl_subframe_mimo(cell, 2, 1, grant, max_iterations=6)

    def run(x):
        (t1, ok1), (t2, ok2), _snr = single(x[..., 0] + 1j * x[..., 1])
        return ok1.astype(jnp.int32) + ok2.astype(jnp.int32)

    fn = jax.jit(lambda x: jax.vmap(run)(x))
    t = time.time()
    nok = int(np.asarray(fn(sri)).sum())
    log(f"ue_dl_mimo_q256 compile+first: {time.time()-t:.1f}s cw_ok={nok}/{2*B}")
    dt = measure(fn, sri)
    mbps = nok * tbs / dt / 1e6
    log(f"ue_dl_mimo_q256: {dt*1e3:.2f} ms for {B} x 2x2 sf (2 x tbs {tbs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_ue_dl_mimo(jax, jnp, rng):
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import ue_dl_subframe_mimo

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=2, id=301)
    # same MCS26 operating point as the SISO row (apples-to-apples per
    # codeword; r2 benched MCS25 here)
    tbs = dl_tbs(26, 100)
    grant = DlGrant2(prb=tuple(range(100)), mod1=Mod.QAM64, tbs1=tbs,
                     mod2=Mod.QAM64, tbs2=tbs, pmi=1)
    tb1 = rng.integers(0, 2, tbs).astype(np.uint8)
    tb2 = rng.integers(0, 2, tbs).astype(np.uint8)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    with jax.default_device(cpu):
        grid = pdsch_encode2_np(cell, 2, 1, grant, tb1, tb2)
        put_crs_np(grid, cell, 2)
        tx = np.asarray(ofdm_tx_sf(ofdm, grid))  # (2, sf_len)
    h = np.array([[1.0 + 0.1j, 0.25 - 0.55j],
                  [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)
    rx1 = np.einsum("rp,pt->rt", h, tx)

    B = 64
    s = _awgn(rng, np.tile(rx1[None, :, :], (B, 1, 1)), NOISE_AMP / 2)
    sri = jnp.asarray(np.stack([s.real, s.imag], -1).astype(np.float32))

    single = ue_dl_subframe_mimo(cell, 2, 1, grant, max_iterations=6)

    def run(x):
        (t1, ok1), (t2, ok2), _snr = single(x[..., 0] + 1j * x[..., 1])
        return ok1.astype(jnp.int32) + ok2.astype(jnp.int32)

    fn = jax.jit(lambda x: jax.vmap(run)(x))
    t = time.time()
    nok = int(np.asarray(fn(sri)).sum())
    log(f"ue_dl_mimo compile+first: {time.time()-t:.1f}s cw_ok={nok}/{2*B}")
    dt = measure(fn, sri)
    mbps = nok * tbs / dt / 1e6
    log(f"ue_dl_mimo: {dt*1e3:.2f} ms for {B} x 2x2 sf (2 x tbs {tbs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_enb_dl(jax, jnp, rng):
    """Full DL subframe ENCODE on device (sch.c:351 encode_tb + enb_dl.c
    render): CRC matmuls -> windowed device turbo encoder -> rate-match
    gathers -> scramble/modulate -> RE scatter -> CRS -> IFFT."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.modem import Mod
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_tbs
    from srsran_tpu.pipeline import enb_dl_subframe_encode

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    tbs = dl_tbs(26, 100)
    grant = DlGrant(prb=tuple(range(100)), mod=Mod.QAM64, tbs=tbs)
    B = 64
    tbs_all = jnp.asarray(rng.integers(0, 2, (B, tbs)).astype(np.uint8))
    single = enb_dl_subframe_encode(cell, 2, 1, grant)
    fn = jax.jit(lambda x: jnp.stack(
        [jnp.real(jax.vmap(single)(x)), ], 0)[0])
    t = time.time()
    sync(fn(tbs_all))
    log(f"enb_dl compile+first: {time.time()-t:.1f}s")
    dt = measure(fn, tbs_all)
    mbps = B * tbs / dt / 1e6
    log(f"enb_dl: {dt*1e3:.2f} ms for {B} x 20MHz encode (tbs {tbs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_enb_ul(jax, jnp, rng):
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline import enb_ul_subframe

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    mcs = 20
    nprb = 96
    tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
    grant = UlGrant(prb_start=1, nof_prb=nprb, mod=ul_mcs_to_mod(mcs),
                    tbs=tbs, rv=0, rnti=0x46)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    with jax.default_device(cpu):
        tx = np.asarray(ue_ul_encode(cell, 2, pusch=(grant, tb)))

    B = 128
    s = _awgn(rng, np.tile(tx[None, None, :], (B, 1, 1)), NOISE_AMP)
    sri = jnp.asarray(np.stack([s.real, s.imag], -1).astype(np.float32))

    single = enb_ul_subframe(cell, 2, grant, max_iterations=6)
    fn = jax.jit(
        lambda x: jax.vmap(single)(x[..., 0] + 1j * x[..., 1])[1].astype(jnp.int32)
    )
    t = time.time()
    nok = int(np.asarray(fn(sri)).sum())
    log(f"enb_ul compile+first: {time.time()-t:.1f}s crc_ok={nok}/{B}")
    dt = measure(fn, sri)
    mbps = nok * tbs / dt / 1e6
    log(f"enb_ul: {dt*1e3:.2f} ms for {B} x 20MHz PUSCH sf (tbs {tbs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_turbo(jax, jnp, rng):
    from srsran_tpu.phy.common import LTE_CRC24B
    from srsran_tpu.phy.crc import crc_attach_np, crc_matrix_np
    from srsran_tpu.phy.fec.turbo import turbo_decode, turbo_encode_np

    k = 6144
    batch = 1024  # the per-card serving configuration decodes many UEs'
    # CBs per dispatch
    msgs = rng.integers(0, 2, (batch, k - 24)).astype(np.uint8)
    cbs = np.stack([crc_attach_np(m, LTE_CRC24B) for m in msgs])
    d = np.stack([turbo_encode_np(row) for row in cbs])
    ebn0 = 1.6
    sigma2 = 1.0 / (2.0 * (1.0 / 3.0) * 10 ** (ebn0 / 10))
    y = (1.0 - 2.0 * d.astype(np.float32)) + rng.standard_normal(d.shape).astype(
        np.float32
    ) * np.sqrt(sigma2)
    llr = jnp.asarray((-2.0 * y / sigma2).astype(np.float32))
    crc_table = jnp.asarray(crc_matrix_np(LTE_CRC24B, k).astype(np.float32))

    def run(x):
        bits, post, n_it = turbo_decode(x, k, 5, crc_table=crc_table)
        return bits

    bits = run(llr)
    sync(bits)
    errs = int(np.sum(np.asarray(bits) != cbs))
    dt = measure(run, llr)
    mbps = batch * k / dt / 1e6
    log(f"turbo-only: {dt*1e3:.2f} ms for {batch} CBs of {k} (bit errors {errs}) -> {mbps:.1f} Mbps")
    return mbps


def bench_dynamic_rtf(jax, jnp, rng):
    """Scheduler-driven random grant mix through the dynamic pipeline:
    decoded TTIs per second / 1000 = real-time factor (>=1 keeps up with
    the air interface), with zero per-TTI recompiles in steady state."""
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_dynamic import DynamicUeDl

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    ue = DynamicUeDl(cell, cfi=1, max_iterations=6)

    mix = []
    with jax.default_device(cpu):
        for i in range(16):
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 27))
            l = int(rng.integers(4, 101))
            st = int(rng.integers(0, 101 - l))
            tbs = dl_tbs(mcs, l)
            if tbs == 0:
                continue
            grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                            tbs=tbs, rnti=0x46)
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
            put_crs_np(grid, cell, sf_idx)
            tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
            rx = _awgn(rng, tx[None, :], NOISE_AMP)
            mix.append((rx, sf_idx, grant, tbs))

    # warm every bucket (the bounded compile set)
    t = time.time()
    n_ok = 0
    for rx, sf_idx, grant, _ in mix:
        _, ok, _, _ = ue.decode(rx, sf_idx, grant)
        n_ok += int(ok)
    log(f"dynamic warm pass: {time.time()-t:.1f}s ok={n_ok}/{len(mix)} "
        f"compiles a/b/c = {ue.stats['compiles_a']}/{ue.stats['compiles_b']}/{ue.stats['compiles_c']}")
    compiles_before = ue.total_compiles
    # steady state: same mix again, no recompiles; 4 TTIs in flight via
    # the async API (the reference's own sf_worker pipeline depth,
    # thread_pool.h:46-77 — TX at TTI+4)
    from collections import deque

    best = float("inf")
    for _ in range(3):
        pend = deque()
        t = time.time()
        for rx, sf_idx, grant, _ in mix:
            pend.append(ue.decode_async(rx, sf_idx, grant))
            if len(pend) > 3:
                ue.result(pend.popleft())
        while pend:
            ue.result(pend.popleft())
        best = min(best, (time.time() - t) / len(mix))
    assert ue.total_compiles == compiles_before, "steady state recompiled!"
    rtf = 1e-3 / best
    bits = sum(t for *_x, t in mix)
    log(f"dynamic_rtf: {best*1e3:.2f} ms/TTI over {len(mix)}-grant mix "
        f"(~{bits/len(mix)/1e3:.0f} kbit/TTI avg, 4 TTIs in flight) -> "
        f"real-time factor {rtf:.2f}x, 0 steady-state compiles")
    return rtf


def bench_window_rtf(jax, jnp, rng):
    """The windowed dynamic pipeline (pipeline_window.WindowedUeDl): W TTIs
    of arbitrary grants per dispatch through ONE fixed program set, int8
    sample ingest, one packed readback per window, 4 windows in flight."""
    from collections import deque

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedUeDl

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    W = 128  # amortizes per-window host prep

    mix = []
    with jax.default_device(cpu):
        while len(mix) < 16:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 27))
            l = int(rng.integers(4, 101))
            st = int(rng.integers(0, 101 - l))
            tbs = dl_tbs(mcs, l)
            if tbs == 0:
                continue
            grant = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                            tbs=tbs, rnti=0x46)
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
            put_crs_np(grid, cell, sf_idx)
            tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
            rx = _awgn(rng, tx[None, :], NOISE_AMP)[0]
            mix.append((rx, sf_idx, grant, tb))

    mm = (mix * (-(-W // len(mix))))[:W]
    samples = np.stack([m[0] for m in mm])[:, None, :]
    sfs = [m[1] for m in mm]
    grants = [m[2] for m in mm]
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=6)
    t = time.time()
    res, _ = ue.decode_window(samples, sfs, grants)
    n_ok = sum(r[1] for r in res)
    log(f"window compile+first: {time.time()-t:.1f}s ok={n_ok}/{W}")
    for m, r in zip(mm, res):
        if r[1]:
            assert np.array_equal(r[0], m[3]), "window payload mismatch"
    pend = deque()
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            pend.append(ue.dispatch_window(samples, sfs, grants))
            if len(pend) > 3:
                ue.results(pend.popleft())
        while pend:
            ue.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_rtf: W={W} {best*1e3:.1f} ms/window -> {best/W*1e3:.2f} ms/TTI "
        f"-> {rtf:.2f}x realtime")

    # --- device time per stage (the cc_worker.cc 1 ms budget question,
    # without host ingest): per-stage timings through the SAME staged
    # plan dispatch_window runs (pipeline_window.WindowedUeDl.stage_times)
    parts = ue.stage_times(samples, sfs, grants)
    onchip_ms = sum(parts.values()) * 1e3 / W
    log(f"window on-chip: A={parts['A']*1e3:.1f} B={parts['B']*1e3:.1f} "
        f"C={parts['C']*1e3:.1f} ms/window -> {onchip_ms:.2f} ms/TTI")
    return rtf, 1.0 / onchip_ms, parts


def bench_window_mimo_rtf(jax, jnp, rng):
    """2-codeword TM4 windows (the 150 Mbps headline config on the
    dynamic path): W TTIs of mixed-PMI/MCS DlGrant2 per dispatch."""
    from collections import deque

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant2, pdsch_encode2_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedUeDlMimo

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=2, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    W = 64
    h = np.array([[1.0 + 0.1j, 0.25 - 0.55j],
                  [-0.45 + 0.3j, 0.95 + 0.05j]], np.complex64)

    mix = []
    with jax.default_device(cpu):
        while len(mix) < 16:
            sf_idx = int(rng.integers(0, 10))
            mcs1 = int(rng.integers(4, 25))
            mcs2 = int(rng.integers(4, 25))
            l = int(rng.integers(20, 101))
            st = int(rng.integers(0, 101 - l))
            tbs1, tbs2 = dl_tbs(mcs1, l), dl_tbs(mcs2, l)
            if tbs1 == 0 or tbs2 == 0:
                continue
            grant = DlGrant2(prb=tuple(range(st, st + l)),
                             mod1=dl_mcs_to_mod(mcs1), tbs1=tbs1,
                             mod2=dl_mcs_to_mod(mcs2), tbs2=tbs2,
                             pmi=int(rng.integers(0, 3)), rnti=0x46)
            tb1 = rng.integers(0, 2, tbs1).astype(np.uint8)
            tb2 = rng.integers(0, 2, tbs2).astype(np.uint8)
            grid = pdsch_encode2_np(cell, sf_idx, 1, grant, tb1, tb2)
            full = np.zeros((2, cell.nsymb_per_sf, cell.nof_re_per_symbol),
                            np.complex64)
            full += grid
            put_crs_np(full, cell, sf_idx)
            tx = np.asarray(ofdm_tx_sf(ofdm, full))
            rx = np.einsum("rp,pt->rt", h, tx)
            rx = _awgn(rng, rx, NOISE_AMP / 2)
            mix.append((rx, sf_idx, grant, tb1, tb2))

    mm = (mix * (-(-W // len(mix))))[:W]
    samples = np.stack([m[0] for m in mm])
    sfs = [m[1] for m in mm]
    grants = [m[2] for m in mm]
    ue = WindowedUeDlMimo(cell, cfi=1, w=W, max_iterations=6)
    t = time.time()
    res, _ = ue.decode_window(samples, sfs, grants)
    n_ok = sum(r[0][1] + r[1][1] for r in res)
    log(f"window_mimo compile+first: {time.time()-t:.1f}s cw_ok={n_ok}/{2*W}")
    for m, r in zip(mm, res):
        if r[0][1]:
            assert np.array_equal(r[0][0], m[3]), "mimo cw1 mismatch"
        if r[1][1]:
            assert np.array_equal(r[1][0], m[4]), "mimo cw2 mismatch"
    pend = deque()
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 4
        for _ in range(n):
            pend.append(ue.dispatch_window(samples, sfs, grants))
            if len(pend) > 3:
                ue.results(pend.popleft())
        while pend:
            ue.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_mimo_rtf: W={W} {best/W*1e3:.2f} ms/TTI (2 codewords each) "
        f"-> {rtf:.2f}x realtime")
    parts = ue.stage_times(samples, sfs, grants)
    onchip_ms = sum(parts.values()) * 1e3 / W
    log(f"window_mimo on-chip: A={parts['A']*1e3:.1f} B={parts['B']*1e3:.1f} "
        f"C={parts['C']*1e3:.1f} ms/window -> {onchip_ms:.2f} ms/TTI")
    return rtf, 1.0 / onchip_ms


def bench_window_redrate_rtf(jax, jnp, rng):
    """20 MHz ingest at the REDUCED 23.04 Msps rate (1536-FFT — the
    reference's own ZMQ default, rf_zmq_imp.h ZMQ_BASERATE_DEFAULT_HZ,
    and srslte_symbol_sz's use_standard_rates=false table): 46.1 MB/s
    of int8 I/Q instead of 61.4 MB/s at 30.72 Msps."""
    from collections import deque

    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedUeDl

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301, use_standard_rates=False)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    W = 128

    mix = []
    with jax.default_device(cpu):
        while len(mix) < 16:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 27))
            l = int(rng.integers(4, 101))
            st = int(rng.integers(0, 101 - l))
            tbs = dl_tbs(mcs, l)
            if tbs == 0:
                continue
            grant = DlGrant(prb=tuple(range(st, st + l)),
                            mod=dl_mcs_to_mod(mcs), tbs=tbs, rnti=0x46)
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            grid = pdsch_encode_np(cell, sf_idx, 1, grant, tb)
            put_crs_np(grid, cell, sf_idx)
            tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
            rx = _awgn(rng, tx[None, :], NOISE_AMP)[0]
            mix.append((rx, sf_idx, grant, tb))

    mm = (mix * (-(-W // len(mix))))[:W]
    samples = np.stack([m[0] for m in mm])[:, None, :]
    sfs = [m[1] for m in mm]
    grants = [m[2] for m in mm]
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=6)
    t = time.time()
    res, _ = ue.decode_window(samples, sfs, grants)
    n_ok = sum(r[1] for r in res)
    log(f"window_redrate compile+first: {time.time()-t:.1f}s ok={n_ok}/{W}")
    for m, r in zip(mm, res):
        if r[1]:
            assert np.array_equal(r[0], m[3]), "redrate payload mismatch"
    pend = deque()
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            pend.append(ue.dispatch_window(samples, sfs, grants))
            if len(pend) > 3:
                ue.results(pend.popleft())
        while pend:
            ue.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_redrate_rtf: W={W} {best/W*1e3:.2f} ms/TTI -> "
        f"{rtf:.2f}x realtime (23.04 Msps int8 ingest)")
    return rtf


def bench_window_loopback_rtf(jax, jnp, rng):
    """The full eNB→UE DL link with baseband RESIDENT on the device:
    generation window → on-device flat channel+AWGN → decode window via
    the device-ingest path.  Only payload bits cross the host link (~8x
    less traffic than raw-sample ingest).  The serving topology matching
    the reference's single-host srsenb↔srsue ZMQ loopback
    (lib/src/phy/rf/rf_zmq_imp.c), with the sample hand-off in device
    memory instead of a socket."""
    from collections import deque

    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import (
        WindowedEnbDl, WindowedUeDl, window_channel)

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    W = 128   # amortizes per-window host prep + dispatch
    sfs, grants, tbs = [], [], []
    while len(grants) < W:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 27))
        l = int(rng.integers(4, 101))
        st = int(rng.integers(0, 101 - l))
        t = dl_tbs(mcs, l)
        if t == 0:
            continue
        sfs.append(sf_idx)
        grants.append(DlGrant(prb=tuple(range(st, st + l)),
                              mod=dl_mcs_to_mod(mcs), tbs=t, rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))

    enb = WindowedEnbDl(cell, cfi=1, w=W)
    ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=6)
    h = np.array([[0.95 - 0.2j]], np.complex64)

    def one(seed=0):
        tx = enb.dispatch_window(tbs, sfs, grants)
        rx = window_channel(tx, h, noise_amp=0.02, seed=seed)
        return ue.dispatch_window(rx, sfs, grants)

    t = time.time()
    res = ue.results(one())
    n_ok = sum(r[1] for r in res)
    log(f"window_loopback compile+first: {time.time()-t:.1f}s ok={n_ok}/{W}")
    for tb, r in zip(tbs, res):
        assert r[1], "loopback CRC failed"
        assert np.array_equal(r[0], tb), "loopback payload mismatch"

    pend = deque()
    best = float("inf")
    bits = sum(g.tbs for g in grants)
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            pend.append(one())
            if len(pend) > 3:
                ue.results(pend.popleft())
        while pend:
            ue.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_loopback_rtf: W={W} {best/W*1e3:.2f} ms/TTI "
        f"({bits/W/1e3:.0f} kbit/TTI avg) -> {rtf:.2f}x realtime "
        f"({bits*rtf/(W*1e3):.0f} Mbps through the full gen+decode link)")
    return rtf


def bench_window_ul_loopback_rtf(jax, jnp, rng):
    """The UL mirror of window_loopback_rtf: UE PUSCH generation window →
    on-chip channel → eNB UL decode window, baseband resident in HBM;
    only payload bits and decoded TBs cross the host link."""
    from collections import deque

    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant
    from srsran_tpu.pipeline_window import (
        WindowedEnbUl, WindowedUeUl, window_channel)

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    W = 128
    widths = (9, 25, 50, 96)
    sfs, grants, tbs = [], [], []
    while len(grants) < W:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, 101 - nprb))
        t = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if t == 0:
            continue
        sfs.append(sf_idx)
        grants.append(UlGrant(prb_start=st, nof_prb=nprb,
                              mod=ul_mcs_to_mod(mcs), tbs=t, rv=0,
                              rnti=0x46))
        tbs.append(rng.integers(0, 2, t).astype(np.uint8))

    ue = WindowedUeUl(cell, w=W)
    enb = WindowedEnbUl(cell, w=W, max_iterations=6)
    h = np.array([[0.9 + 0.25j]], np.complex64)

    def one(seed=0):
        tx = ue.dispatch_window(tbs, sfs, grants)
        rx = window_channel(tx, h, noise_amp=0.02, seed=seed)
        return enb.dispatch_window(rx, sfs, grants)

    t = time.time()
    res = enb.results(one())
    n_ok = sum(r[1] for r in res)
    log(f"window_ul_loopback compile+first: {time.time()-t:.1f}s ok={n_ok}/{W}")
    for tb, r in zip(tbs, res):
        assert r[1], "UL loopback CRC failed"
        assert np.array_equal(r[0], tb), "UL loopback payload mismatch"

    pend = deque()
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            pend.append(one())
            if len(pend) > 3:
                enb.results(pend.popleft())
        while pend:
            enb.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_ul_loopback_rtf: W={W} {best/W*1e3:.2f} ms/TTI -> "
        f"{rtf:.2f}x realtime")
    return rtf


def bench_window_dlgen_rtf(jax, jnp, rng):
    """eNB DL data-subframe GENERATION window (pipeline_window.
    WindowedEnbDl): W TTIs of arbitrary grants encoded per dispatch —
    payload→CRC/segment→dynamic-K closed-form turbo→class-shared TX rate
    match→modulate→grid+IFFT.  Timed to a 1-scalar sync (the baseband
    stays device-side, as it would feed a device-adjacent radio)."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.pdsch import DlGrant
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedEnbDl

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    W = 64
    enb = WindowedEnbDl(cell, cfi=1, w=W)
    mix = []
    while len(mix) < 16:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 27))
        l = int(rng.integers(4, 101))
        st = int(rng.integers(0, 101 - l))
        tbs = dl_tbs(mcs, l)
        if tbs == 0:
            continue
        g = DlGrant(prb=tuple(range(st, st + l)), mod=dl_mcs_to_mod(mcs),
                    tbs=tbs, rnti=0x46)
        mix.append((sf_idx, g, rng.integers(0, 2, tbs).astype(np.uint8)))
    mm = (mix * (-(-W // len(mix))))[:W]
    sfs = [m[0] for m in mm]
    grants = [m[1] for m in mm]
    tbs_list = [m[2] for m in mm]

    t = time.time()
    out = enb.dispatch_window(tbs_list, sfs, grants)
    sync(out)
    log(f"window_dlgen compile+first: {time.time()-t:.1f}s")
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            out = enb.dispatch_window(tbs_list, sfs, grants)
        sync(out)
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    bits = sum(g.tbs for g in grants)
    log(f"window_dlgen_rtf: W={W} {best*1e3:.1f} ms/window -> "
        f"{best/W*1e3:.2f} ms/TTI -> {rtf:.2f}x realtime "
        f"({bits/best/1e6:.0f} Mbps generated)")
    return rtf


def bench_window_ulgen_rtf(jax, jnp, rng):
    """UE PUSCH GENERATION window (pipeline_window.WindowedUeUl): W TTIs
    of mixed-width/MCS UL grants encoded per dispatch through the shared
    codeword core + Bluestein DFT precoding.  Timed to a 1-scalar sync
    (baseband stays device-side)."""
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.pusch import UlGrant
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.pipeline_window import WindowedUeUl

    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    W = 64
    ue = WindowedUeUl(cell, w=W)
    widths = (9, 25, 50, 96)
    mix = []
    while len(mix) < 16:
        sf_idx = int(rng.integers(0, 10))
        mcs = int(rng.integers(0, 24))
        nprb = int(widths[rng.integers(0, len(widths))])
        st = int(rng.integers(0, 101 - nprb))
        tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
        if tbs == 0:
            continue
        g = UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs),
                    tbs=tbs, rv=0, rnti=0x46)
        mix.append((sf_idx, g, rng.integers(0, 2, tbs).astype(np.uint8)))
    mm = (mix * (-(-W // len(mix))))[:W]
    sfs = [m[0] for m in mm]
    grants = [m[1] for m in mm]
    tbs_list = [m[2] for m in mm]

    t = time.time()
    out = ue.dispatch_window(tbs_list, sfs, grants)
    sync(out)
    log(f"window_ulgen compile+first: {time.time()-t:.1f}s")
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 6
        for _ in range(n):
            out = ue.dispatch_window(tbs_list, sfs, grants)
        sync(out)
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_ulgen_rtf: W={W} {best*1e3:.1f} ms/window -> "
        f"{best/W*1e3:.2f} ms/TTI -> {rtf:.2f}x realtime")
    return rtf


def bench_window_ul_rtf(jax, jnp, rng):
    """eNB-side windowed PUSCH: W mixed-width/MCS UL grants per dispatch
    (multi-UE uplink), Bluestein IDFT de-precoding, shared stage C."""
    from collections import deque

    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.phch.ra import tbs_lookup, ul_mcs_to_itbs, ul_mcs_to_mod
    from srsran_tpu.phy.ue.ue_ul import UlGrant, ue_ul_encode
    from srsran_tpu.pipeline_window import WindowedEnbUl

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    W = 64
    widths = (9, 25, 50, 96)
    mix = []
    with jax.default_device(cpu):
        while len(mix) < 16:
            sf_idx = int(rng.integers(0, 10))
            mcs = int(rng.integers(0, 24))
            nprb = int(widths[rng.integers(0, len(widths))])
            st = int(rng.integers(0, 101 - nprb))
            tbs = tbs_lookup(ul_mcs_to_itbs(mcs), nprb)
            if tbs == 0:
                continue
            g = UlGrant(prb_start=st, nof_prb=nprb, mod=ul_mcs_to_mod(mcs),
                        tbs=tbs, rv=0, rnti=0x46)
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            tx = np.asarray(ue_ul_encode(cell, sf_idx, pusch=(g, tb)))
            rx = _awgn(rng, tx[None, :], 0.05)[0]
            mix.append((rx, sf_idx, g, tb))

    mm = (mix * (-(-W // len(mix))))[:W]
    samples = np.stack([m[0] for m in mm])[:, None, :]
    sfs = [m[1] for m in mm]
    grants = [m[2] for m in mm]
    enb = WindowedEnbUl(cell, w=W, max_iterations=6)
    t = time.time()
    res, _ = enb.decode_window(samples, sfs, grants)
    n_ok = sum(r[1] for r in res)
    log(f"window_ul compile+first: {time.time()-t:.1f}s ok={n_ok}/{W}")
    for m, r in zip(mm, res):
        if r[1]:
            assert np.array_equal(r[0], m[3]), "window UL payload mismatch"
    pend = deque()
    best = float("inf")
    for _ in range(3):
        t = time.time()
        n = 4
        for _ in range(n):
            pend.append(enb.dispatch_window(samples, sfs, grants))
            if len(pend) > 3:
                enb.results(pend.popleft())
        while pend:
            enb.results(pend.popleft())
        best = min(best, (time.time() - t) / n)
    rtf = 1e-3 / (best / W)
    log(f"window_ul_rtf: W={W} {best/W*1e3:.2f} ms/TTI -> {rtf:.2f}x realtime")
    parts = enb.stage_times(samples, sfs, grants)
    onchip_ms = sum(parts.values()) * 1e3 / W
    log(f"window_ul on-chip: A={parts['A']*1e3:.1f} B={parts['B']*1e3:.1f} "
        f"C={parts['C']*1e3:.1f} ms/window -> {onchip_ms:.2f} ms/TTI")
    return rtf, 1.0 / onchip_ms


def bench_window_carriers(jax, jnp, rng):
    """Multi-carrier windowed dispatch: C=8 20 MHz
    carriers x T=16 TTIs ride ONE W=128 window through the flagship
    engine — the carriers axis is just more window rows, so per-window
    fixed costs amortize across carriers exactly like the reference's
    per-cc_worker loop amortizes thread overhead (sf_worker.cc:198).
    Reports sustained real-time carriers/chip on-chip at mcs16 (typical
    CQI-adapted load) and mcs26 (saturated; turbo-throughput-bound)."""
    from srsran_tpu.phy.chest.refsignal_dl import put_crs_np
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.phy.ofdm import OfdmConfig, ofdm_tx_sf
    from srsran_tpu.phy.phch.pdsch import DlGrant, pdsch_encode_np
    from srsran_tpu.phy.phch.ra import dl_mcs_to_mod, dl_tbs
    from srsran_tpu.pipeline_window import WindowedUeDl

    cpu = jax.devices("cpu")[0]
    cell = Cell(nof_prb=100, nof_ports=1, id=301)
    ofdm = OfdmConfig.from_cell(cell, normalize=True)
    W = 128  # 8 carriers x 16 TTIs
    out = {}
    for label, mcs in (("mcs8", 8), ("mcs16", 16), ("mcs26", 26)):
        tbs = dl_tbs(mcs, 100)
        grant = DlGrant(prb=tuple(range(100)), mod=dl_mcs_to_mod(mcs),
                        tbs=tbs, rnti=0x46)
        with jax.default_device(cpu):
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            grid = pdsch_encode_np(cell, 2, 1, grant, tb)
            put_crs_np(grid, cell, 2)
            tx = np.asarray(ofdm_tx_sf(ofdm, grid))[0]
        s = _awgn(rng, np.tile(tx[None, None, :], (W, 1, 1)), 0.05)
        ue = WindowedUeDl(cell, cfi=1, w=W, max_iterations=5)
        res, _ = ue.decode_window(s, [2] * W, [grant] * W)
        n_ok = sum(r[1] for r in res)
        parts = ue.stage_times(s, [2] * W, [grant] * W)
        onchip = sum(parts.values())
        cars = W * 1e-3 / onchip
        log(f"window_carriers {label}: ok={n_ok}/{W} stage "
            f"A={parts['A']*1e3:.1f} B={parts['B']*1e3:.1f} "
            f"C={parts['C']*1e3:.1f} ms/window -> "
            f"{cars:.1f} carriers/chip on-chip "
            f"({n_ok * tbs / onchip / 1e6:.0f} Mbps aggregate)")
        assert n_ok >= W * 3 // 4, f"window_carriers {label}: too many KOs"
        out[label] = cars
    return out["mcs8"], out["mcs16"], out["mcs26"]


def bench_stack_window_rtf(jax, jnp, rng):
    """The full stack (attach + saturated DL + periodic UL) with the
    WINDOWED CONTROL PLANE (apps.windowed_stack): every PHY step —
    control and data, both directions — runs in W-TTI device windows
    over the device-resident loopback link; the host does only queue
    bookkeeping and byte-level MAC/RLC work (reference bar: the whole eNB
    worker fits 1 ms/TTI, srsenb/src/phy/sf_worker.cc:166)."""
    from srsran_tpu.apps.windowed_stack import (
        WindowedCtrlEnb, WindowedCtrlUe, WindowedDeviceLoopback)
    from srsran_tpu.epc import Hss, Mme, Spgw, Subscriber
    from srsran_tpu.phy.common import Cell
    from srsran_tpu.stack import security as sec
    from srsran_tpu.stack.nas_ue import Usim

    IMSI = "001010123456789"
    KEY = bytes.fromhex("00112233445566778899aabbccddeeff")
    OPC = sec.compute_opc(KEY, bytes.fromhex("63bfa50ee6523365ff14c1f45f88737d"))
    dev = jax.devices()[0]
    cell = Cell(nof_prb=25, nof_ports=1, id=7)
    hss = Hss()
    hss.add_subscriber(Subscriber("ue1", IMSI, KEY, OPC, amf=b"\x80\x00", sqn=0))
    spgw = Spgw()
    mme = Mme(hss, spgw)
    W = 64
    with jax.default_device(dev):
        enb = WindowedCtrlEnb(cell, mme, spgw, mcs=8, ctrl_window=W,
                              phy_device=dev)
        ue = WindowedCtrlUe(cell, Usim(IMSI, KEY, OPC), ctrl_window=W,
                            phy_device=dev)
        link = WindowedDeviceLoopback(enb, ue, snr_db=30.0)
        t = time.time()
        for tti in range(9000):
            link.step()
            if (ue.rrc_state == WindowedCtrlUe.RRC_ACTIVE
                    and ue.nas.state == ue.nas.REGISTERED):
                break
        assert ue.nas.state == ue.nas.REGISTERED, "attach failed"
        log(f"stack_window attach: tti {tti}, {time.time()-t:.1f}s "
            "(incl compiles)")
        # sustained saturation: refill the offered load every 64 TTIs so
        # the warm loop compiles EXACTLY the window shapes the timed
        # region runs (a draining queue late in the measurement creates
        # fresh empty-window shapes — each one a recompile)
        def offer(k):
            if k % 64 == 0:
                for i in range(48):
                    spgw.sgi_tx(ue.ue_ip, bytes([(k + i) & 0xFF]) * 400)
                ue.send_ip_packet(bytes([0x45, k & 0xFF]) * 200)

        for k in range(20 * W):  # >= 4 full sf-pattern cycles of shapes
            offer(k)
            link.step()
        n = 10 * W
        t = time.time()
        for k in range(n):
            offer(k)
            link.step()
        dt = (time.time() - t) / n
    rtf = 1e-3 / dt
    log(f"stack_window_rtf: {dt*1e3:.2f} ms/TTI -> {rtf:.3f}x realtime; "
        f"W={W}, ip_rx {len(ue.ip_rx)}, dl_tbs_ok {ue.stats['dl_tbs_ok']}, "
        f"ul_crc_ok {enb.stats.get('ul_crc_ok', 0)}, "
        f"ctrl_windows {ue.stats['ctrl_windows']}")
    return rtf


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX backend is "
                 f"{jax.default_backend()!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    log(f"card: {card.strip()}")
    dev = jax.devices()[0]
    log(f"device: {dev} platform={dev.platform} kind={dev.device_kind}")

    rng = np.random.default_rng(0)
    results = {}
    stage_parts = None
    for name, fn in (
        # the full-stack loop runs FIRST: it keeps ~10 windows of grids
        # in flight, and after the 20 MHz benches' accumulated device
        # caches it can run out of device memory
        ("stack_window_rtf", bench_stack_window_rtf),
        ("ue_dl_siso", bench_ue_dl_siso),
        ("ue_dl_mimo", bench_ue_dl_mimo),
        ("ue_dl_siso_q256", bench_ue_dl_siso_q256),
        ("ue_dl_mimo_q256", bench_ue_dl_mimo_q256),
        ("enb_dl", bench_enb_dl),
        ("enb_ul", bench_enb_ul),
        ("turbo", bench_turbo),
        ("dynamic_rtf", bench_dynamic_rtf),
        ("window_rtf", bench_window_rtf),
        ("window_ul_rtf", bench_window_ul_rtf),
        ("window_mimo_rtf", bench_window_mimo_rtf),
        ("window_redrate_rtf", bench_window_redrate_rtf),
        ("window_loopback_rtf", bench_window_loopback_rtf),
        ("window_ul_loopback_rtf", bench_window_ul_loopback_rtf),
        ("window_dlgen_rtf", bench_window_dlgen_rtf),
        ("window_ulgen_rtf", bench_window_ulgen_rtf),
        ("window_carriers", bench_window_carriers),
    ):
        try:
            r = fn(jax, jnp, rng)
            if name == "ue_dl_siso":
                results[name], results["carriers_per_chip"] = r
            elif name == "window_rtf":
                results[name], results["window_onchip_rtf"], stage_parts = r
            elif name == "window_ul_rtf":
                results[name], results["window_ul_onchip_rtf"] = r
            elif name == "window_mimo_rtf":
                results[name], results["window_mimo_onchip_rtf"] = r
            elif name == "window_carriers":
                (results["window_carriers_per_chip"],
                 results["window_carriers_per_chip_mcs16"],
                 results["window_carriers_per_chip_mcs26"]) = r
            else:
                results[name] = r
        except Exception as e:  # never lose the other rows
            log(f"{name} FAILED: {type(e).__name__}: {str(e)[:300]}")

    units = {"dynamic_rtf": "x realtime", "window_rtf": "x realtime",
             "window_ul_rtf": "x realtime", "window_mimo_rtf": "x realtime",
             "window_ul_onchip_rtf": "x realtime",
             "window_mimo_onchip_rtf": "x realtime",
             "window_onchip_rtf": "x realtime",
             "window_dlgen_rtf": "x realtime",
             "window_redrate_rtf": "x realtime",
             "window_loopback_rtf": "x realtime",
             "window_ul_loopback_rtf": "x realtime",
             "window_ulgen_rtf": "x realtime",
             "stack_window_rtf": "x realtime",
             "carriers_per_chip": "carriers",
             "window_carriers_per_chip": "carriers",
             "window_carriers_per_chip_mcs16": "carriers",
             "window_carriers_per_chip_mcs26": "carriers"}
    notes = {}
    if "window_onchip_rtf" in results and stage_parts is not None:
        notes["window_onchip_rtf"] = (
            "device-time per stage for one W=128 window: "
            f"front-end(OFDM+chest) {stage_parts['A']*1e3:.1f} ms, "
            f"equalize+demod {stage_parts['B']*1e3:.1f} ms, "
            f"de-RM+turbo+CRC {stage_parts['C']*1e3:.1f} ms — the "
            "cc_worker.cc 1 ms/TTI budget question")
    all_metrics = [
        {
            "metric": name,
            "value": round(v, 2),
            "unit": units.get(name, "Mbps"),
            "vs_baseline": round(v / BASELINES[name], 3),
            **({"note": notes[name]} if name in notes else {}),
        }
        for name, v in results.items()
    ]
    # full metric set to a file; the final stdout line stays small enough
    # for a line-oriented JSON reader
    full_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_full.json")
    with open(full_path, "w") as f:
        json.dump({"all_metrics": all_metrics}, f, indent=1)
    log(f"full metrics -> {full_path}")
    headline = results.get("ue_dl_siso", 0.0)
    key_rows = {
        name: results[name] for name in (
            "ue_dl_mimo_q256", "turbo", "stack_window_rtf",
            "window_loopback_rtf", "window_mimo_onchip_rtf",
            "carriers_per_chip", "window_carriers_per_chip")
        if name in results
    }
    print(
        json.dumps(
            {
                "metric": "UE DL 20MHz SISO QAM64 full subframe decode per chip, "
                          "@~18dB SNR (1-2dB over waterfall; OFDM+chest+MMSE+demod+turbo)",
                "value": round(headline, 1),
                "unit": "Mbps",
                "vs_baseline": round(headline / BASELINES["ue_dl_siso"], 3),
                "key_rows": {k: round(v, 2) for k, v in key_rows.items()},
                "all_metrics_file": "bench_full.json",
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
