"""Multipath fading emulator, re-design of `lib/src/phy/channel/fading.c`.

Same models: 3GPP TS 36.101 Annex B.2 tap-delay-line profiles (EPA/EVA/ETU,
`fading.c:37-45`), per-tap Rayleigh fading by sum-of-sinusoids Doppler
(`fading.c:111,169,242-244`), applied by frequency-domain convolution over
each subframe block.

Batched: the tap gains for a whole batch of subframes are generated in
one vectorized pass; the convolution is one FFT multiply per subframe.  The
emulator is pure: state is the time cursor (for Doppler phase continuity).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

# excess tap delay [ns], relative power [dB] — TS 36.101 B.2.1
DELAY_PROFILES = {
    "epa": (
        (0, 30, 70, 90, 110, 190, 410),
        (0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8),
    ),
    "eva": (
        (0, 30, 150, 310, 370, 710, 1090, 1730, 2510),
        (0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9),
    ),
    "etu": (
        (0, 50, 120, 200, 230, 500, 1600, 2300, 5000),
        (-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0),
    ),
    "none": ((0,), (0.0,)),
}

N_SINUSOIDS = 16  # sum-of-sinusoids components per tap


@dataclasses.dataclass(frozen=True)
class FadingConfig:
    model: str = "epa"  # epa|eva|etu|none
    doppler_hz: float = 5.0
    srate: float = 1.92e6
    seed: int = 0

    @property
    def taps(self):
        return DELAY_PROFILES[self.model]


@lru_cache(maxsize=64)
def _sos_params(cfg: FadingConfig):
    """Random sum-of-sinusoids parameters per tap (host, deterministic)."""
    delays, powers = cfg.taps
    ntaps = len(delays)
    rng = np.random.default_rng(cfg.seed)
    theta = rng.uniform(0, 2 * np.pi, (ntaps, N_SINUSOIDS))
    phi = rng.uniform(0, 2 * np.pi, (ntaps, N_SINUSOIDS))
    # Jakes: f_i = fd * cos(alpha_i)
    alpha = (2 * np.pi * np.arange(N_SINUSOIDS) + rng.uniform(0, 2 * np.pi, (ntaps, 1))) / N_SINUSOIDS
    freqs = cfg.doppler_hz * np.cos(alpha)
    amp = 10.0 ** (np.asarray(powers) / 20.0)
    amp = amp / np.sqrt(np.sum(amp**2))
    return (
        freqs.astype(np.float32),
        theta.astype(np.float32),
        phi.astype(np.float32),
        amp.astype(np.float32),
        np.asarray(delays, np.float32) * 1e-9,
    )


def tap_gains(cfg: FadingConfig, t_seconds):
    """Complex tap gains at given times: t (...,) → (..., ntaps)."""
    freqs, theta, phi, amp, _ = _sos_params(cfg)
    w = 2 * np.pi * jnp.asarray(freqs)  # (ntaps, N)
    t = jnp.asarray(t_seconds)[..., None, None]
    ph = w * t + jnp.asarray(theta)
    ph2 = w * t + jnp.asarray(phi)
    re = jnp.sum(jnp.cos(ph), axis=-1)
    im = jnp.sum(jnp.sin(ph2), axis=-1)
    # var(sum of N random-phase cosines) = N/2 per quadrature → E|g|^2 = 1
    g = (re + 1j * im) / np.sqrt(N_SINUSOIDS)
    return g * jnp.asarray(amp)


def freq_response(cfg: FadingConfig, t_seconds, nfft: int):
    """Channel frequency response H(f) at time(s) t: (..., nfft) complex64.

    f axis matches np.fft.fftfreq(nfft, 1/srate).
    """
    _, _, _, _, delays = _sos_params(cfg)
    g = tap_gains(cfg, t_seconds)  # (..., ntaps)
    f = jnp.asarray(np.fft.fftfreq(nfft, 1.0 / cfg.srate).astype(np.float32))
    phase = jnp.exp(-2j * np.pi * f[:, None] * jnp.asarray(delays)[None, :])
    return jnp.einsum("...t,ft->...f", g.astype(jnp.complex64), phase.astype(jnp.complex64))


def apply_fading(cfg: FadingConfig, samples, t0_seconds=0.0):
    """Apply block fading to (..., n) samples (channel frozen per block,
    evolving with t0; matches the reference's per-subframe freq-domain conv).
    Returns (faded_samples, H (..., n))."""
    n = samples.shape[-1]
    h = freq_response(cfg, jnp.asarray(t0_seconds), n)
    x_f = jnp.fft.fft(samples, axis=-1)
    y = jnp.fft.ifft(x_f * h, axis=-1)
    return y.astype(jnp.complex64), h


def awgn(key, samples, snr_db, signal_power=None):
    """Add complex AWGN at the given SNR (ref ch_awgn.c)."""
    p = jnp.mean(jnp.abs(samples) ** 2) if signal_power is None else signal_power
    n0 = p * 10.0 ** (-snr_db / 10.0)
    # complex normal from jax.random has unit total variance (E|z|^2 = 1)
    noise = jax.random.normal(key, samples.shape, jnp.complex64) * jnp.sqrt(n0)
    return (samples + noise).astype(jnp.complex64)


@dataclasses.dataclass(frozen=True)
class RlfConfig:
    """Radio-link-failure burst gater (ref channel/rlf.c): the signal is
    zeroed for `t_off_ms` every `t_on_ms + t_off_ms`."""

    t_on_ms: int = 10000
    t_off_ms: int = 2000


def apply_rlf(cfg: RlfConfig, samples, t_ms):
    period = cfg.t_on_ms + cfg.t_off_ms
    gate = (jnp.asarray(t_ms) % period) < cfg.t_on_ms
    return samples * gate.astype(samples.dtype)


def apply_delay(samples, delay_samples: float):
    """Fractional delay via frequency-domain phase ramp (ref delay.c)."""
    n = samples.shape[-1]
    f = jnp.asarray(np.fft.fftfreq(n).astype(np.float32))
    x_f = jnp.fft.fft(samples, axis=-1)
    y = jnp.fft.ifft(x_f * jnp.exp(-2j * jnp.pi * f * delay_samples), axis=-1)
    return y.astype(jnp.complex64)


def hst_doppler_shift(fd_hz: float, period_s: float, t_s):
    """High-speed-train Doppler trajectory (TS 36.101 B.3; ref hst.c):
    cosine-shaped shift ±fd over the period."""
    x = (jnp.asarray(t_s) % period_s) / period_s
    return fd_hz * jnp.cos(2 * jnp.pi * x)
