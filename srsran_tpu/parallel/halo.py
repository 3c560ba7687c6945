"""Halo-exchange streaming ops over a sharded sample axis.

The reference's overlap-save/add block processing (FFT resampler state
`resampler.c:183-189`, FIR filter state, PSS correlation over block
boundaries) carries boundary samples between sequential calls. When the
sample axis is sharded across chips, the carried state becomes a
neighbour exchange: each shard sends its edge samples to the adjacent
shard with `jax.lax.ppermute` between devices (SURVEY §5.7).

All ops are built with `shard_map` over a mesh axis named `samples`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..phy.resampling import resample_fft


def stream_halo_exchange(xc, halo: int, axis: str = "samples"):
    """Exchange `halo` edge samples with ring neighbours.

    xc: this shard's (..., n_local) chunk. Returns (left, right) halos:
    the previous shard's tail and the next shard's head (edge shards get
    a reflected copy of their own edge, matching the blockwise reference
    behaviour in `resample_fft_blocks`).
    """
    n_dev = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    left = jax.lax.ppermute(xc[..., -halo:], axis, fwd)  # from idx-1
    right = jax.lax.ppermute(xc[..., :halo], axis, bwd)  # from idx+1
    # edges: replicate own boundary instead of the wrapped-around shard
    left = jnp.where(idx == 0, xc[..., :halo], left)
    right = jnp.where(idx == n_dev - 1, xc[..., -halo:], right)
    return left, right


def sharded_resample_fft(x, p: int, q: int, mesh: Mesh, halo: int = 64, axis: str = "samples"):
    """Rational p/q FFT resampling of a stream sharded along its sample
    axis; overlap-save boundaries move between devices as a halo
    exchange."""

    def local(xc):
        left, right = stream_halo_exchange(xc, halo, axis)
        ext = jnp.concatenate([left, xc, right], axis=-1)
        y = resample_fft(ext, p, q)
        h_out = halo * p // q
        return y[..., h_out : h_out + xc.shape[-1] * p // q]

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
    )(x)


def sharded_fir(x, taps: np.ndarray, mesh: Mesh, axis: str = "samples"):
    """Causal FIR filtering of a sharded stream; each shard receives the
    previous shard's tail (the filter state) via ppermute."""
    ntaps = len(taps)
    t = jnp.asarray(taps, jnp.complex64)

    def local(xc):
        n_dev = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        left = jax.lax.ppermute(xc[..., -(ntaps - 1) :], axis, fwd)
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)  # zero initial state
        ext = jnp.concatenate([left, xc], axis=-1)
        y = jnp.convolve(ext, t, mode="valid") if ext.ndim == 1 else None
        if y is None:
            y = jax.vmap(lambda r: jnp.convolve(r, t, mode="valid"))(ext)
        return y

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=P(axis), out_specs=P(axis))
    )(x)
