"""srsran_tpu — an LTE software-radio PHY framework on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of srsLTE/srsRAN
(reference: lucabaldesi/srsRAN): OFDM, synchronization, channel estimation,
MIMO equalization, FEC (Viterbi/turbo), and the LTE physical channels —
batched, jit-compiled, and sharded across device meshes.
"""

import os

__version__ = "0.1.0"

# fixed default for the persistent compilation cache: inside the checkout,
# so the path (part of the cache key) stays the same from run to run
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _enable_compilation_cache():
    """Persistent XLA compilation cache.

    The framework compiles one executable per window/grant bucket, and a
    live scheduler touches new buckets for minutes after boot; the cache
    makes every bucket a one-time cost across process restarts.  JAX reads
    `JAX_COMPILATION_CACHE_DIR` itself; only the default is set here."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        except OSError:  # read-only checkout: run uncached
            return
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_enable_compilation_cache()
