"""Test config: run the suite on a virtual 8-device CPU mesh.

Unit tests must be deterministic and runnable anywhere, and the sharding
tests need more than one device, so a fresh test process forces an
8-device CPU platform before JAX is imported.

Tests marked `gpu` need an NVIDIA GPU: the `gpu` fixture skips them
elsewhere.  `python chip_smoke.py` runs them on the card in its own
process, whose JAX is already on the GPU when pytest starts, so the CPU
setup below is left out there.
"""

import os
import sys

import pytest

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ.setdefault("JAX_ENABLE_X64", "0")

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == 8


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through python chip_smoke.py)")
    return jax.devices()[0]
