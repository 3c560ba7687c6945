"""Where the persistent compilation cache lives: `JAX_COMPILATION_CACHE_DIR`
when it is set, else `.jax_cache/` inside the checkout."""

import os
import subprocess
import sys

import srsran_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax, srsran_tpu; "
         "print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-1]


def test_default_cache_inside_checkout():
    assert srsran_tpu.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert _probe(None) == os.path.join(REPO, ".jax_cache")


def test_env_cache_dir_wins(tmp_path):
    want = str(tmp_path / "cc")
    assert _probe(want) == want

