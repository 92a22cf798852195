"""Where the persistent compilation cache lands (ddm_jax/__init__.py).

Checked in a fresh interpreter each: the cache directory is set once, at
import."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import ddm_jax, jax, jax.numpy as jnp

def cache_probe(x):
    return x * 3.0 + 1.0

jax.jit(cache_probe)(jnp.ones(5)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _run_probe(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(tmp_path, from_env):
    """With JAX_COMPILATION_CACHE_DIR set, the cache lands there and the
    package sets no directory of its own; without it, the cache lands in
    the checkout's .jax_cache."""
    want = tmp_path / "cache" if from_env else os.path.join(REPO, ".jax_cache")
    got = _run_probe(want if from_env else None)
    assert os.path.abspath(got) == os.path.abspath(str(want))
    entries = os.listdir(want)
    assert any(e.startswith("jit_cache_probe") for e in entries), entries
