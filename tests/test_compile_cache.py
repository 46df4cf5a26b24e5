"""Where the persistent compilation cache lives (dspnet_tpu/__init__.py)."""

import os
import subprocess
import sys

import jax
import pytest

import dspnet_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_set_leaves_jax_alone(restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    chosen = dspnet_tpu.configure_compile_cache(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"})
    assert chosen is None
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_env_var_unset_uses_checkout_dir(restore_cache_dir):
    chosen = dspnet_tpu.configure_compile_cache({})
    assert chosen == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == chosen
    # fixed: no pid, time or temp name in it
    assert dspnet_tpu.configure_compile_cache({}) == chosen


def _cache_dir_in_fresh_process(env_value):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c",
         "import dspnet_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd="/", capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_value", [None, "/tmp/dspnet_cache_from_env"])
def test_fresh_process_cache_dir(env_value):
    got = _cache_dir_in_fresh_process(env_value)
    assert got == (env_value or os.path.join(REPO, ".jax_cache"))
