"""Test config: by default everything runs on a virtual 8-device CPU mesh.

Must set env before the first jax import anywhere in the test process. An
explicit ``JAX_PLATFORMS`` wins: the tests marked ``gpu`` run on the card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# pytest plugins import jax before this conftest runs, so the env var alone is
# too late; jax.config.update still works pre-backend-initialization.
import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.RandomState(233)  # the reference's canonical seed


@pytest.fixture(scope="session")
def native_lib():
    """Path of the native loader, built from native/dataloader.cpp on first
    use; skips where it cannot be built (no g++, libjpeg or libpng)."""
    from dspnet_tpu.data.native_loader import build_native

    try:
        return build_native()
    except RuntimeError as e:
        pytest.skip(f"native loader does not build here: {e}")


@pytest.fixture
def gpu():
    """The first device, when JAX runs on a GPU; skips otherwise. Tests that
    use it carry the ``gpu`` marker."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r}); run "
                    "with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev
