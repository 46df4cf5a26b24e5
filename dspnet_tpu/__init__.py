"""dspnet_tpu — a JAX driving-scene-perception framework.

A from-scratch rebuild of the capabilities of the DSPNet reference
(single-shot multitask network: 2-D detection + per-box distance + semantic
segmentation):

* the whole forward/backward is one jitted program (no per-step graph rebind),
* anchors are trace-time constants,
* anchor matching / target assignment / decode+NMS are fixed-shape on-device
  XLA ops instead of hand-written CUDA kernels,
* data parallelism is a `jax.sharding.Mesh` batch shard with the gradient
  reduction left to XLA's SPMD partitioner.

Reference capability map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

import os as _os

from dspnet_tpu.ops import anchors, boxes  # noqa: F401

CHECKOUT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache")


def configure_compile_cache(environ=_os.environ):
    """Keep JAX's persistent compilation cache at a fixed path so repeat
    launches reuse compiled programs (the path is part of the cache key).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is changed here; otherwise the cache lives in the checkout's
    ``.jax_cache``. Returns the directory set here, or None."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR


configure_compile_cache()

# lazy top-level API (avoids importing the model and data stacks for
# ops-only users)
_LAZY = {
    "create_model": ("dspnet_tpu.api", "create_model"),
    "ModelBundle": ("dspnet_tpu.api", "ModelBundle"),
    "Detector": ("dspnet_tpu.detect.detector", "Detector"),
    "ServingPipeline": ("dspnet_tpu.detect.pipeline", "ServingPipeline"),
    "MultiTaskSolver": ("dspnet_tpu.train.solver", "MultiTaskSolver"),
    "MultiTaskIterator": ("dspnet_tpu.data.iterator", "MultiTaskIterator"),
    "evaluate_model": ("dspnet_tpu.evaluate.loop", "evaluate_model"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'dspnet_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
