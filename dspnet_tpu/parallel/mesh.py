"""Mesh + sharding helpers.

Replacement for the reference's parallelism story (SURVEY.md section 2.7):
the reference's only strategy is data parallelism through MXNet KVStore on a
GPU list (train/train_multitask.py:235-246); here DP is a
``jax.sharding.Mesh`` over all devices, batches sharded on the ``data``
axis, parameters replicated, and gradient reduction left to XLA's SPMD
partitioner (an all-reduce over NVLink between GPUs). A second ``model``
axis shards activations spatially (image width).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        assert n_model <= len(devices), (
            f"n_model={n_model} exceeds {len(devices)} devices")
        assert len(devices) % n_model == 0, (
            f"n_model={n_model} does not divide {len(devices)} devices — "
            "pass n_data explicitly to use a subset")
        n_data = len(devices) // n_model
    assert n_data >= 1 and n_model >= 1, (n_data, n_model)
    assert n_data * n_model <= len(devices)
    grid = np.asarray(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spatial_image_sharding(mesh: Mesh) -> NamedSharding:
    """(B, H, W, C) images: batch over 'data', width over 'model'.

    XLA's SPMD partitioner handles the convolution halo exchanges
    automatically, so sharding the W axis scales a single high-resolution
    image across chips — the scale axis the reference could not touch
    (SURVEY.md section 5, 'long-context N/A'). Verified bit-consistent with
    the unsharded forward in tests/test_parallel.py."""
    return NamedSharding(mesh, P("data", None, "model", None))


def batch_shardings_for(mesh: Mesh, batch, spatial: bool = False):
    """Per-leaf shardings for a batch dict: images optionally spatially
    sharded, everything else batch-sharded."""
    img = spatial_image_sharding(mesh) if spatial else batch_sharding(mesh)
    other = batch_sharding(mesh)
    return {k: (img if k == "images" else other) for k in batch}


def shard_batch(mesh: Mesh, batch, spatial: bool = False):
    """Place a host pytree onto the mesh, batch-sharded on axis 0 (images
    additionally width-sharded over 'model' when ``spatial``).

    Works across processes: under multi-process DP (distributed_init) each
    process passes its LOCAL batch rows (global_batch / process_count —
    the slice its input iterator produced via shard=(rank, world)) and the
    result is the assembled GLOBAL jax.Array; single-process it is a plain
    device_put. The reference analog is KVStore device batching
    (train/train_multitask.py:235-246)."""
    shardings = batch_shardings_for(mesh, batch, spatial)
    if jax.process_count() > 1:
        for k, v in batch.items():
            if isinstance(v, jax.Array):
                # a device-resident batch (e.g. --loader device) would pay a
                # silent full D2H here before re-upload; refuse rather than
                # quietly defeating the loader's purpose
                raise ValueError(
                    f"multi-process shard_batch needs HOST batches, got a "
                    f"jax.Array for '{k}' — use a host loader "
                    f"(--loader python/native) with --coordinator")
        return {
            k: jax.make_array_from_process_local_data(shardings[k], np.asarray(v))
            for k, v in batch.items()
        }
    return {k: jax.device_put(v, shardings[k]) for k, v in batch.items()}


def distributed_init(coordinator: str, num_processes: int, process_id: int,
                     local_device_id: Optional[int] = None):
    """Multi-process runtime init (one process per GPU) — must run before
    any other JAX call. Replaces the reference's KVStore context list
    (train/train_multitask.py:235-246) with ``jax.distributed.initialize``:
    afterwards jax.devices() is the GLOBAL device list and make_mesh/
    shard_batch span all processes.

    ``local_device_id``: the one GPU of this host the process opens. Each
    JAX process reserves most of the memory of every GPU it opens, so
    processes sharing a host must each open only their own card. (GPU
    only; the CPU backend ignores it.)"""
    import jax.distributed

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=(None if local_device_id is None
                          else [local_device_id]),
    )
