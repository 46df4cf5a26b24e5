"""Shared benchmarking helpers: device description, the peak-rate table,
``block_until_ready`` timing, and the canonical synthetic train batch."""

from __future__ import annotations

import subprocess
import time

# Dense peak rates per device, keyed by ``jax.Device.device_kind``.
# Source: NVIDIA H100 data sheet, SXM part, without sparsity, at the full
# 700 W power limit. A device missing here has no peak: callers report no
# utilization rather than assume one.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_kind: str, key: str) -> float:
    """Published peak ``key`` of ``device_kind``; KeyError if unknown."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[device_kind][key]


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per GPU
    (the card's clocks and so its times depend on the limit)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def device_info() -> dict:
    """What every printed result names: platform, kind, count, power."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": gpu_name_and_power_limit()}


def timed(fn, *args, n: int = 20, warmup: int = 3) -> float:
    """Mean seconds per call of ``fn(*args)`` over ``n`` back-to-back calls,
    after ``warmup`` calls; the window ends when the device has finished
    the last result (``block_until_ready``)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def canonical_train_arrays(B: int = 4, H: int = 512, W: int = 1024,
                           seed: int = 0, pre_s2d: bool = False):
    """Host (numpy) synthetic multitask batch at the canonical training
    config (8 random boxes/image, 19-class seg labels) — shared by
    bench.py's train mode, chip_smoke.py and the profiling script so the
    workload is identical across them.

    ``pre_s2d``: deliver the image as its space-to-depth transform
    ([B, H/2, W/2, 12], the loaders' ``--input-s2d`` contract) so the step
    graph contains no input relayout (models/resnet.py stem)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lab = np.full((B, 200, 6), -1, np.float32)
    lab[:, :8] = np.abs(rng.rand(B, 8, 6)).astype(np.float32)
    lab[:, :8, 0] = rng.randint(0, 8, (B, 8))
    lab[:, :8, 3:5] = lab[:, :8, 1:3] + 0.2
    img = rng.rand(B, H, W, 3).astype(np.float32)
    if pre_s2d:
        img = host_space_to_depth(img)
    return {
        "images": img,
        "label_det": lab,
        "seg_label": rng.randint(0, 19, (B, H // 4, W // 4)).astype(np.int32),
    }


def canonical_train_batch(B: int = 4, H: int = 512, W: int = 1024, seed: int = 0,
                          pre_s2d: bool = False):
    """:func:`canonical_train_arrays`, placed on the default device."""
    import jax

    batch = jax.device_put(canonical_train_arrays(B, H, W, seed, pre_s2d))
    jax.block_until_ready(batch)
    return batch


def inference_program(model, anchors):
    """The jitted multitask inference program of bench.py's default mode:
    ``(variables, images) -> (det rows (B, 400, 7), seg argmax)``, with
    bfloat16 activations and float32 softmax, decode and NMS."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.ops.detection import multibox_detection

    @jax.jit
    def forward(variables, images):
        out = model.apply(variables, images.astype(jnp.bfloat16), train=False)
        cls_prob = jax.nn.softmax(out["cls_logits"].astype(jnp.float32), axis=-1)
        det = multibox_detection(
            jnp.swapaxes(cls_prob, 1, 2), out["loc_preds"].astype(jnp.float32),
            anchors, threshold=0.01, nms_threshold=0.45, nms_topk=400)
        seg = jnp.argmax(out["seg_logits"], axis=-1)
        return det, seg

    return forward


def host_space_to_depth(img):
    """numpy [B, H, W, C] -> [B, H/2, W/2, 4C] — models/layers.space_to_depth
    applied on host (same code; ndarray methods keep numpy in, numpy out)."""
    from dspnet_tpu.models.layers import space_to_depth

    return space_to_depth(img)


def timed_train_steps(solver, state, batch, n: int = 20, warmup: int = 3):
    """Mean seconds/step of ``solver.train_step`` over ``n`` chained steps
    (each consumes the previous state). Returns (state, seconds_per_step)."""
    import jax

    for _ in range(warmup):
        state, metrics = solver.train_step(state, batch)
    jax.block_until_ready((state, metrics))
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = solver.train_step(state, batch)
    jax.block_until_ready((state, metrics))
    return state, (time.perf_counter() - t0) / n
