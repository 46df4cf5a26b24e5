"""End-to-end multitask benchmarks on one GPU.

Default mode: inference throughput of the full 512x512 multitask pipeline
(resnet-50 backbone + SSD/depth head + PSP seg head + on-device
decode+NMS + seg argmax) at batch 128, bfloat16 weights/activations (box
decode, NMS and softmax stay float32), reference-exact seg head
(BENCH_SEG_FAST=1 for the FCN-style variant head,
dspnet_tpu/models/seg_head.py). Pass a smaller batch as argv[1] for
latency-oriented serving.
BENCH_TRAIN=1 switches to the train-step benchmark (bench_train);
BENCH_SERVE=1 to the 512x1024 b1 serving-latency benchmark (bench_serve).

Prints ONE JSON line: {"metric", "value", "unit", ...} plus the device it
ran on (platform, device_kind, device_count, nvidia-smi name and power
limit). Exits non-zero without a result when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time


def report(metric: str, value: float, unit: str, **extra):
    from dspnet_tpu.utils.benchmark import device_info

    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      **extra, **device_info()}))


def bench_train():
    """BENCH_TRAIN=1 mode: the 512x1024 resnet-50_multi bf16 train step,
    device-resident batch in the loaders' space-to-depth layout, at b4 and
    b8 — img/s and MFU from the compiled step's XLA cost analysis against
    the device's published bf16 peak (none for an unknown device)."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.benchmark import (
        canonical_train_batch, peak, timed_train_steps)

    H, W = 512, 1024
    res = {}
    for B in (4, 8):
        bundle = create_model("resnet-50_multi", (H, W), num_classes=8)
        solver = MultiTaskSolver(bundle.model, bundle.anchors,
                                 compute_dtype="bfloat16", batch_size=B)
        state = solver.init_state(jax.random.PRNGKey(0),
                                  jnp.zeros((1, H, W, 3)))
        batch = canonical_train_batch(B, H, W, pre_s2d=True)
        compiled = solver.lower_train_step(state, batch).compile()
        ca = compiled.cost_analysis()
        ca = ca[0] if isinstance(ca, (list, tuple)) else ca
        flops = float(ca.get("flops", 0.0))
        state, dt = timed_train_steps(solver, state, batch)
        res[B] = (dt, flops)
    dt4, _ = res[4]
    dt8, flops8 = res[8]
    extra = {}
    try:
        extra["est_mfu"] = flops8 / dt8 / peak(
            jax.devices()[0].device_kind, "bf16_flops")
    except KeyError as e:
        extra["est_mfu"], extra["mfu_error"] = None, str(e)
    report("multitask_train_step_512x1024_b8_bf16", 8 / dt8,
           "images/sec/device", ms_per_step=dt8 * 1e3,
           b4_ms_per_step=dt4 * 1e3, b4_img_per_s=4 / dt4, **extra)


def bench_serve():
    """BENCH_SERVE=1 mode: 512x1024 b1 serving latency.

    * ``sync_ms`` — one `predict_raw` (uint8 BGR H2D + on-device normalize
      + forward + full D2H) per call, materialized before the next call.
    * ``pipelined_ms`` — ServingPipeline depth=2 (async dispatch +
      copy_to_host_async at submit, results one window behind): each
      call's H2D/compute/D2H overlaps its neighbors'. The headline value.
    * ``device_resident_ms`` — forward only, input already on device.

    Reference counterpart: the per-frame FPS print,
    reference detect/multitask_detector.py:454.
    """
    import jax
    import numpy as np

    from dspnet_tpu.api import create_model
    from dspnet_tpu.detect.detector import Detector
    from dspnet_tpu.detect.pipeline import ServingPipeline
    from dspnet_tpu.utils.benchmark import timed
    from dspnet_tpu.utils.precision import bf16_variables

    H, W = 512, 1024
    bundle = create_model("resnet-50_multi", (H, W), num_classes=8)
    variables = jax.jit(lambda r, x: bundle.model.init(r, x, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, H, W, 3), np.float32))
    variables = bf16_variables(variables)
    det = Detector(bundle.model, variables, bundle.anchors, (H, W))

    rng = np.random.RandomState(0)
    frame = rng.randint(0, 256, (1, H, W, 3), np.uint8)

    def materialize(res):
        return {k: np.asarray(v) for k, v in res.items()}

    # --- sync: materialize every call before dispatching the next
    n = 30
    materialize(det.predict_raw(frame))  # compile + warm
    materialize(det.predict_raw(frame))
    t0 = time.perf_counter()
    for _ in range(n):
        materialize(det.predict_raw(frame))
    sync_ms = (time.perf_counter() - t0) / n * 1e3

    # --- pipelined: depth-2 window, results one window behind
    pipe = ServingPipeline(det, depth=2, raw=True)
    for _ in range(4):  # fill + warm the window
        pipe.submit(frame)
    t0 = time.perf_counter()
    for _ in range(n):
        pipe.submit(frame)
    for _ in pipe.drain():
        pass
    pipelined_ms = (time.perf_counter() - t0) / n * 1e3

    # --- device-resident: pure compute
    images = jax.device_put(
        (frame[..., ::-1].astype(np.float32) - np.asarray(det.mean_pixels)))
    device_ms = timed(det._predict, variables, images, n=n) * 1e3

    report("serving_latency_512x1024_b1", pipelined_ms, "ms/call",
           sync_ms=sync_ms, pipelined_ms=pipelined_ms,
           device_resident_ms=device_ms)


def bench_infer(batch: int):
    """Default mode: b128 512x512 inference throughput."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.utils.benchmark import inference_program, timed
    from dspnet_tpu.utils.precision import bf16_variables

    H = W = 512
    seg_fast = bool(os.environ.get("BENCH_SEG_FAST"))
    bundle = create_model("resnet-50_multi", (H, W), num_classes=8,
                          seg_fast=seg_fast)
    images = jax.random.normal(jax.random.PRNGKey(0), (batch, H, W, 3), jnp.float32)
    variables = jax.jit(lambda r, x: bundle.model.init(r, x, train=False))(
        jax.random.PRNGKey(0), images[:1]
    )
    variables = bf16_variables(variables)
    forward = inference_program(bundle.model, bundle.anchors)

    dt = timed(forward, variables, images, n=20)
    report("multitask_inference_throughput_512x512", batch / dt,
           "images/sec/device",
           seg_head="fast_variant" if seg_fast else "reference_exact")


def main():
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench: needs a GPU, JAX found platform {platform!r}")
    if os.environ.get("BENCH_TRAIN"):
        return bench_train()
    if os.environ.get("BENCH_SERVE"):
        return bench_serve()
    return bench_infer(int(sys.argv[1]) if len(sys.argv) > 1 else 128)


if __name__ == "__main__":
    main()
