"""Train-step roofline profile (VERDICT r2 weak #1 / item 2).

Measures the canonical train step (512x1024 resnet-50_multi bf16 b4,
device-resident batch) and reports:

* wall ms/step (``block_until_ready`` timing);
* XLA cost analysis of the COMPILED step: conv/dot FLOPs and bytes
  accessed -> est. MFU and est. HBM utilization against the device's
  published peaks (utils/benchmark.PEAKS; none for an unknown device);
* optionally a jax.profiler trace (PROFILE_DIR=/tmp/trace) for op-level
  attribution in xprof/tensorboard.

The bound decides the next optimization: >=80% of the HBM roofline means
attack bytes (fusion, layouts, dtype); low on both means latency/overhead.
"""

import os
import sys

# running as `python scripts/foo.py` puts scripts/ (not the repo
# root) on sys.path; make `import dspnet_tpu` work regardless of cwd
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from dspnet_tpu.api import create_model
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.benchmark import (
        canonical_train_batch, device_info, peak, timed_train_steps)

    B = int(os.environ.get("PROFILE_BATCH", "4"))
    H, W = 512, 1024
    print(f"devices: {device_info()}")
    bundle = create_model("resnet-50_multi", (H, W), num_classes=8)
    solver = MultiTaskSolver(bundle.model, bundle.anchors,
                             compute_dtype="bfloat16", batch_size=B)
    state = solver.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    batch = canonical_train_batch(
        B, H, W, pre_s2d=os.environ.get("PROFILE_S2D", "1") != "0")

    # compiled-step cost analysis
    compiled = solver.lower_train_step(state, batch).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    flops = float(ca.get("flops", 0.0))
    bytes_acc = float(ca.get("bytes accessed", 0.0))
    print(f"XLA cost analysis: {flops / 1e12:.3f} TFLOP/step, "
          f"{bytes_acc / 1e9:.2f} GB accessed/step")
    try:
        ma = compiled.memory_analysis()
        print(f"memory: argument {ma.argument_size_in_bytes / 1e9:.2f} GB, "
              f"output {ma.output_size_in_bytes / 1e9:.2f} GB, "
              f"temp {ma.temp_size_in_bytes / 1e9:.2f} GB")
    except Exception:
        pass

    state, dt = timed_train_steps(solver, state, batch, n=30)
    print(f"step: {dt * 1e3:.2f} ms ({B / dt:.1f} img/s)")
    kind = jax.devices()[0].device_kind
    mfu = flops / dt / peak(kind, "bf16_flops")
    hbm = bytes_acc / dt / peak(kind, "hbm_bytes_per_s")
    print(f"MFU {mfu * 100:.1f}% of the {kind} bf16 peak; "
          f"HBM {hbm * 100:.1f}% of its peak "
          f"({bytes_acc / dt / 1e9:.0f} GB/s)")
    bound = ("HBM-bound" if hbm > 2 * mfu and hbm > 0.5
             else "compute-bound" if mfu > 0.5
             else "latency/overhead-bound")
    print(f"verdict: {bound}")

    hlo_out = os.environ.get("HLO_OUT")
    if hlo_out:
        with open(hlo_out, "w") as f:
            f.write(compiled.as_text())
        print(f"optimized HLO written to {hlo_out}")

    pdir = os.environ.get("PROFILE_DIR")
    if pdir:
        with jax.profiler.trace(pdir):
            for _ in range(5):
                state, metrics = solver.train_step(state, batch)
            float(metrics["loss"])
        print(f"trace written to {pdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
