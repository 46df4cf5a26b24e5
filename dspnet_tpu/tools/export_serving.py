"""export_serving — AOT-export the inference pipeline as one artifact.

Produces a self-contained serving bundle: the full jitted pipeline
(normalize -> backbone -> heads -> decode -> NMS -> seg argmax) serialized
via ``jax.export`` (StableHLO) with the trained weights baked in as
constants, plus a small JSON manifest. The artifact reloads and runs with
``load_bundle`` — no model code, config, or checkpoint needed — which is
the counterpart of shipping the reference's
``prefix-symbol.json + prefix-epoch.params`` pair to a deployment host
(mx.model.load_checkpoint, detect/multitask_detector.py:105).

Usage::

    python -m dspnet_tpu.tools.export_serving --network resnet-50_multi \
        --data-shape 3,512,1024 --batch-size 8 --model-dir model \
        --out serving/dspnet.jaxexp [--bf16]

    # at the deployment site
    from dspnet_tpu.tools.export_serving import load_bundle
    serve = load_bundle("serving/dspnet.jaxexp")
    det, seg = serve(raw_bgr_uint8_batch)   # (B, H, W, 3) uint8
"""

from __future__ import annotations

import argparse
import json
import os


def build_serve_fn(bundle, variables, nms_thresh=0.45,
                   score_threshold=0.01, nms_topk=400):
    """The exported computation: raw uint8 BGR batch -> (det rows, seg map)."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.data.augment import MEAN_PIXELS
    from dspnet_tpu.ops.detection import multibox_detection

    model = bundle.model
    anchors = bundle.anchors  # numpy: a trace-time constant

    def serve(raw_bgr):
        x = raw_bgr[..., ::-1].astype(jnp.float32) - jnp.asarray(
            MEAN_PIXELS, jnp.float32)
        out = model.apply(variables, x.astype(_param_dtype(variables)), train=False)
        det = None
        if "cls_logits" in out:
            cls_prob = jax.nn.softmax(out["cls_logits"].astype(jnp.float32), axis=-1)
            det = multibox_detection(
                jnp.swapaxes(cls_prob, 1, 2),
                out["loc_preds"].astype(jnp.float32), anchors,
                threshold=score_threshold, nms_threshold=nms_thresh,
                nms_topk=nms_topk,
            )
        seg = None
        if "seg_logits" in out:
            seg = jnp.argmax(out["seg_logits"], axis=-1)
        if det is None:
            return seg
        if seg is None:
            return det
        return det, seg

    return serve


def _param_dtype(variables):
    import jax
    import jax.numpy as jnp

    leaves = [x for x in jax.tree.leaves(variables)
              if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)]
    return leaves[0].dtype if leaves else jnp.float32


def export_bundle(bundle, variables, out_path: str, batch_size: int,
                  data_shape, bf16: bool = False,
                  nms_thresh: float = 0.45, score_threshold: float = 0.01,
                  nms_topk: int = 400):
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    if bf16:
        from dspnet_tpu.utils.precision import bf16_variables

        variables = bf16_variables(variables)
    H, W = data_shape
    serve = build_serve_fn(bundle, variables, nms_thresh=nms_thresh,
                           score_threshold=score_threshold, nms_topk=nms_topk)
    exp = jexport.export(jax.jit(serve))(
        jax.ShapeDtypeStruct((batch_size, H, W, 3), jnp.uint8))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        f.write(exp.serialize())
    manifest = {
        "network": bundle.name,
        "task": bundle.task,
        "data_shape": [H, W],
        "batch_size": batch_size,
        "num_anchors": bundle.num_anchors,
        "dtype": "bfloat16" if bf16 else "float32",
        "input": f"uint8 BGR (B={batch_size}, {H}, {W}, 3)",
        "output": "det rows (B, A, 7) [id, score, x1, y1, x2, y2, dist] "
                  "and/or seg argmax (B, H/4, W/4)",
    }
    with open(out_path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return out_path


def load_bundle(path: str):
    """Deserialize an exported bundle; returns a callable over uint8 batches."""
    from jax import export as jexport

    with open(path, "rb") as f:
        exp = jexport.deserialize(f.read())
    return exp.call


def main(argv=None):
    p = argparse.ArgumentParser(description="Export the serving pipeline (jax.export).")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--model-dir", default="model")
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--out", required=True)
    p.add_argument("--bf16", action="store_true", help="serve in bfloat16")
    p.add_argument("--seg-fast", action="store_true",
                   help="model was trained with --seg-fast")
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--score-threshold", type=float, default=0.01)
    p.add_argument("--nms-topk", type=int, default=400)
    p.add_argument("--random-init", action="store_true",
                   help="skip checkpoint load (testing)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dspnet_tpu.api import create_model
    from dspnet_tpu.cli.common import parse_data_shape
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix

    H, W = parse_data_shape(args.data_shape)
    bundle = create_model(args.network, (H, W), args.num_classes,
                          seg_fast=args.seg_fast)
    solver = MultiTaskSolver(
        bundle.model,
        bundle.anchors if bundle.anchors is not None else np.zeros((1, 4), np.float32),
    )
    state = solver.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    if not args.random_init:
        ckpt = CheckpointManagerWrapper(checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
        print(f"loaded checkpoint epoch {epoch}")
    variables = MultiTaskSolver.detector_variables(state)

    out = export_bundle(bundle, variables, args.out, args.batch_size, (H, W),
                        bf16=args.bf16,
                        nms_thresh=args.nms_thresh,
                        score_threshold=args.score_threshold,
                        nms_topk=args.nms_topk)
    size_mb = os.path.getsize(out) / 1e6
    print(f"exported {out} ({size_mb:.1f} MB)")


if __name__ == "__main__":
    main()
