"""Demo CLI — parity with reference multi_demo.py:56-150.

Runs the detector on image(s) / video / webcam and writes visualizations
(boxes with class + distance text, seg overlay).
"""

from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np

from dspnet_tpu.api import create_model
from dspnet_tpu.cli.common import parse_data_shape, resolve_class_names
from dspnet_tpu.data.cs_labels import DET_CLASSES
from dspnet_tpu.detect.detector import Detector
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DSPNet demo.")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--seg-fast", action="store_true",
                   help="model was trained with --seg-fast")
    p.add_argument("--images", default="", help="comma-separated image paths or video")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="names file (one per line) or comma list; default Cityscapes 8")
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--model-dir", default="model")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--nms-thresh", type=float, default=0.5)
    p.add_argument("--vis-thresh", type=float, default=0.6)
    p.add_argument("--force-suppress", action="store_true")
    p.add_argument("--random-init", action="store_true")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def get_detector(args) -> Detector:
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes,
                          seg_fast=args.seg_fast)
    from dspnet_tpu.train.solver import MultiTaskSolver

    solver = MultiTaskSolver(bundle.model, bundle.anchors if bundle.anchors is not None
                             else np.zeros((1, 4), np.float32))
    state = solver.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    if not args.random_init:
        ckpt = CheckpointManagerWrapper(checkpoint_prefix(args.model_dir, args.network, H))
        state, _ = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
    return Detector(
        bundle.model, MultiTaskSolver.detector_variables(state), bundle.anchors,
        (H, W), classes=resolve_class_names(args.class_names, DET_CLASSES),
        nms_thresh=args.nms_thresh, force_suppress=args.force_suppress,
    )


def main(argv=None):
    args = parse_args(argv)
    detector = get_detector(args)
    inputs = args.images
    if "," in inputs:
        inputs = [s.strip() for s in inputs.split(",") if s.strip()]
    written = detector.detect_and_visualize(inputs, args.out_dir, thresh=args.vis_thresh)
    for w in written:
        print("wrote", os.path.abspath(w))
    return written


if __name__ == "__main__":
    main()
