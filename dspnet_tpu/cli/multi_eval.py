"""Evaluation CLI — parity with reference multi_eval.py:106-465.

Computes detection mAP, segmentation mIoU + pixel accuracy, depth relative
error, and ms/batch in one pass over the validation set; optionally writes
full-resolution Cityscapes result PNGs (trainId -> labelId LUT) for the
official evaluator (multi_eval.py:356-362).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model
from dspnet_tpu.cli.common import parse_data_shape, resolve_class_names, resolve_dataset, setup_logging
from dspnet_tpu.data.cs_labels import DET_CLASSES, SEG_CLASSES
from dspnet_tpu.data.iterator import MultiTaskIterator
from dspnet_tpu.detect.detector import Detector
from dspnet_tpu.evaluate.loop import evaluate_model
from dspnet_tpu.train.solver import MultiTaskSolver
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a DSPNet network.")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--seg-fast", action="store_true",
                   help="model was trained with --seg-fast")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="names file (one per line) or comma list; default Cityscapes 8")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epoch", type=int, default=-1, help="checkpoint epoch (-1 latest)")
    p.add_argument("--model-dir", default="model")
    p.add_argument("--dataset-root", default="")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-dir", default="/tmp/dspnet_synth")
    p.add_argument("--overlap-thresh", type=float, default=0.5)
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--det-score-thresh", type=float, default=0.1)
    p.add_argument("--write-results", default="", help="dir for Cityscapes result PNGs")
    p.add_argument("--dist-errors", default="",
                   help="write per-box depth relative errors here (dist_errors.txt)")
    p.add_argument("--seg-class-names", default="",
                   help="seg names file or comma list; default Cityscapes 19")
    p.add_argument("--instance-eval", action="store_true",
                   help="Cityscapes-style instance-level AP/AP50 from "
                        "det boxes x seg map vs SegmentationInstance/ "
                        "*_instanceIds.png ground truth")
    p.add_argument("--predownscale", action="store_true",
                   help="with --loader device: host-resize raws to the eval "
                        "resolution before H2D")
    p.add_argument("--native-u8", action="store_true",
                   help="with --loader native: uint8 H2D + device mean-sub")
    p.add_argument("--loader", default="python",
                   choices=["python", "native", "device"],
                   help="val input pipeline: host cv2 or on-device resize/normalize")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="async predict dispatch window in evaluate_model "
                        "(deeper overlaps more H2D/compute at the cost of "
                        "holding more batches in flight)")
    p.add_argument("--random-init", action="store_true",
                   help="skip checkpoint load (pipeline smoke testing)")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging(log_file=time.strftime("eval_%Y%m%d_%H%M%S.log"))
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes,
                          seg_fast=args.seg_fast)

    solver = MultiTaskSolver(bundle.model, bundle.anchors if bundle.anchors is not None
                             else np.zeros((1, 4), np.float32))
    state = solver.init_state(jax.random.PRNGKey(0), jnp.zeros((args.batch_size, H, W, 3)))
    if not args.random_init:
        ckpt = CheckpointManagerWrapper(checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
        log.info("loaded checkpoint epoch %d", epoch)

    class_names = resolve_class_names(args.class_names, DET_CLASSES)
    detector = Detector(
        bundle.model, MultiTaskSolver.detector_variables(state), bundle.anchors,
        (H, W), classes=class_names,
        nms_thresh=args.nms_thresh, score_threshold=0.01,
        # the PNG writer wants probabilities (bilinear prob upsampling,
        # multi_eval.py:28-34); otherwise skip the 20x D2H cost
        seg_probabilities=bool(args.write_results),
    )

    index = resolve_dataset(args, "val")
    if args.loader == "native":
        from dspnet_tpu.data.native_loader import (
            NativeMultiTaskIterator,
            native_available,
        )

        assert native_available(), "the native loader does not build here (make -C native)"
        it = NativeMultiTaskIterator(index, args.batch_size, (H, W),
                                     enable_aug=False, shuffle=False,
                                     device_normalize=args.native_u8,
                                     pad_last=True)
    elif args.loader == "device":
        from dspnet_tpu.data.device_pipeline import DeviceAugIterator

        # host decodes raw uint8, resize + normalize run on device — batches
        # arrive device-resident so predict() pays no f32 H2D per batch
        it = DeviceAugIterator(index, args.batch_size, (H, W),
                               enable_aug=False, shuffle=False,
                               predownscale=args.predownscale, pad_last=True)
    else:
        # pad_last: val sets not divisible by the batch still evaluate their
        # tail (padded rows are sliced off by len(fnames) in evaluate_model)
        it = MultiTaskIterator(index, args.batch_size, (H, W),
                               enable_aug=False, shuffle=False, pad_last=True)

    return evaluate_model(
        detector,
        it,
        det_score_thresh=args.det_score_thresh,
        overlap_thresh=args.overlap_thresh,
        class_names=class_names,
        seg_class_names=resolve_class_names(args.seg_class_names, SEG_CLASSES),
        write_results=args.write_results or None,
        dist_errors_path=args.dist_errors or None,
        instance_eval=args.instance_eval,
        log_fn=log.info,
        pipeline_depth=args.pipeline_depth,
    )


if __name__ == "__main__":
    main()
