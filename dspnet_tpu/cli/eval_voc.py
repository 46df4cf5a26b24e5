"""Plain-SSD offline evaluation over a PASCAL-VOC devkit tree.

Capability parity with reference evaluate/evaluate_net.py:13-110 (the
`evaluate.py` entry): score a 4-coordinate SSD network on a VOC split with
the streaming MApMetric — `--voc07` switches to the 11-point VOC07
interpolation (evaluate_net.py:101-104), `--use-difficult` counts difficult
ground truth (evaluate_net.py:49-52) — AND through the offline devkit file
path the reference exposes via Imdb.evaluate_detections
(dataset/pascal_voc.py:170-259): per-class `comp4_det_{set}_{cls}.txt`
result files written under the devkit `results/` tree and re-scored with
voc_eval. Both paths run in one pass; the devkit mAP is the artifact other
VOC tooling consumes, the streaming metric is the reference's console
number.
"""

from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from dspnet_tpu.api import create_model
from dspnet_tpu.cli.common import parse_data_shape, resolve_class_names, setup_logging
from dspnet_tpu.data.det_iterator import DetIterator
from dspnet_tpu.data.imdb import VOC_CLASSES, PascalVoc
from dspnet_tpu.detect.detector import Detector
from dspnet_tpu.evaluate.eval_metric import MApMetric, VOC07MApMetric
from dspnet_tpu.train.solver import MultiTaskSolver
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Evaluate a plain-SSD network on a PASCAL VOC split.")
    p.add_argument("--network", default="vgg16_reduced",
                   help="SSD network name (no task suffix = plain SSD)")
    p.add_argument("--data-shape", default="3,300,300")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--class-names", default="",
                   help="names file or comma list; default the VOC 20")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epoch", type=int, default=-1,
                   help="checkpoint epoch (-1 latest)")
    p.add_argument("--model-dir", default="model")
    p.add_argument("--voc-root", required=True,
                   help="devkit root holding VOC{year}/")
    p.add_argument("--year", default="2007")
    p.add_argument("--image-set", default="val")
    p.add_argument("--voc07", action="store_true",
                   help="11-point VOC07 AP instead of area-under-envelope "
                        "(reference evaluate_net.py:101-104)")
    p.add_argument("--use-difficult", action="store_true",
                   help="count difficult ground truth in the metric "
                        "(reference evaluate_net.py:49-52)")
    p.add_argument("--overlap-thresh", type=float, default=0.5)
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--force-nms", action="store_true",
                   help="suppress across classes in NMS")
    p.add_argument("--det-score-thresh", type=float, default=0.01,
                   help="drop detections below this score")
    p.add_argument("--result-dir", default="",
                   help="devkit result-file dir (default "
                        "{voc-root}/results/VOC{year}/Main)")
    p.add_argument("--random-init", action="store_true",
                   help="skip checkpoint load (pipeline smoke testing)")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging(log_file=time.strftime("eval_voc_%Y%m%d_%H%M%S.log"))
    H, W = args.data_shape
    class_names = resolve_class_names(args.class_names, VOC_CLASSES)
    assert len(class_names) == args.num_classes, \
        f"{len(class_names)} class names for --num-classes {args.num_classes}"

    bundle = create_model(args.network, (H, W), args.num_classes)
    assert bundle.task in ("ssd", "det"), \
        f"--network {args.network} is task '{bundle.task}', not a detector"
    solver = MultiTaskSolver(bundle.model, bundle.anchors)
    state = solver.init_state(
        jax.random.PRNGKey(0), jnp.zeros((args.batch_size, H, W, 3)))
    if not args.random_init:
        ckpt = CheckpointManagerWrapper(
            checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
        log.info("loaded checkpoint epoch %d", epoch)

    detector = Detector(
        bundle.model, MultiTaskSolver.detector_variables(state), bundle.anchors,
        (H, W), classes=class_names, nms_thresh=args.nms_thresh,
        force_suppress=args.force_nms, score_threshold=0.01,
    )

    # difficult_in_label: every GT kept, difficult flag in label column 5 —
    # the MApMetric labels contract; the metric's own use_difficult switch
    # decides whether difficult GT counts (eval_metric.py:100-104)
    imdb = PascalVoc(args.image_set, args.year, args.voc_root,
                     classes=class_names, difficult_in_label=True)
    index = imdb.index()
    it = DetIterator(index, args.batch_size, (H, W), is_train=False,
                     label_col5="passthrough")

    metric_cls = VOC07MApMetric if args.voc07 else MApMetric
    metric = metric_cls(args.overlap_thresh, args.use_difficult, class_names)

    all_boxes = []  # per split image: (n, 6) [cls, score, x1, y1, x2, y2]
    n_batches, total_ms, timed = 0, 0.0, 0
    for batch, fnames in it.epoch():
        t0 = time.time()
        res = detector.predict(batch["images"])
        det = np.asarray(res["det"])  # host sync: the batch's time ends when its result is on the host
        if n_batches > 0:
            total_ms += (time.time() - t0) * 1000.0
            timed += 1
        n_batches += 1
        labels, preds = [], []
        for b in range(len(fnames)):  # tail batches: only the real rows
            rows = det[b]
            rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] >= args.det_score_thresh)]
            gt = batch["label_det"][b]
            labels.append(gt[gt[:, 0] >= 0])  # (n, 6) with difficult col 5
            preds.append(rows[:, :6])
            all_boxes.append(rows[:, :6])
        metric.update(labels, preds)
    assert len(all_boxes) == len(index), (len(all_boxes), len(index))

    # streaming metric: the reference console numbers (evaluate_net.py:106-110)
    names, values = metric.get()
    results = dict(zip(names, values))
    for k in names:
        log.info("%s: %.4f", k, results[k])

    # offline devkit file path (pascal_voc.py:170-259): write per-class
    # comp4 result files and re-score them with voc_eval
    devkit = imdb.evaluate_detections(
        all_boxes, result_dir=args.result_dir or None,
        ovthresh=args.overlap_thresh, use_07_metric=args.voc07)
    log.info("devkit mAP%s: %.4f (result files: %s)",
             " (VOC07 11-point)" if args.voc07 else "", devkit["mAP"],
             args.result_dir or "devkit results/ tree")
    results.update({f"devkit_{k}": v for k, v in devkit.items()})
    results["ms_per_batch"] = total_ms / max(timed, 1)
    log.info("ms_per_batch: %.1f", results["ms_per_batch"])
    return results


if __name__ == "__main__":
    main()
