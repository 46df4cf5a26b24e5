"""Shared evaluation loop — the forward-only metric pass used by the eval
CLI and the per-epoch validation inside training (reference
multi_solver.py:355-517 / multi_eval.py:275-423 behavior)."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np


from dspnet_tpu.data.cs_labels import DET_CLASSES, SEG_CLASSES
from dspnet_tpu.evaluate.eval_metric import (
    CustomAccuracyMetric,
    DistanceAccuracyMetric,
    IoUMetric,
    MApMetric,
)


def disparity_path_for(image_path: str) -> str:
    """Image path -> sibling disparity PNG (the synthetic/prepared layout)."""
    return image_path.replace("JPEGImages", "Disparity").replace(
        "_leftImg8bit.jpg", "_disparity.png"
    )


def instance_path_for(image_path: str) -> str:
    """Image path -> sibling instanceIds PNG (prepare_cityscapes
    --instance-ids layout)."""
    return image_path.replace("JPEGImages", "SegmentationInstance").replace(
        "_leftImg8bit.jpg", "_gtFine_instanceIds.png"
    )


def evaluate_model(
    detector,
    iterator,
    det_score_thresh: float = 0.1,
    overlap_thresh: float = 0.5,
    class_names=DET_CLASSES,
    seg_class_names=SEG_CLASSES,
    write_results: Optional[str] = None,
    dist_errors_path: Optional[str] = None,
    instance_eval: bool = False,
    log_fn=None,
    pipeline_depth: int = 2,
) -> Dict[str, float]:
    """One pass over ``iterator`` computing mAP, mIoU, pixel accuracy, depth
    relative error, and steady-state ms/batch. Returns a flat metric dict.

    Structure (the reference loop is multi_eval.py:275-423, serial forward
    + all-host metric math):

    * predict() dispatches are ASYNC; results materialize ``pipeline_depth``
      batches behind, so each batch's H2D + forward + D2H overlaps its
      neighbors' (the ServingPipeline pattern, detect/pipeline.py).
    * seg mIoU/accuracy accumulate ON DEVICE into one 256x256 confusion
      matrix (cityscapes_eval.add_to_confusion_matrix_jax) — the (B, H/4,
      W/4) argmax maps never reach the host; one 256 KB D2H at the end.
      update_from_confusion() is bit-identical to the per-pixel host path
      (integer counts both ways).
    * only the (B, K, 7) det rows are pulled per batch (tens of KB); seg
      maps transfer only when --write-results / instance eval needs pixels.

    ``ms_per_batch`` is the steady-state wall clock per batch measured over
    the pipelined loop (first batch excluded — it pays the compile).
    """
    import cv2
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.detect.detector import start_d2h
    from dspnet_tpu.evaluate.cityscapes_eval import (
        NUM_IDS,
        add_to_confusion_matrix_jax,
    )

    map_metric = MApMetric(overlap_thresh, class_names=list(class_names))
    iou_metric = IoUMetric(list(seg_class_names))
    acc_metric = CustomAccuracyMetric()
    dist_metric = DistanceAccuracyMetric(list(class_names))

    inst_acc = None
    if instance_eval:
        from dspnet_tpu.data.cs_labels import name2label
        from dspnet_tpu.evaluate.instance_eval import (
            InstanceEvalAccumulator,
            boxes_and_seg_to_instances,
        )

        inst_acc = InstanceEvalAccumulator(list(class_names))
        det_to_trainid = {
            i: name2label[n].trainId for i, n in enumerate(class_names)
            if n in name2label
        }

    # instance eval / result PNGs consume pixels on the host; plain metric
    # eval keeps seg on device (confusion matrix only)
    need_seg_host = bool(write_results) or inst_acc is not None

    @jax.jit
    def conf_update(conf, pred, gt):
        # ids < 0 (no-label fill) land on 255 = the ignore id: contributes
        # to the accuracy denominator only, like the host metrics
        gt = jnp.where(gt < 0, NUM_IDS - 1, jnp.minimum(gt, NUM_IDS - 1))
        return add_to_confusion_matrix_jax(pred, gt, conf)

    conf = None  # created on first seg batch (device, int32)
    seg_pixels = 0

    def process(res, batch, fnames):
        """Materialize + host-side metric math for one (older) batch."""
        nonlocal conf
        n_real = len(fnames)
        label_det = np.asarray(batch["label_det"]) if "label_det" in batch else None
        if "det" in res:
            det = np.asarray(res["det"])  # small: (B, K, 7)
            inst_seg = (np.asarray(res["seg"])
                        if inst_acc is not None and "seg" in res else None)
            labels, preds = [], []
            for b in range(min(det.shape[0], n_real)):
                gt = label_det[b]
                gt = gt[gt[:, 0] >= 0][:, :5]
                rows = det[b]
                rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] > det_score_thresh)]
                labels.append(gt)
                preds.append(rows[:, :6])
                dpath = disparity_path_for(fnames[b])
                if os.path.exists(dpath):
                    disparity = cv2.imread(dpath, cv2.IMREAD_UNCHANGED)
                    if disparity is not None:
                        dist_metric.update(disparity, rows)
                if inst_seg is not None:
                    # same filtered rows feed mAP and instance AP; masks are
                    # matched per image by the accumulator, then released
                    ipath = instance_path_for(fnames[b])
                    inst_img = (cv2.imread(ipath, cv2.IMREAD_UNCHANGED)
                                if ipath != fnames[b] and os.path.exists(ipath)
                                else None)
                    if inst_img is not None:
                        inst_preds = boxes_and_seg_to_instances(
                            rows, inst_seg[b], det_to_trainid,
                            list(class_names), inst_img.shape[:2])
                        inst_acc.update(inst_preds,
                                        inst_img.astype(np.int64))
            map_metric.update(labels, preds)

        if write_results and "seg" in res:
            from dspnet_tpu.evaluate.cityscapes_eval import (
                write_result_png,
                write_result_png_from_probs,
            )

            os.makedirs(write_results, exist_ok=True)
            seg_pred = np.asarray(res["seg"])[:n_real]
            seg_prob = res.get("seg_prob")  # prefer the reference's
            # bilinear probability upsampling (multi_eval.py:28-34)
            for b in range(seg_pred.shape[0]):
                name = os.path.splitext(os.path.basename(fnames[b]))[0] + "_pred.png"
                path = os.path.join(write_results, name)
                if seg_prob is not None:
                    write_result_png_from_probs(np.asarray(seg_prob[b]), path)
                else:
                    write_result_png(seg_pred[b], path)

    from collections import deque

    from dspnet_tpu.data.prefetch import prefetch_to_device

    def _place(item):
        # background-thread H2D for the device-bound leaves only: images
        # (predict input) and seg_label (conf_update input). label_det stays
        # host numpy (the det metric math consumes it there), fnames are
        # strings. Already-device batches (DeviceAugIterator) pass through.
        batch, fnames = item
        batch = {k: (jax.device_put(v) if k in ("images", "seg_label") else v)
                 for k, v in batch.items()}
        return batch, fnames

    pending = deque()
    n_batches = 0
    t_first_done = None
    t_last = None
    # the host loader (cv2 decode + aug) and its H2D run on the prefetch
    # thread, overlapped with device compute AND with the host metric math
    # below — the serial reference loop pays them back-to-back per batch
    for batch, fnames in prefetch_to_device(
            iterator.epoch(), size=max(pipeline_depth, 1), sharding=_place):
        res = detector.predict(batch["images"])  # async dispatch
        n_real = len(fnames)
        if "seg" in res and "seg_label" in batch:
            # chain the on-device confusion update onto this batch's seg
            # output (async too); padded tail rows are sliced off on device
            gt = jnp.asarray(batch["seg_label"])
            if conf is None:
                conf = jnp.zeros((NUM_IDS, NUM_IDS), jnp.int32)
            conf = conf_update(conf, res["seg"][:n_real], gt[:n_real])
            seg_pixels += int(gt[:n_real].size)
        if not need_seg_host:
            res = {k: v for k, v in res.items() if k in ("det",)}
        # start the D2H of every leaf process() will materialize:
        # copy_to_host_async lands the bytes in the background while newer
        # batches compute
        start_d2h(res)
        pending.append((res, batch, fnames))
        if len(pending) > pipeline_depth:
            process(*pending.popleft())
        if n_batches == 0:
            # first batch pays compile + warmup: finish it before timing
            while pending:
                process(*pending.popleft())
            t_first_done = time.time()
        n_batches += 1
    while pending:
        process(*pending.popleft())
    if conf is not None:
        # int32 device accumulator: exact below 2^31 pixels on one cell
        assert seg_pixels < 2**31, "int32 confusion accumulator would wrap"
        conf_np = np.asarray(conf)  # the single seg D2H of the whole pass
        iou_metric.update_from_confusion(conf_np)
        acc_metric.update_from_confusion(conf_np)
    t_last = time.time()
    total_ms = ((t_last - t_first_done) * 1000.0
                if t_first_done is not None and n_batches > 1 else 0.0)
    timed = max(n_batches - 1, 0)

    if dist_errors_path:
        # per-box relative-error dump, percent (reference train/metric.py:259)
        dist_metric.save_errors(dist_errors_path)

    results: Dict[str, float] = {}
    # Per-class entries are namespaced: the metrics all key by bare class
    # name and det classes are a subset of the seg classes, so a flat
    # update() would overwrite per-class AP with IoU and then derror.
    headline = {"mAP", "mIoU", "accuracy", "derror"}
    for metric, prefix in ((map_metric, "ap_"), (iou_metric, "iou_"),
                           (acc_metric, ""), (dist_metric, "derror_")):
        try:
            for k, v in metric.get_dict().items():
                results[k if k in headline else prefix + k] = v
        except Exception:  # a broken metric must not abort the others,
            import logging  # but silence would read as "not computed"

            logging.getLogger(__name__).exception(
                "metric %s failed; its keys are missing from the results",
                type(metric).__name__)
    if inst_acc is not None:
        if inst_acc.num_images == 0:
            import logging

            logging.getLogger(__name__).warning(
                "instance_eval: no *_instanceIds.png ground truth found "
                "(expected SegmentationInstance/ beside JPEGImages/, see "
                "prepare_cityscapes --instance-ids); instAP not computed")
        else:
            inst = inst_acc.get()
            results["instAP"] = inst.pop("AP")
            results["instAP50"] = inst.pop("AP50")
            results.update({f"inst_{c}": v for c, v in inst.items()})
    results["ms_per_batch"] = total_ms / max(timed, 1)
    if log_fn:
        for k in ("mAP", "mIoU", "accuracy", "derror", "instAP", "instAP50",
                  "ms_per_batch"):
            if k in results:
                log_fn(f"{k}: {results[k]}")
        # LaTeX-ready &-joined row (multi_solver.py:500-517)
        log_fn(" & ".join(
            f"{k}={results[k]:.4f}" for k in ("mAP", "mIoU", "accuracy", "derror", "ms_per_batch")
            if isinstance(results.get(k), float)
        ))
    return results
