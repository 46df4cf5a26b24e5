"""Cityscapes pixel-level semantic-labeling evaluation.

Capability parity with the reference's vendored official scripts
(data/cityscapes/Scripts/evaluation/evalPixelLevelSemanticLabeling.py) and
their Cython confusion-matrix kernel
(addToConfusionMatrix.pyx:10-25 — component N7 in SURVEY.md):

* :func:`add_to_confusion_matrix` — the kernel, as one vectorized
  ``np.bincount`` over id pairs instead of a per-pixel C loop;
* :func:`evaluate_pairs` — official scoring: per-class IoU
  ``tp / (tp + fp + fn)`` over evaluated (non-ignored) label ids, with fp
  counted only against evaluated classes and fn excluding void, plus the
  category-level aggregation;
* :func:`write_result_png` — trainId prediction -> labelId PNG upsampled to
  full resolution, the format the official evaluator consumes
  (reference multi_eval.py:355-362, prob_upsampling :28-34).

A jnp variant of the kernel is provided for on-device accumulation.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from dspnet_tpu.data.cs_labels import TRAINID_TO_LABELID, id2label, labels

NUM_IDS = 256  # label images are uint8


def add_to_confusion_matrix(
    prediction: np.ndarray, groundtruth: np.ndarray, conf: np.ndarray
) -> np.ndarray:
    """Accumulate (gt, pred) pixel pairs into ``conf`` (NUM_IDS x NUM_IDS).

    Vectorized equivalent of the reference Cython/C kernel
    (addToConfusionMatrix.pyx:10-25)."""
    assert prediction.shape == groundtruth.shape
    idx = groundtruth.astype(np.int64).reshape(-1) * NUM_IDS + prediction.astype(
        np.int64
    ).reshape(-1)
    conf += np.bincount(idx, minlength=NUM_IDS * NUM_IDS).reshape(NUM_IDS, NUM_IDS)
    return conf


def add_to_confusion_matrix_jax(prediction, groundtruth, conf):
    """On-device variant (jnp) for streaming eval without host roundtrips.

    NOTE the accumulator dtype is the caller's ``conf``: int32 wraps past
    2^31 after ~3.5k full-res Cityscapes images on one cell (jnp has no
    int64 by default) — for long streams, pull per-batch counts to the host
    and accumulate into an int64 numpy matrix (the per-batch count itself
    cannot overflow: < 2^31 pixels/batch), or use a float32 accumulator
    (exact to 2^24 per add, 2^31 total magnitude)."""
    import jax.numpy as jnp

    idx = groundtruth.astype(jnp.int32).reshape(-1) * NUM_IDS + prediction.astype(
        jnp.int32
    ).reshape(-1)
    counts = jnp.zeros((NUM_IDS * NUM_IDS,), jnp.int32).at[idx].add(1)
    return conf + counts.reshape(NUM_IDS, NUM_IDS).astype(conf.dtype)


def _eval_label_ids():
    return [l.id for l in labels if l.id >= 0 and not l.ignoreInEval]


def class_iou_scores(conf: np.ndarray) -> Dict[str, float]:
    """Official per-class IoU from a labelId confusion matrix."""
    eval_ids = _eval_label_ids()
    scores = {}
    for i in eval_ids:
        tp = float(conf[i, i])
        fn = float(conf[i, :].sum()) - tp
        # fp: predictions of class i on pixels whose GT is some *other
        # evaluated* class (void GT doesn't count against you)
        fp = float(conf[eval_ids, i].sum()) - tp
        denom = tp + fp + fn
        scores[id2label[i].name] = tp / denom if denom > 0 else float("nan")
    return scores


def category_iou_scores(conf: np.ndarray) -> Dict[str, float]:
    eval_ids = _eval_label_ids()
    cats = sorted({id2label[i].category for i in eval_ids})
    scores = {}
    for cat in cats:
        ids = [i for i in eval_ids if id2label[i].category == cat]
        tp = float(conf[np.ix_(ids, ids)].sum())
        fn = float(conf[ids, :].sum()) - tp
        fp = float(conf[np.ix_(eval_ids, ids)].sum()) - tp
        denom = tp + fp + fn
        scores[cat] = tp / denom if denom > 0 else float("nan")
    return scores


def evaluate_pairs(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> Dict:
    """pairs of (prediction labelId image, groundtruth labelId image)."""
    conf = np.zeros((NUM_IDS, NUM_IDS), np.int64)
    n = 0
    for pred, gt in pairs:
        add_to_confusion_matrix(pred, gt, conf)
        n += 1
    classes = class_iou_scores(conf)
    cats = category_iou_scores(conf)
    vals = [v for v in classes.values() if not np.isnan(v)]
    cvals = [v for v in cats.values() if not np.isnan(v)]
    return {
        "num_images": n,
        "classScores": classes,
        "averageScoreClasses": float(np.mean(vals)) if vals else float("nan"),
        "categoryScores": cats,
        "averageScoreCategories": float(np.mean(cvals)) if cvals else float("nan"),
        "confusion": conf,
    }


def write_result_png(seg_trainid: np.ndarray, out_path: str, full_hw=(1024, 2048)) -> str:
    """trainId prediction (H/4-res) -> full-res labelId PNG.

    Nearest upsampling of the argmax map — the cheap fallback when class
    probabilities aren't available. The reference's exact semantics
    (bilinear PROBABILITY upsampling before argmax, multi_eval.py:28-34,
    355-362) live in :func:`write_result_png_from_probs`."""
    import cv2

    up = cv2.resize(
        seg_trainid.astype(np.uint8), (full_hw[1], full_hw[0]), interpolation=cv2.INTER_NEAREST
    )
    out = np.where(up <= 18, TRAINID_TO_LABELID[np.clip(up, 0, 18)], 0).astype(np.uint8)
    cv2.imwrite(out_path, out)
    return out_path


def write_result_png_from_probs(seg_prob, out_path: str, full_hw=(1024, 2048)) -> str:
    """(H/4, W/4, C) class probabilities -> full-res labelId PNG via bilinear
    probability upsampling then argmax — the reference's prob_upsampling
    (GridGenerator identity affine + BilinearSampler to full res then argmax,
    multi_eval.py:28-34, 355-362). Smoother class boundaries than
    nearest-upsampling the argmax map."""
    import cv2
    import jax.numpy as jnp

    from dspnet_tpu.models.layers import resize_bilinear_align_corners

    up = resize_bilinear_align_corners(jnp.asarray(seg_prob)[None], full_hw)[0]
    cls = np.asarray(jnp.argmax(up, axis=-1)).astype(np.uint8)
    out = np.where(cls <= 18, TRAINID_TO_LABELID[np.clip(cls, 0, 18)], 0).astype(np.uint8)
    cv2.imwrite(out_path, out)
    return out_path
