"""Standalone greedy NMS — capability parity with the reference's
cython/cpu_nms.pyx, cython/gpu_nms.pyx + nms_kernel.cu and detect/nms.py.

The reference ships three interchangeable implementations (numpy, Cython,
CUDA bitmask-block) of Fast-R-CNN-style greedy NMS over
``[x1, y1, x2, y2, score]`` rows with the integer-pixel ``+1`` area
convention. Here one numpy implementation covers the host path and one
jit-able JAX implementation (same fixpoint formulation as
ops/detection.py) covers the device path; a CUDA bitmask kernel comes back
only if a profile of the card shows NMS costing (ROADMAP S5).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def nms(dets: np.ndarray, thresh: float) -> list[int]:
    """Greedy NMS (host / numpy). Returns kept row indices.

    Matches reference detect/nms.py:24-58: descending-score order (numpy
    argsort reversed), ``+1`` pixel areas, boxes KEPT at ``overlap <= thresh``
    (suppression strictly ``>``). Note the reference's cython/cpu_nms.pyx:17-68
    differs at the exact-threshold boundary (it suppresses at ``>=``); we pin
    the detect/nms.py convention, which is the one its demo paths call.
    """
    dets = np.asarray(dets, dtype=np.float32)
    if dets.size == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def nms_jax(dets, thresh: float):
    """Greedy NMS (device / JAX): returns a (N,) bool keep mask.

    Same convention as :func:`nms`; fixed-shape (mask instead of index list)
    so it composes under jit/vmap.
    """
    dets = jnp.asarray(dets, jnp.float32)
    n = dets.shape[0]
    x1, y1, x2, y2, scores = (dets[:, i] for i in range(5))
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)

    # Descending-score order. np.argsort()[::-1] is unstable for ties in the
    # reference; we pin the deterministic variant: ties -> higher original
    # index first (equivalent to reversing an ascending stable sort).
    order = jnp.argsort(scores, stable=True)[::-1]
    sx1, sy1, sx2, sy2 = (jnp.take(v, order) for v in (x1, y1, x2, y2))
    sarea = jnp.take(areas, order)
    iw = jnp.maximum(0.0, jnp.minimum(sx2[:, None], sx2[None, :]) - jnp.maximum(sx1[:, None], sx1[None, :]) + 1.0)
    ih = jnp.maximum(0.0, jnp.minimum(sy2[:, None], sy2[None, :]) - jnp.maximum(sy1[:, None], sy1[None, :]) + 1.0)
    inter = iw * ih
    ovr = inter / (sarea[:, None] + sarea[None, :] - inter)
    row = jnp.arange(n)
    # strictly > matches nms() / detect/nms.py (keep ties at exactly thresh)
    suppress = (row[:, None] < row[None, :]) & (ovr > thresh)
    from dspnet_tpu.ops.detection import _nms_fixpoint

    keep_sorted = _nms_fixpoint(jnp.ones((n,), bool), suppress)
    # Scatter back to original row order.
    keep = jnp.zeros((n,), bool).at[order].set(keep_sorted)
    return keep


def bbox_overlaps(boxes: np.ndarray, query_boxes: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) IoU matrix with the ``+1`` pixel convention.

    Parity with reference cython/bbox.pyx:16-55 (bbox_overlaps_cython),
    including its asymmetry: a pair contributes 0 unless the intersection is
    strictly positive in both axes.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    query_boxes = np.asarray(query_boxes, dtype=np.float64)
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    ) + 1
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    ) + 1
    box_area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    query_area = (query_boxes[:, 2] - query_boxes[:, 0] + 1) * (
        query_boxes[:, 3] - query_boxes[:, 1] + 1
    )
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = box_area[:, None] + query_area[None, :] - inter
    return np.where(inter > 0, inter / union, 0.0)
