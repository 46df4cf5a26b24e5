"""MultiBoxDetection — decode + class-aware NMS, fixed shape, on device.

Redesign of the reference operator
(reference operator/multibox_detection.cc:53-169, .cu:53-250).

Reference pipeline (dynamic shapes, per-batch CUDA block):
  1. per anchor: argmax over foreground classes (first max wins), drop if
     score < threshold; decode (incl. the depth channel ``oz = pz * 0.1``),
     optional clip; compact valid rows with atomicAdd;
  2. stable sort by score desc, keep ``nms_topk``;
  3. greedy IoU NMS in sorted order, same-class only unless
     ``force_suppress``; suppressed rows get class id -1 (only column 0 is
     overwritten, score/box survive — multibox_detection.cc:164).

Redesign (static shapes):
  1. vectorized argmax/decode over all anchors;
  2. one stable argsort by ``(valid desc, score desc, anchor idx asc)`` and a
     static top-K slice (K = nms_topk, padded rows are all -1 like the
     reference's -1-initialized output);
  3. greedy NMS computed as the unique fixpoint of
     ``keep = valid & ~(S^T @ keep)`` with S the upper-triangular suppression
     matrix — each iteration is one K x K 0/1 matvec (exact at any matmul
     precision: 0/1 products summed in f32); the fixpoint equals the
     sequential greedy result exactly (induction over row index), and is
     reached in O(longest suppression chain) iterations.

Known deviation (documented, not silently different): when more than
``nms_topk`` anchors pass the score threshold, the reference leaves the
un-sorted tail rows [nkeep, valid_count) in its output buffer and lets them
participate in NMS (multibox_detection.cc:144-151 never rewrites them). We
return exactly the top-K rows instead — the tail rows are duplicates or
lower-scored leftovers of an unstable buffer, and a fixed (B, K, 7) output is
what a static-shape compiler needs. With the default eval threshold the
valid count rarely exceeds K = 400; parity tests pin the <= K case bitwise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dspnet_tpu.ops import boxes as box_ops


def _nms_fixpoint(keep_init, suppress):
    """Greedy-NMS keep mask via fixpoint iteration.

    keep_init: (K,) bool — validity mask (rows eligible at all).
    suppress:  (K, K) bool — suppress[j, i] True if row j (if kept)
               eliminates row i; strictly upper triangular in row order.
    """
    sup_f = suppress.astype(jnp.float32)

    def cond(state):
        keep, changed = state
        return changed

    def body(state):
        keep, _ = state
        hit = (keep.astype(jnp.float32) @ sup_f) > 0.0
        new_keep = keep_init & ~hit
        return new_keep, jnp.any(new_keep != keep)

    keep, _ = jax.lax.while_loop(cond, body, (keep_init, jnp.array(True)))
    return keep


def _decode_single(cls_prob, loc_pred, anchors, threshold, clip, variances):
    """cls_prob (C, A), loc_pred (A, 5) -> per-anchor (valid, id, score,
    boxes, dist) in anchor order (the compaction order of
    multibox_detection.cc:94-128)."""
    fg = cls_prob[1:]  # foreground classes
    score = jnp.max(fg, axis=0)
    cid = jnp.argmax(fg, axis=0).astype(jnp.float32)  # 0-based object class
    valid = score >= threshold
    dec_boxes, dec_dist = box_ops.decode_locations(anchors, loc_pred, variances, clip)
    return valid, cid, score, dec_boxes, dec_dist


def _mask_invalid(valid, cid, score, boxes, dist):
    """Non-detections become all -1 rows (the reference's -1-initialized
    output buffer, multibox_detection.cc:94-95)."""
    return (
        valid,
        jnp.where(valid, cid, -1.0),
        jnp.where(valid, score, -1.0),
        jnp.where(valid[:, None], boxes, -1.0),
        jnp.where(valid, dist, -1.0),
    )


def _decode_topk_single(cls_prob, loc_pred, anchors, threshold, clip, variances, topk):
    """cls_prob (C, A), loc_pred (A, 5) -> top-K rows before NMS."""
    valid, cid, score, dec_boxes, dec_dist = _decode_single(
        cls_prob, loc_pred, anchors, threshold, clip, variances)

    # Stable order: valid rows by descending score (anchor index breaks ties,
    # matching std::stable_sort over the anchor-ordered compaction), then
    # invalid rows. Scores live in [0, 1] so 2.0 sorts all invalid rows last.
    sort_key = jnp.where(valid, -score, 2.0)
    order = jnp.argsort(sort_key, stable=True)
    top = order[:topk]

    return _mask_invalid(
        jnp.take(valid, top),
        jnp.take(cid, top),
        jnp.take(score, top),
        jnp.take(dec_boxes, top, axis=0),
        jnp.take(dec_dist, top),
    )


def _nms_xla_single(k_valid, k_id, k_boxes, nms_threshold, force_suppress, topk):
    iou = box_ops.iou_matrix(k_boxes, k_boxes)
    row = jnp.arange(topk)
    upper = row[:, None] < row[None, :]
    class_ok = jnp.ones((topk, topk), bool) if force_suppress else (k_id[:, None] == k_id[None, :])
    suppress = upper & class_ok & (iou >= nms_threshold) & k_valid[:, None] & k_valid[None, :]
    return _nms_fixpoint(k_valid, suppress)


@partial(
    jax.jit,
    static_argnames=(
        "threshold",
        "clip",
        "variances",
        "nms_threshold",
        "force_suppress",
        "nms_topk",
    ),
)
def multibox_detection(
    cls_prob,
    loc_preds,
    anchors,
    threshold: float = 0.01,
    clip: bool = True,
    variances: tuple = box_ops.DEFAULT_VARIANCES,
    nms_threshold: float = 0.5,
    force_suppress: bool = False,
    nms_topk: int = 400,
):
    """Batched MultiBoxDetection.

    Args:
      cls_prob:  (B, C, A) class probabilities (background = class 0).
      loc_preds: (B, A, 5) or (B, A*5) location regressions.
      anchors:   (A, 4) or (1, A, 4) corner anchors.

    Returns:
      (B, K, 7) rows ``[class_id, score, xmin, ymin, xmax, ymax, dist]`` with
      K = nms_topk (or A if nms_topk <= 0); non-detections/suppressed rows
      carry class_id -1 (suppressed rows keep their score/box like the
      reference). With NMS disabled (nms_threshold <= 0 or > 1) the
      reference skips sort/top-K too (multibox_detection.cc:130-133), so the
      output is (B, A, 7) in anchor order, untruncated.
    """
    if anchors.ndim == 3:
        anchors = anchors[0]
    num_anchors = anchors.shape[0]
    if loc_preds.ndim == 2:
        loc_preds = loc_preds.reshape(loc_preds.shape[0], num_anchors, -1)
    if loc_preds.shape[-1] == 4:
        # classic SSD head: no distance channel -> decoded distance 0
        loc_preds = jnp.concatenate(
            [loc_preds, jnp.zeros_like(loc_preds[..., :1])], axis=-1
        )
    nms_on = 0.0 < nms_threshold <= 1.0
    # NOTE nms_topk <= 0 means "no truncation" (reference semantics); with
    # NMS on, this builds (A, A) IoU/suppression matrices per batch element
    # (~600 MB f32 at A=12264) — fine for small A, a device-memory hazard
    # at full resolution. Keep the default K=400 for big anchor sets.
    topk = nms_topk if nms_topk > 0 else num_anchors
    topk = min(topk, num_anchors)

    if not nms_on:
        # Reference skips sort, top-K, and NMS entirely when the NMS
        # threshold is unset (multibox_detection.cc:130-133 'continue'):
        # every thresholded row stays, compacted to the top in anchor order
        # (the atomic compaction of :94-128), no truncation.
        def decode_all(c, l):
            valid, cid, score, dec_boxes, dec_dist = _decode_single(
                c, l, anchors.astype(jnp.float32), threshold, clip, variances)
            order = jnp.argsort(~valid, stable=True)  # valid first, anchor order
            return _mask_invalid(
                jnp.take(valid, order),
                jnp.take(cid, order),
                jnp.take(score, order),
                jnp.take(dec_boxes, order, axis=0),
                jnp.take(dec_dist, order),
            )

        _, k_id, k_score, k_boxes, k_dist = jax.vmap(decode_all)(
            cls_prob.astype(jnp.float32), loc_preds.astype(jnp.float32))
        return jnp.concatenate(
            [k_id[..., None], k_score[..., None], k_boxes, k_dist[..., None]],
            axis=-1,
        )

    decode = partial(
        _decode_topk_single,
        anchors=anchors.astype(jnp.float32),
        threshold=threshold,
        clip=clip,
        variances=variances,
        topk=topk,
    )
    k_valid, k_id, k_score, k_boxes, k_dist = jax.vmap(lambda c, l: decode(c, l))(
        cls_prob.astype(jnp.float32), loc_preds.astype(jnp.float32)
    )

    keep = jax.vmap(
        partial(
            _nms_xla_single,
            nms_threshold=nms_threshold,
            force_suppress=force_suppress,
            topk=topk,
        )
    )(k_valid, k_id, k_boxes)
    # Reference overwrites only the class id of suppressed rows.
    k_id = jnp.where(keep, k_id, -1.0)

    return jnp.concatenate(
        [k_id[..., None], k_score[..., None], k_boxes, k_dist[..., None]], axis=-1
    )
