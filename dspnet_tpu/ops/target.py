"""MultiBoxTarget — anchor<->GT matching + training-target assignment.

Fixed-shape, fully on-device redesign of the reference CUDA/C++ operator
(reference operator/multibox_target.cc:73-284, multibox_target-inl.h).
Same observable semantics, different computation model:

reference (CUDA)                         this op (JAX/XLA)
---------------------------------------  -----------------------------------
sequential greedy bipartite loop          masked global-argmax `while_loop`
  (multibox_target.cc:113-149)              (first-occurrence tie-break ==
                                             the C++ row-major scan order)
per-anchor best-GT scan (:151-180)        one vectorized argmax over the IoU
                                             matrix
hard-negative mining via in-kernel        stable top-k by background softmax
  merge sort (multibox_target.cu:170-280)    probability (ascending), ties to
                                             lower anchor index — identical
                                             to std::stable_sort on -prob
dynamic valid-GT count                    static (A, L) shapes + masks

Semantics reproduced exactly:
* labels are ``(L, 6)`` rows ``[cls, xmin, ymin, xmax, ymax, dist]``; rows are
  valid up to the first ``cls == -1`` (multibox_target.cc:96-105).
* phase 1: repeated global argmax over unmatched (anchor, gt) pairs while
  IoU > 1e-6, each match consuming both sides.
* phase 2: remaining anchors match their best GT; IoU > overlap_threshold
  makes them positive (strict ``>``, :172).
* phase 3: negatives = hardest ``min(ratio * num_pos, A - num_pos)`` anchors
  among those with flag == -1 and best IoU < negative_mining_thresh, ranked
  by ascending background probability (:182-241); with mining disabled all
  non-positives become negatives (:242-249).
* outputs: cls_target in {-1 ignore, 0 background, gt_cls + 1}, loc_target
  encoded with variances + dist/0.1, loc_mask 1 on positives
  (:251-281). If an image has zero valid GTs everything stays at its init
  (cls_target = ignore_label, masks 0; multibox_target-inl.h:121-123, cc:107).
* `minimum_negative_samples` is accepted but unused — the reference CPU/GPU
  kernels never read it (multibox_target.cc passes it through and ignores it).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from dspnet_tpu.ops import boxes as box_ops


def _bipartite_match(iou, col_valid):
    """Greedy global-argmax bipartite matching, computed in parallel rounds.

    iou: (A, L) IoU matrix; col_valid: (L,) bool for real GT columns.
    Returns (anchor_matched (A,) bool, match_gt (A,) int32, match_iou (A,) f32,
    gt_matched (L,) bool).

    Equivalence to the sequential greedy (the reference's row-major
    strictly-greater scan, multibox_target.cc:113-149): order the available
    pairs by (IoU desc, anchor asc, gt asc); the sequential loop emits the
    first pair of that order each step. Each round here emits every
    available pair that is first both in its anchor's row and in its GT's
    column ("mutually best"): no pair the sequential loop emits earlier can
    share its row or column, so it emits that pair too, and the global
    first pair is always among them, so every round makes progress. (It is
    not enough that the anchor prefers this GT among the GTs proposing to
    it this round: a GT that lost its own best anchor this round may still
    outrank them on this anchor.) Rounds needed = length of the longest
    chain of displaced preferences (typically a few, bounded by L) vs one
    sequential iteration per GT.
    """
    num_anchors, num_labels = iou.shape
    gt_range = jnp.arange(num_labels, dtype=jnp.int32)

    def cond(state):
        _, _, _, gt_matched, progressed = state
        return progressed & jnp.any(col_valid & ~gt_matched)

    def body(state):
        anchor_matched, match_gt, match_iou, gt_matched, _ = state
        avail = (~anchor_matched)[:, None] & (col_valid & ~gt_matched)[None, :]
        masked = jnp.where(avail, iou, -1.0)
        # per GT: its first (= smallest index) best available anchor
        prop_v = jnp.max(masked, axis=0)  # (L,)
        prop_a = jnp.argmax(masked, axis=0).astype(jnp.int32)
        # per anchor: its first (= smallest index) best available GT
        best_g = jnp.argmax(masked, axis=1).astype(jnp.int32)  # (A,)
        accepted = ((prop_v > 1e-6) & col_valid & ~gt_matched
                    & (best_g[prop_a] == gt_range))  # (L,)
        progressed = jnp.any(accepted)
        # scatter accepted pairs (distinct anchors: best_g is one GT each)
        upd_a = jnp.where(accepted, prop_a, num_anchors)  # OOB drops
        anchor_matched = anchor_matched.at[upd_a].set(True, mode="drop")
        match_gt = match_gt.at[upd_a].set(gt_range, mode="drop")
        match_iou = match_iou.at[upd_a].set(prop_v, mode="drop")
        gt_matched = gt_matched | accepted
        return anchor_matched, match_gt, match_iou, gt_matched, progressed

    state = (
        jnp.zeros((num_anchors,), bool),
        jnp.full((num_anchors,), -1, jnp.int32),
        jnp.full((num_anchors,), -1.0, jnp.float32),
        jnp.zeros((num_labels,), bool),
        jnp.array(True),
    )
    anchor_matched, match_gt, match_iou, gt_matched, _ = jax.lax.while_loop(cond, body, state)
    return anchor_matched, match_gt, match_iou, gt_matched


def _valid_columns(labels):
    """Rows valid up to the first ``cls == -1`` (multibox_target.cc:96-105).

    labels: (L, 6) rows of one image."""
    num_labels = labels.shape[0]
    is_pad = labels[:, 0] == -1.0
    num_valid = jnp.where(jnp.any(is_pad), jnp.argmax(is_pad), num_labels)
    return jnp.arange(num_labels) < num_valid


def _target_single(
    anchors,
    labels,
    cls_pred,
    overlap_threshold,
    negative_mining_ratio,
    negative_mining_thresh,
    ignore_label,
    variances,
):
    """Targets for one image. anchors (A,4), labels (L,6), cls_pred (C,A)."""
    num_anchors = anchors.shape[0]
    num_labels = labels.shape[0]

    col_valid = _valid_columns(labels)
    num_valid = jnp.sum(col_valid).astype(jnp.int32)

    iou = box_ops.iou_matrix(anchors, labels[:, 1:5])  # (A, L)

    pos1, match_gt, match_iou, _ = _bipartite_match(iou, col_valid)

    # Phase 2: per-anchor best GT for everything phase 1 left unmatched.
    masked_iou = jnp.where(col_valid[None, :], iou, -1.0)
    row_best_gt = jnp.argmax(masked_iou, axis=1).astype(jnp.int32)
    row_best_iou = jnp.max(masked_iou, axis=1)
    final_gt = jnp.where(pos1, match_gt, row_best_gt)
    final_iou = jnp.where(pos1, match_iou, row_best_iou)
    if overlap_threshold > 0:
        positive = pos1 | ((~pos1) & (row_best_iou > overlap_threshold))
    else:
        # reference gates the whole threshold-matching phase on
        # overlap_threshold > 0 (multibox_target.cc:151) — bipartite
        # matches only
        positive = pos1
    num_pos = jnp.sum(positive).astype(jnp.int32)

    # Phase 3: negatives.
    if negative_mining_ratio > 0:
        num_neg = jnp.minimum(
            (num_pos.astype(jnp.float32) * negative_mining_ratio).astype(jnp.int32),
            num_anchors - num_pos,
        )
        candidate = (~positive) & (final_iou < negative_mining_thresh)
        bg_prob = jax.nn.softmax(cls_pred, axis=0)[0]  # (A,)
        sort_key = jnp.where(candidate, bg_prob, 2.0)  # probs are <= 1
        order = jnp.argsort(sort_key, stable=True)
        rank = jnp.argsort(order, stable=True)  # rank of each anchor in ascending prob
        negative = candidate & (rank < num_neg)
    else:
        negative = ~positive

    has_gt = num_valid > 0
    positive &= has_gt
    negative &= has_gt

    # matched-GT rows: a gather is exact at any matmul precision (a one-hot
    # f32 dot would run in TF32 on tensor cores and round the coordinates);
    # final_gt is always in [0, L)
    matched = jnp.take(labels, final_gt, axis=0)  # (A, 6)
    matched_cls = matched[:, 0]
    cls_target = jnp.where(
        positive,
        matched_cls + 1.0,
        jnp.where(negative, 0.0, ignore_label),
    )

    matched_boxes = matched[:, 1:5]
    matched_dist = matched[:, 5]
    loc_target = box_ops.encode_targets(anchors, matched_boxes, matched_dist, variances)
    loc_mask = jnp.where(positive[:, None], 1.0, 0.0) * jnp.ones((1, 5), loc_target.dtype)
    loc_target = loc_target * loc_mask
    return loc_target, loc_mask, cls_target


@partial(
    jax.jit,
    static_argnames=(
        "overlap_threshold",
        "ignore_label",
        "negative_mining_ratio",
        "negative_mining_thresh",
        "minimum_negative_samples",
        "variances",
    ),
)
def multibox_target(
    anchors,
    labels,
    cls_preds,
    overlap_threshold: float = 0.5,
    ignore_label: float = -1.0,
    negative_mining_ratio: float = -1.0,
    negative_mining_thresh: float = 0.5,
    minimum_negative_samples: int = 0,  # accepted, unused (as in the reference)
    variances: tuple = box_ops.DEFAULT_VARIANCES,
):
    """Batched MultiBoxTarget.

    Args:
      anchors:   (A, 4) or (1, A, 4) corner anchors (batch-shared constants).
      labels:    (B, L, 6) rows ``[cls, xmin, ymin, xmax, ymax, dist]``,
                 -1-padded after the last valid row.
      cls_preds: (B, C, A) raw class logits (background = class 0).

    Returns:
      loc_target (B, A, 5), loc_mask (B, A, 5), cls_target (B, A) float32.
      (The reference flattens loc outputs to (B, A*5); use ``.reshape`` at the
      call site where that layout is needed.)
    """
    del minimum_negative_samples
    if anchors.ndim == 3:
        anchors = anchors[0]
    anchors = anchors.astype(jnp.float32)
    labels = labels.astype(jnp.float32)
    cls_preds = cls_preds.astype(jnp.float32)
    fn = partial(
        _target_single,
        anchors,
        overlap_threshold=overlap_threshold,
        negative_mining_ratio=negative_mining_ratio,
        negative_mining_thresh=negative_mining_thresh,
        ignore_label=ignore_label,
        variances=variances,
    )
    return jax.vmap(lambda l, c: fn(l, cls_pred=c))(labels, cls_preds)
