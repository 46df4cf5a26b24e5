"""Multitask losses with the reference's exact gradient scaling.

The reference expresses losses as MXNet output layers
(multitask_symbol_builder.py:526-532, 588-589); their backward passes define
the effective scalar objective we differentiate here:

* classification — SoftmaxOutput(ignore_label=-1, normalization='valid',
  grad_scale=1): sum of CE over anchors with target >= 0, divided by that
  valid count (across the whole batch).
* localization — smooth_l1(mask * (pred - target), scalar=1) through
  MakeLoss(normalization='valid'): summed, divided by the number of non-zero
  loss elements (MakeLoss 'valid' counts elements above valid_thresh=0).
* segmentation — SoftmaxOutput(ignore_label=255, grad_scale=4,
  normalization default 'null'): 4 x the *unnormalized* sum of per-pixel CE
  over non-ignored pixels (this is the FCN-style convention the reference
  trains with; lr 5e-4 in run_multi.sh is calibrated to it).

``seg_normalize='valid'`` is provided as an opt-in alternative for stable
large-batch training; the default reproduces the reference.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

SEG_IGNORE = 255
CLS_IGNORE = -1.0


def smooth_l1(x, scalar: float = 1.0):
    """MXNet smooth_l1 with sigma=scalar (smooth_l1 docs; scalar=1 is the
    classic Huber-like SSD loss)."""
    s2 = scalar * scalar
    ax = jnp.abs(x)
    return jnp.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def cls_loss_valid(cls_logits, cls_target):
    """(B, A, C) logits vs (B, A) targets; ignore -1; 'valid' normalization.
    Returns (loss, valid_count)."""
    valid = cls_target != CLS_IGNORE
    tgt = jnp.maximum(cls_target, 0).astype(jnp.int32)
    logp = jax.nn.log_softmax(cls_logits, axis=-1)
    # one-hot contraction instead of take_along_axis: the iota+eq+select
    # fuses into the reduce, and the backward is an elementwise multiply
    # instead of a scatter
    oh = jax.nn.one_hot(tgt, logp.shape[-1], dtype=logp.dtype)
    ce = -jnp.sum(logp * oh, axis=-1)
    ce = jnp.where(valid, ce, 0.0)
    count = jnp.sum(valid)
    return jnp.sum(ce) / jnp.maximum(count, 1), count


def loc_loss_valid(loc_preds, loc_target, loc_mask):
    """Masked smooth-L1 with MakeLoss-'valid' normalization (non-zero count)."""
    elems = smooth_l1(loc_mask * (loc_preds - loc_target), 1.0)
    nonzero = jnp.sum(elems > 0.0)
    return jnp.sum(elems) / jnp.maximum(nonzero, 1), jnp.sum(elems)


def seg_loss_and_accuracy(seg_logits, seg_labels, grad_scale: float = 4.0,
                          normalize: str = "null"):
    """(B, H, W, C) logits vs (B, H, W) int labels with ignore 255.

    Returns (loss, correct_count, valid_count). CE and the monitoring
    accuracy share ONE pass over the lane-padded (C=19 of 128) logits: a
    pixel counts as correct iff its label's logit EQUALS the lane max
    (``picked == 0`` on the max-shifted logits — exact, bf16 subtraction
    of distinct values never rounds to 0). This is tie-LENIENT vs
    jnp.argmax's first-occurrence rule: on an exact multi-lane tie that
    includes the label it counts correct where argmax may not — identical
    in the absence of ties, and a monitoring-only metric (eval accuracy
    comes from the real argmax in the detector path). Why: it saves XLA's
    variadic (max, index) argmax reduce, a second pass over the logits,
    for this monitoring metric alone.
    Per-pixel CE is bit-identical to -sum(log_softmax * one_hot):
    lse - shifted[t] rounds exactly like -(shifted[t] - lse)."""
    valid = seg_labels != SEG_IGNORE
    tgt = jnp.where(valid, seg_labels, 0).astype(jnp.int32)
    c = seg_logits.shape[-1]
    m = jnp.max(jax.lax.stop_gradient(seg_logits), axis=-1, keepdims=True)
    shifted = seg_logits - m
    lse = jnp.log(jnp.sum(jnp.exp(shifted), axis=-1))
    oh = jax.nn.one_hot(tgt, c, dtype=seg_logits.dtype)
    picked = jnp.sum(shifted * oh, axis=-1)
    ce = jnp.where(valid, lse - picked, 0.0)
    total = jnp.sum(ce)
    if normalize == "valid":
        total = total / jnp.maximum(jnp.sum(valid), 1)
    correct = jnp.sum(valid & (jax.lax.stop_gradient(picked) == 0.0))
    return grad_scale * total, correct, jnp.sum(valid)


def seg_loss(seg_logits, seg_labels, grad_scale: float = 4.0, normalize: str = "null"):
    """(B, H, W, C) logits vs (B, H, W) int labels with ignore 255."""
    return seg_loss_and_accuracy(seg_logits, seg_labels, grad_scale, normalize)[0]


def multitask_loss(
    outputs: Dict,
    loc_target,
    loc_mask,
    cls_target,
    seg_labels=None,
    seg_grad_scale: float = 4.0,
    seg_normalize: str = "null",
):
    """Combined objective + monitoring scalars.

    Returns (total_loss, metrics dict). Metrics mirror MultiBoxMetric
    (train/metric.py:27-46): CrossEntropy and SmoothL1 both normalized by the
    valid anchor count.
    """
    metrics = {}
    total = 0.0
    # cls_target is None when the batch carries no label_det (e.g. a multi
    # model fed seg-only data) — skip the detection losses cleanly
    if "cls_logits" in outputs and cls_target is not None:
        cls_l, valid_count = cls_loss_valid(outputs["cls_logits"], cls_target)
        loc_l, loc_sum = loc_loss_valid(outputs["loc_preds"], loc_target, loc_mask)
        total = total + cls_l + loc_l
        metrics["cross_entropy"] = cls_l  # already per-valid-anchor
        metrics["smooth_l1"] = loc_sum / jnp.maximum(valid_count, 1)
        metrics["valid_anchors"] = valid_count
    if seg_labels is not None and "seg_logits" in outputs:
        s, correct, valid_px = seg_loss_and_accuracy(
            outputs["seg_logits"], seg_labels, seg_grad_scale, seg_normalize)
        total = total + s
        metrics["seg_loss"] = s
        metrics["seg_accuracy"] = correct / jnp.maximum(valid_px, 1)
    metrics["loss"] = total
    return total, metrics
