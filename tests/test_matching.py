"""Greedy bipartite matching (ops/target._bipartite_match, the XLA
while-loop matcher) and the full MultiBoxTarget against the sequential
oracles of tests/oracles.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dspnet_tpu.ops import boxes as box_ops
from dspnet_tpu.ops.target import _bipartite_match, multibox_target

from tests import oracles


def _boxes(rng, shape, lo=0.05, hi=0.3):
    cx = rng.uniform(0.1, 0.9, shape)
    cy = rng.uniform(0.1, 0.9, shape)
    w = rng.uniform(lo, hi, shape)
    h = rng.uniform(lo, hi, shape)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _check_against_oracle(anchors, gts, num_gt):
    """_bipartite_match on one image vs bipartite_match_oracle on the same
    f32 IoU table: same matched anchors, same GT per anchor."""
    L = gts.shape[0]
    col_valid = np.arange(L) < num_gt
    iou = box_ops.iou_matrix(jnp.asarray(anchors), jnp.asarray(gts))
    got_m, got_gt, got_iou, got_gm = jax.jit(_bipartite_match)(
        iou, jnp.asarray(col_valid))
    want_gt, want_iou = oracles.bipartite_match_oracle(np.asarray(iou), num_gt)
    np.testing.assert_array_equal(np.asarray(got_m), want_gt >= 0)
    np.testing.assert_array_equal(np.asarray(got_gt), want_gt)
    np.testing.assert_allclose(np.asarray(got_iou), want_iou, rtol=1e-6)
    assert int(np.asarray(got_gm).sum()) == int((want_gt >= 0).sum())


@pytest.mark.parametrize("num_gt", [0, 1, 7, 16])
def test_bipartite_matching_matches_oracle(rng, num_gt):
    B, A, L = 2, 150, 16
    anchors = _boxes(rng, (B, A))
    gts = _boxes(rng, (B, L))
    for b in range(B):
        _check_against_oracle(anchors[b], gts[b], num_gt)


def test_bipartite_matching_vgg512_anchor_scale(rng):
    """A=24576 (the vgg@512 anchor count), 200 label rows of which 9 valid."""
    A, L, num_gt = 24576, 200, 9
    _check_against_oracle(_boxes(rng, (A,)), _boxes(rng, (L,)), num_gt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bipartite_matching_crowded_matches_oracle(seed):
    """50 GTs on the 772 anchors of resnet-50_multi at 128x256: GTs compete
    for the same anchors, so a GT that loses its best anchor in one round
    must still outrank a weaker GT on its next-best anchor."""
    from dspnet_tpu.api import create_model

    anchors = create_model("resnet-50_multi", (128, 256)).anchors
    rng = np.random.RandomState(seed)
    _check_against_oracle(anchors, _boxes(rng, (60,), 0.02, 0.4), 50)


def test_multibox_target_full_matches_oracle(rng):
    """Full multibox_target (hard-negative mining on) vs the oracle."""
    B, A, L, C = 2, 150, 16, 9
    anchors = _boxes(rng, (A,))
    labels = np.full((B, L, 6), -1.0, np.float32)
    for b in range(B):
        n = rng.randint(1, 6)
        labels[b, :n, 0] = rng.randint(0, 8, n)
        labels[b, :n, 1:5] = _boxes(rng, (n,), 0.1, 0.3)
        labels[b, :n, 5] = rng.uniform(0, 1, n)
    cls_preds = rng.randn(B, C, A).astype(np.float32)

    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3.0)
    got = multibox_target(jnp.asarray(anchors), jnp.asarray(labels),
                          jnp.asarray(cls_preds), **kw)
    want = oracles.multibox_target_oracle(anchors, labels, cls_preds, **kw)
    np.testing.assert_array_equal(np.asarray(got[2]), want[2])  # cls_target
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])  # loc_mask
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=1e-5, atol=1e-5)


def test_target_assignment_has_no_matmul(rng):
    """The matched-GT lookup is a gather and nothing else on the target
    path is a dot, so the targets are exact whatever the default matmul
    precision: on tensor cores an f32 dot runs in TF32 and a one-hot dot
    would round box corners and distances to 10 mantissa bits."""
    A, L, C = 150, 16, 9
    labels = np.full((2, L, 6), -1.0, np.float32)
    labels[:, :5, 0] = 1.0
    labels[:, :5, 1:5] = _boxes(rng, (2, 5), 0.1, 0.3)
    jaxpr = jax.make_jaxpr(
        lambda a, l, c: multibox_target(a, l, c, negative_mining_ratio=3.0))(
            jnp.asarray(_boxes(rng, (A,))), jnp.asarray(labels),
            jnp.zeros((2, C, A), jnp.float32))
    assert "dot_general" not in str(jaxpr)
