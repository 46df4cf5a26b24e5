"""Greedy-NMS keep mask (ops/detection, the XLA fixpoint) against the
sequential oracle of tests/oracles.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dspnet_tpu.ops.detection import _nms_xla_single

from tests import oracles


def _random_rows(rng, B, K):
    cx = rng.uniform(0.1, 0.9, (B, K))
    cy = rng.uniform(0.1, 0.9, (B, K))
    w = rng.uniform(0.05, 0.4, (B, K))
    h = rng.uniform(0.05, 0.4, (B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    ids = rng.randint(0, 3, (B, K)).astype(np.float32)
    valid = rng.rand(B, K) > 0.2
    ids = np.where(valid, ids, -1.0)
    return boxes, ids, valid


@pytest.mark.parametrize("force", [False, True])
def test_nms_keep_mask_matches_oracle(rng, force):
    B, K = 3, 50
    boxes, ids, valid = _random_rows(rng, B, K)
    got = np.asarray(jax.vmap(
        lambda v, i, b: _nms_xla_single(v, i, b, 0.5, force, K))(
            jnp.asarray(valid), jnp.asarray(ids), jnp.asarray(boxes)))
    for b in range(B):
        rows = np.zeros((K, 6))
        rows[:, 0], rows[:, 2:6] = ids[b], boxes[b]
        want = oracles.greedy_nms_oracle(rows, K, 0.5, force)[:, 0] >= 0
        np.testing.assert_array_equal(got[b], want)
