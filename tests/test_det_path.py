"""Plain-SSD path tests: DetIterator, 4-channel loc training, transfer init."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model
from dspnet_tpu.data import synthetic
from dspnet_tpu.data.det_iterator import DetIterator
from dspnet_tpu.train.solver import MultiTaskSolver
from dspnet_tpu.utils.transfer import merge_param_subtree


@pytest.fixture(scope="module")
def det_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("detsynth"))
    return synthetic.build_dataset(root, num_samples=4, hw=(96, 96), with_disparity=False)


def test_det_iterator_contract(det_dataset):
    it = DetIterator(det_dataset, batch_size=2, data_shape=(96, 96), is_train=True)
    batch = it.next_batch()
    assert batch["images"].shape == (2, 96, 96, 3)
    assert batch["label_det"].shape == (2, 100, 6)
    lbl = batch["label_det"]
    valid = lbl[lbl[:, :, 0] >= 0]
    assert valid.shape[0] >= 1
    assert np.all(valid[:, 1:5] >= -1e-6) and np.all(valid[:, 1:5] <= 1 + 1e-6)
    assert np.all(valid[:, 5] == 0.0)  # dist column zero for plain det


def test_ssd_train_step_4channel(det_dataset):
    """Classic 4-coordinate SSD trains through the shared solver."""
    from dspnet_tpu.models import factory
    from dspnet_tpu.models.dspnet import SSDNet

    cfg = factory.get_config("resnet-18", 512)
    # use the multitask drop so taps exist at this tiny size; SSDNet accepts
    # resnet named taps
    model = SSDNet(cfg=factory.get_config("resnet-18", 512), num_classes=8)
    anchors = factory.build_anchors(cfg, (96, 96))
    it = DetIterator(det_dataset, batch_size=2, data_shape=(96, 96), is_train=True)
    batch = it.next_batch()
    solver = MultiTaskSolver(model, anchors, learning_rate=1e-3, batch_size=2)
    state = solver.init_state(jax.random.PRNGKey(0), jnp.asarray(batch["images"]))
    state, metrics = solver.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert "seg_loss" not in metrics


def test_ssd_memorizes_and_scores_one_batch():
    """End-to-end SSD-pillar floor (VERDICT r4 item 3): overfit one fixed
    batch, then decode with the Detector and score with MApMetric — the
    GT classes must reach AP ~1.0. This exercises target assignment, the
    4-channel loss, decode/NMS, and the metric in one closed loop with a
    known answer; the full convergence trajectory (real images, the det
    loader's crop/pad/mirror/jitter aug, VOC07 scoring) is the run in
    docs/VOC_CONVERGENCE.md."""
    from dspnet_tpu.detect.detector import Detector
    from dspnet_tpu.evaluate.eval_metric import MApMetric

    H = W = 96
    bundle = create_model("resnet-18", (H, W), num_classes=8)
    solver = MultiTaskSolver(bundle.model, bundle.anchors,
                             learning_rate=2.5e-3, batch_size=4)
    state = solver.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    rng = np.random.RandomState(0)
    img = rng.rand(4, H, W, 3).astype(np.float32) * 200 - 100
    lab = np.full((4, 100, 6), -1.0, np.float32)
    lab[:, 0] = [2.0, 0.2, 0.2, 0.7, 0.7, 0.0]
    lab[:, 1] = [5.0, 0.5, 0.1, 0.9, 0.6, 0.0]
    batch = {"images": img, "label_det": lab}
    for _ in range(300):
        state, m = solver.train_step(state, batch)
    assert float(m["cross_entropy"]) < 0.5, m
    det = Detector(bundle.model, MultiTaskSolver.detector_variables(state),
                   bundle.anchors, (H, W))
    d = np.asarray(det.predict(img)["det"])
    metric = MApMetric(0.5, False, [f"c{i}" for i in range(8)])
    metric.update([lab[b] for b in range(4)], [d[b] for b in range(4)])
    names, vals = metric.get()
    ap = dict(zip(names, vals))
    # the GT classes must be found with tight boxes; classes without GT
    # collect low-score junk (AP 0 by the parity metric's definition) so
    # the composite mAP is not the right floor here
    assert ap["c2"] >= 0.9 and ap["c5"] >= 0.9, ap


def test_merge_param_subtree():
    params = {"backbone": {"conv": np.zeros((3, 3)), "bn": np.zeros(4)},
              "head": {"w": np.ones(2)}}
    pre = {"backbone": {"conv": np.ones((3, 3))}}
    merged = merge_param_subtree(params, pre)
    assert np.all(merged["backbone"]["conv"] == 1)
    assert np.all(merged["backbone"]["bn"] == 0)  # missing upstream -> fresh
    assert np.all(merged["head"]["w"] == 1)
    with pytest.raises(ValueError):
        merge_param_subtree(params, {"backbone": {"conv": np.ones((2, 2))}})


def test_init_from_checkpoint_cross_architecture(tmp_path):
    """Transfer init must read a checkpoint from a DIFFERENT head config
    (template-free restore) and merge only the backbone subtree."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.train.solver import MultiTaskSolver
    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
    from dspnet_tpu.utils.transfer import init_from_checkpoint

    x = jnp.zeros((1, 64, 128, 3))
    src = create_model("resnet-18_det", (64, 128), num_classes=8)
    s_src = MultiTaskSolver(src.model, src.anchors)
    st_src = s_src.init_state(jax.random.PRNGKey(0), x)
    ck = CheckpointManagerWrapper(str(tmp_path / "src"))
    ck.save(0, st_src)
    ck.close()

    dst = create_model("resnet-18_det", (64, 128), num_classes=20)  # new heads
    s_dst = MultiTaskSolver(dst.model, dst.anchors)
    st_dst = s_dst.init_state(jax.random.PRNGKey(1), x)
    merged = init_from_checkpoint(st_dst, str(tmp_path / "src"))
    # backbone leaves equal the source checkpoint, heads keep fresh init
    src_leaf = np.asarray(jax.tree.leaves(st_src.params["backbone"])[0])
    got_leaf = np.asarray(jax.tree.leaves(merged.params["backbone"])[0])
    np.testing.assert_array_equal(got_leaf, src_leaf)
    mb_new = jax.tree.leaves(merged.params["multibox"])
    mb_dst = jax.tree.leaves(st_dst.params["multibox"])
    assert all(np.asarray(a).shape == np.asarray(b).shape
               for a, b in zip(mb_new, mb_dst))
