"""Metric tests: mAP matching semantics, IoU, depth-error oracle, confusion."""

import numpy as np
import pytest

from dspnet_tpu.evaluate.cityscapes_eval import (
    add_to_confusion_matrix,
    class_iou_scores,
    evaluate_pairs,
)
from dspnet_tpu.evaluate.eval_metric import (
    CustomAccuracyMetric,
    DistanceAccuracyMetric,
    IoUMetric,
    MApMetric,
    VOC07MApMetric,
)


def test_map_perfect_detection():
    m = MApMetric(class_names=["a", "b"])
    gt = np.array([[0, 0.1, 0.1, 0.5, 0.5], [1, 0.6, 0.6, 0.9, 0.9]])
    pred = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.5], [1, 0.8, 0.6, 0.6, 0.9, 0.9]])
    m.update([gt], [pred])
    d = m.get_dict()
    assert d["mAP"] == pytest.approx(1.0)


def test_map_duplicate_is_fp():
    m = MApMetric(class_names=["a"])
    gt = np.array([[0, 0.1, 0.1, 0.5, 0.5]])
    pred = np.array(
        [[0, 0.9, 0.1, 0.1, 0.5, 0.5], [0, 0.8, 0.1, 0.1, 0.5, 0.5]]
    )
    m.update([gt], [pred])
    names, values = m.get()
    # 1 tp then 1 duplicate fp: AP = area under [recall 1, prec 1] envelope = 1.0
    assert values[0] == pytest.approx(1.0)
    # low-score fp first instead -> lower AP
    m2 = MApMetric(class_names=["a"])
    pred2 = np.array(
        [[0, 0.9, 0.6, 0.6, 0.9, 0.9], [0, 0.8, 0.1, 0.1, 0.5, 0.5]]
    )
    m2.update([gt], [pred2])
    _, v2 = m2.get()
    assert v2[0] == pytest.approx(0.5)


def test_map_missed_class_counts():
    m = MApMetric(class_names=["a", "b"])
    gt = np.array([[1, 0.1, 0.1, 0.5, 0.5]])
    pred = np.zeros((0, 6))
    m.update([gt], [pred])
    names, values = m.get()
    assert values[1] == pytest.approx(0.0)  # class b: recall 0


def test_voc07_metric_differs():
    gt = np.array([[0, 0.1, 0.1, 0.5, 0.5], [0, 0.6, 0.6, 0.9, 0.9]])
    pred = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.5], [0, 0.3, 0.0, 0.0, 0.2, 0.2]])
    m07 = VOC07MApMetric(class_names=["a"])
    m07.update([gt], [pred])
    _, v = m07.get()
    # 1 tp of 2 gts + 1 fp -> 11-point AP = 6/11 * 1.0 * ... = (recall>=0..0.5 -> p=1)
    assert v[0] == pytest.approx(6 / 11.0, abs=1e-6)


def test_iou_metric():
    m = IoUMetric(["c0", "c1"])
    labels = np.array([[[0, 0], [1, 1]]])
    preds = np.array([[[0, 1], [1, 1]]])
    m.update(labels, preds)
    d = m.get_dict()
    assert d["c0"] == pytest.approx(1 / 2)  # inter 1, union 2
    assert d["c1"] == pytest.approx(2 / 3)


def test_accuracy_metric():
    m = CustomAccuracyMetric()
    m.update(np.array([[0, 1, 2]]), np.array([[0, 1, 1]]))
    assert m.get()[1] == pytest.approx(2 / 3)


def test_distance_metric_median_oracle():
    m = DistanceAccuracyMetric(["car"])
    disparity = np.full((100, 100), 2200.0 * 75.0 / 50.0)  # 50 m everywhere
    # predicted 60 m (dist channel normalized /255)
    det = np.array([[0, 0.9, 0.1, 0.1, 0.5, 0.5, 60.0 / 255.0]])
    m.update(disparity, det)
    names, values = m.get()
    assert values[0] == pytest.approx(10.0 / 50.0, rel=1e-3)


def test_confusion_matrix_and_scores():
    gt = np.full((10, 10), 7, np.uint8)  # road
    pred = np.full((10, 10), 7, np.uint8)
    pred[0, :5] = 11  # some building fp
    res = evaluate_pairs([(pred, gt)])
    assert res["classScores"]["road"] == pytest.approx(95 / 100)
    assert res["classScores"]["building"] == pytest.approx(0.0)
    conf = np.zeros((256, 256), np.int64)
    add_to_confusion_matrix(pred, gt, conf)
    assert conf[7, 7] == 95 and conf[7, 11] == 5


def test_confusion_matrix_jax_matches():
    import jax.numpy as jnp
    from dspnet_tpu.evaluate.cityscapes_eval import add_to_confusion_matrix_jax

    rng = np.random.RandomState(0)
    gt = rng.randint(0, 34, (20, 20)).astype(np.uint8)
    pred = rng.randint(0, 34, (20, 20)).astype(np.uint8)
    conf_np = add_to_confusion_matrix(pred, gt, np.zeros((256, 256), np.int64))
    conf_j = add_to_confusion_matrix_jax(
        jnp.asarray(pred), jnp.asarray(gt), jnp.zeros((256, 256), jnp.int32)
    )
    np.testing.assert_array_equal(conf_np, np.asarray(conf_j))


def test_update_from_confusion_bit_identical():
    """The device eval loop feeds IoU/accuracy from an on-device confusion
    matrix; the feeder must reproduce the per-pixel update() exactly —
    including ignore-255 labels and negative no-label fills (which the loop
    maps to the 255 bin)."""
    import jax.numpy as jnp

    from dspnet_tpu.evaluate.cityscapes_eval import NUM_IDS, add_to_confusion_matrix_jax

    rng = np.random.RandomState(3)
    labels = rng.randint(0, 19, (3, 16, 16)).astype(np.int32)
    labels[0, :2] = 255  # ignore
    labels[1, :1] = -1  # no-label fill
    preds = rng.randint(0, 19, (3, 16, 16)).astype(np.int32)

    names = [f"c{i}" for i in range(19)]
    iou_host, acc_host = IoUMetric(names), CustomAccuracyMetric()
    iou_host.update(labels, preds)
    acc_host.update(labels, preds)

    gt = jnp.where(jnp.asarray(labels) < 0, NUM_IDS - 1,
                   jnp.minimum(jnp.asarray(labels), NUM_IDS - 1))
    conf = add_to_confusion_matrix_jax(
        jnp.asarray(preds), gt, jnp.zeros((NUM_IDS, NUM_IDS), jnp.int32))
    iou_conf, acc_conf = IoUMetric(names), CustomAccuracyMetric()
    iou_conf.update_from_confusion(np.asarray(conf))
    acc_conf.update_from_confusion(np.asarray(conf))

    np.testing.assert_array_equal(iou_host.sum_metric, iou_conf.sum_metric)
    np.testing.assert_array_equal(iou_host.num_inst, iou_conf.num_inst)
    assert acc_host.get()[1] == acc_conf.get()[1]
    assert acc_host.sum_metric == acc_conf.sum_metric
    assert acc_host.num_inst == acc_conf.num_inst


def test_voc_eval_offline(tmp_path):
    from dspnet_tpu.evaluate.eval_voc import voc_eval

    xml = """<annotation><object><name>car</name><difficult>0</difficult>
    <bndbox><xmin>10</xmin><ymin>10</ymin><xmax>50</xmax><ymax>50</ymax></bndbox>
    </object></annotation>"""
    (tmp_path / "im1.xml").write_text(xml)
    rec, prec, ap = voc_eval(
        [("im1", 0.9, 10, 10, 50, 50)],
        str(tmp_path) + "/{}.xml",
        ["im1"],
        "car",
    )
    assert ap == pytest.approx(1.0)


def test_write_result_png_from_probs(tmp_path):
    """Bilinear probability upsampling then argmax (reference prob_upsampling,
    multi_eval.py:28-34) vs nearest-argmax: at a class boundary the prob path
    places the transition where interpolated probabilities cross."""
    import cv2

    from dspnet_tpu.data.cs_labels import TRAINID_TO_LABELID
    from dspnet_tpu.evaluate.cityscapes_eval import (
        write_result_png,
        write_result_png_from_probs,
    )

    h, w, c = 8, 16, 19
    prob = np.zeros((h, w, c), np.float32)
    prob[:, : w // 2, 1] = 1.0  # left half: class 1
    prob[:, w // 2:, 2] = 1.0  # right half: class 2
    p1 = str(tmp_path / "probs.png")
    write_result_png_from_probs(prob, p1, full_hw=(32, 64))
    out = cv2.imread(p1, cv2.IMREAD_GRAYSCALE)
    assert out.shape == (32, 64)
    # labelId mapping applied, both classes present
    assert set(np.unique(out)) <= set(TRAINID_TO_LABELID.tolist())
    assert (out == TRAINID_TO_LABELID[1]).any() and (out == TRAINID_TO_LABELID[2]).any()
    # consistency with the argmax-map path away from the boundary
    p2 = str(tmp_path / "nearest.png")
    write_result_png(prob.argmax(-1).astype(np.uint8), p2, full_hw=(32, 64))
    near = cv2.imread(p2, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(out[:, :16], near[:, :16])
    np.testing.assert_array_equal(out[:, -16:], near[:, -16:])
