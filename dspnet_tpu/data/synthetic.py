"""Synthetic Cityscapes-format fixtures.

The reference assumes the real Cityscapes download; for tests, demos and
benchmarks we synthesize a tiny dataset in the same on-disk contract:
JPEG street-ish images, gtFine-style trainId segmentation PNGs, disparity
PNGs (for the depth-eval oracle), and the (cls, corners, distance) label
matrix. Determinism: everything derives from a single numpy seed.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from dspnet_tpu.data.cs_labels import DET_CLASSES, name2label, trainId2label
from dspnet_tpu.data.iterator import MAX_OBJECTS, Sample, SampleIndex

# disparity -> meters constant used across the reference
# (train/metric.py:222, data/cityscapes/disparity2distance.py:67)
DISPARITY_SCALE = 2200.0 * 75.0

# det class index -> seg trainId (person 11 ... bicycle 18)
_DET_TRAINID = [name2label[n].trainId for n in DET_CLASSES]
# distinctive BGR per trainId: the official Cityscapes palette (RGB in the
# label table) reversed — every class has a unique, learnable appearance
_TRAINID_BGR = {
    t: tuple(int(c) for c in reversed(trainId2label[t].color))
    for t in range(19)
}


def make_example(
    rng: np.random.RandomState, hw: Tuple[int, int], num_objects: int, num_classes: int = 8
):
    """Returns (img BGR uint8, label rows (n, 6) normalized, seg trainId uint8,
    disparity uint16).

    Scenes paint ALL 19 trainId classes with plausible street geometry
    (sky/buildings/vegetation above a horizon; terrain/road/sidewalk below;
    walls, fences, poles carrying traffic lights and signs; det-class
    objects on the road painted with their own trainId), so seg training
    exercises the full 19-way discrimination instead of a 3-class ceiling.
    Ten static classes are guaranteed present per image (vegetation can be
    fully overpainted by later geometry); det-class coverage follows the
    sampled boxes, and all 19 classes appear across a handful of images.
    """
    import cv2
    H, W = hw
    img = np.zeros((H, W, 3), np.uint8)
    seg = np.full((H, W), 255, np.uint8)
    disparity = np.zeros((H, W), np.uint16)
    disparity[:] = int(DISPARITY_SCALE / 150.0)  # far background

    def paint(y1, y2, x1, x2, tid):
        y1, y2 = max(0, y1), min(H, y2)
        x1, x2 = max(0, x1), min(W, x2)
        if y2 <= y1 or x2 <= x1:
            return
        seg[y1:y2, x1:x2] = tid
        img[y1:y2, x1:x2] = _TRAINID_BGR[tid]

    horizon = H // 3 + rng.randint(-H // 16, H // 16 + 1)

    # sky above the horizon
    paint(0, horizon, 0, W, 10)
    # buildings rising above the horizon
    for _ in range(rng.randint(2, 5)):
        bw, bh = rng.randint(W // 10, W // 4), rng.randint(H // 6, max(H // 6 + 1, horizon))
        x = rng.randint(0, W - bw)
        paint(horizon - bh, horizon, x, x + bw, 2)
    # vegetation blobs straddling the horizon
    for _ in range(rng.randint(1, 4)):
        vw, vh = rng.randint(W // 16, W // 6), rng.randint(H // 12, H // 5)
        x = rng.randint(0, W - vw)
        paint(horizon - vh // 2, horizon + vh // 2, x, x + vw, 8)
    # wall slab on the left edge, fence on the right (always present)
    wall_h = max(3, H // 10)
    paint(horizon - wall_h, horizon, 0, rng.randint(W // 8, W // 3), 3)
    fx = rng.randint(W // 2, W - W // 8)
    paint(horizon - max(2, H // 12), horizon, fx, W, 4)
    # terrain strip then road below
    th = max(2, H // 24)
    road_top = horizon + th
    paint(horizon, road_top, 0, W, 9)
    paint(road_top, H, 0, W, 0)
    # sidewalks flanking the road
    sw = max(3, W // 10)
    paint(road_top, H, 0, sw, 1)
    paint(road_top, H, W - sw, W, 1)
    # poles crossing the horizon; first two carry a traffic light / sign
    # (always one of each per image)
    n_poles = rng.randint(2, 4)
    for pi in range(n_poles):
        pw = max(2, W // 80)
        px = rng.randint(sw, W - sw - pw)
        ph = rng.randint(H // 5, H // 3)
        paint(horizon - ph, road_top + H // 12, px, px + pw, 5)
        s = max(3, H // 24)
        if pi == 0:  # traffic light box at the pole top
            paint(horizon - ph, horizon - ph + 2 * s, px - s // 2, px + pw + s // 2, 6)
        elif pi == 1:  # traffic sign square
            paint(horizon - ph, horizon - ph + s, px - s // 2, px + pw + s // 2, 7)

    rows = []
    for _ in range(num_objects):
        cls = rng.randint(0, num_classes)
        w = rng.randint(max(6, W // 16), max(8, W // 4))
        h = rng.randint(max(6, H // 16), max(8, H // 4))
        x1 = rng.randint(0, W - w)
        y1 = rng.randint(max(0, horizon - h // 2), H - h)
        # distance inversely tied to apparent size (learnable signal)
        dist_m = float(np.clip(30.0 * W / 8.0 / max(w, h), 5.0, 150.0))
        tid = _DET_TRAINID[cls % len(_DET_TRAINID)]
        cv2.rectangle(img, (x1, y1), (x1 + w - 1, y1 + h - 1),
                      _TRAINID_BGR[tid], -1)
        seg[y1 : y1 + h, x1 : x1 + w] = tid
        disparity[y1 : y1 + h, x1 : x1 + w] = int(DISPARITY_SCALE / dist_m)
        rows.append(
            [cls, x1 / W, y1 / H, (x1 + w) / W, (y1 + h) / H, min(1.0, dist_m / 255.0)]
        )
    label = np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
    return img, label, seg, disparity


def build_dataset(
    root: str,
    num_samples: int = 8,
    hw: Tuple[int, int] = (256, 512),
    max_objects: int = 6,
    seed: int = 233,
    with_disparity: bool = True,
    with_instances: bool = False,
) -> SampleIndex:
    """Write a synthetic dataset under ``root`` and return its SampleIndex.

    ``with_instances`` also writes gtFine-style ``*_instanceIds.png``
    (labelId*1000 + instance index per box, draw order = occlusion order)
    under SegmentationInstance/, for the instance-level evaluator."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(root, "SegmentationClass"), exist_ok=True)
    if with_disparity:
        os.makedirs(os.path.join(root, "Disparity"), exist_ok=True)
    if with_instances:
        os.makedirs(os.path.join(root, "SegmentationInstance"), exist_ok=True)
    samples = []
    for i in range(num_samples):
        img, label, seg, disp = make_example(rng, hw, rng.randint(1, max_objects + 1))
        ipath = os.path.join(root, "JPEGImages", f"synth_{i:04d}_leftImg8bit.jpg")
        spath = os.path.join(root, "SegmentationClass", f"synth_{i:04d}_gtFine_labelTrainIds.png")
        cv2.imwrite(ipath, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
        cv2.imwrite(spath, seg)
        if with_disparity:
            cv2.imwrite(os.path.join(root, "Disparity", f"synth_{i:04d}_disparity.png"), disp)
        if with_instances:
            from dspnet_tpu.data.cs_labels import name2label

            H, W = seg.shape
            inst = np.zeros((H, W), np.uint16)
            counts = [0] * len(DET_CLASSES)
            for row in label:
                cid = int(row[0])
                lid = name2label[DET_CLASSES[cid]].id
                x1, y1 = int(round(row[1] * W)), int(round(row[2] * H))
                x2, y2 = int(round(row[3] * W)), int(round(row[4] * H))
                inst[y1:y2, x1:x2] = lid * 1000 + counts[cid]
                counts[cid] += 1
            cv2.imwrite(os.path.join(
                root, "SegmentationInstance", f"synth_{i:04d}_gtFine_instanceIds.png"), inst)
        samples.append(Sample(ipath, SampleIndex.pad_label(label), spath))
    return SampleIndex(samples)


def class_names():
    return list(DET_CLASSES)


def build_voc_dataset(
    root: str,
    num_samples: int = 8,
    hw: Tuple[int, int] = (96, 96),
    max_objects: int = 4,
    seed: int = 233,
    year: str = "",
    splits=("train", "val"),
    difficult_frac: float = 0.2,
) -> str:
    """Write a synthetic PASCAL-VOC devkit tree under ``root`` and return
    the devkit root (== ``root``).

    Layout: ``{root}/VOC{year}/{JPEGImages,Annotations,ImageSets/Main}`` —
    what data.imdb.PascalVoc (and load_index's VOC fallback at year='')
    consumes. Scenes come from :func:`make_example` (boxes painted with
    distinctive per-class colors, a learnable signal); object names are the
    8 Cityscapes det classes (names are arbitrary strings to the VOC
    tooling — pass the same list as --class-names). ``difficult_frac`` of
    the objects per split are marked ``<difficult>1</difficult>`` so the
    use_difficult metric paths are exercised.
    """
    import cv2
    H, W = hw
    base = os.path.join(root, f"VOC{year}")
    os.makedirs(os.path.join(base, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(base, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
    rng = np.random.RandomState(seed)
    for si, split in enumerate(splits):
        ids = []
        for i in range(num_samples):
            iid = f"{split}_{i:04d}"
            ids.append(iid)
            img, label, _, _ = make_example(rng, hw, rng.randint(1, max_objects + 1))
            cv2.imwrite(os.path.join(base, "JPEGImages", iid + ".jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
            objs = []
            for row in label:
                cid = int(row[0])
                difficult = int(rng.rand() < difficult_frac)
                objs.append(
                    "<object><name>{}</name><difficult>{}</difficult>"
                    "<bndbox><xmin>{}</xmin><ymin>{}</ymin>"
                    "<xmax>{}</xmax><ymax>{}</ymax></bndbox></object>".format(
                        DET_CLASSES[cid], difficult,
                        int(row[1] * W), int(row[2] * H),
                        int(row[3] * W), int(row[4] * H)))
            with open(os.path.join(base, "Annotations", iid + ".xml"), "w") as f:
                f.write("<annotation><size><width>{}</width><height>{}"
                        "</height><depth>3</depth></size>{}</annotation>"
                        .format(W, H, "".join(objs)))
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root
