"""Multitask batch iterator — replacement for MultiTaskRecordIter.

The reference iterates an MXNet .rec file + .lst sidecar
(dataset/iterator.py:301-603); record files are an MXNet artifact, so this
rebuild's storage contract is a plain **sample index**: a list of
(image_path, label_matrix, seg_path) triples (see :class:`SampleIndex`),
which the imdb family (`dspnet_tpu.data.imdb`) produces from VOC / Cityscapes
/ COCO / YOLO sources. Batch semantics are preserved:

* epoch-level deterministic shuffling + one augmentation-parameter row per
  sample, numpy seed 233 (iterator.py:379-384, 417-424);
* per batch: BGR decode -> augment/resize -> mean-sub RGB float (NHWC here,
  the reference emits CHW), det label (B, 200, 6), seg label at 1/4
  resolution with the (near-no-op) id LUT applied (iterator.py:550-603);
* ``next()`` yields (batch dict, filenames) like the reference's
  (DataBatch, fnames) pair.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dspnet_tpu.data import augment as aug
from dspnet_tpu.data.cs_labels import seg_label_lut

MAX_OBJECTS = 200
LABEL_WIDTH = 6


@dataclasses.dataclass
class Sample:
    image_path: str
    label: np.ndarray  # (MAX_OBJECTS, 6) normalized [cls,x1,y1,x2,y2,dist], -1 padded
    seg_path: Optional[str] = None
    # Record-backed storage (dspnet_tpu.data.record, the .rec/.idx equivalent):
    # when set, encoded bytes are read from (store_path, offset, length) instead
    # of image_path/seg_path, which then only carry the display/original names.
    image_span: Optional[Tuple[str, int, int]] = None
    seg_span: Optional[Tuple[str, int, int]] = None


def read_span(span: Tuple[str, int, int]) -> np.ndarray:
    """Read `length` bytes at `offset` of a record store as a uint8 array."""
    path, offset, length = span
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(length)
    return np.frombuffer(buf, np.uint8)


def shard_positions(num_samples: int, shard: Tuple[int, int]) -> np.ndarray:
    """Epoch positions owned by host ``rank`` of ``world``.

    Every host draws the same global shuffle/aug tables and walks its
    ``rank::world`` slice, truncated to ``num_samples // world`` so ALL hosts
    run the same batch count (unequal counts would deadlock the pod when one
    host enters a collective for a step the others never run)."""
    rank, world = shard
    assert 0 <= rank < world, f"bad shard {shard}"
    return np.arange(num_samples)[rank::world][: num_samples // world]


def load_sample_arrays(sample: Sample, with_seg: bool = True):
    """Decode a sample's image (BGR) and optional seg mask, path- or
    span-backed. ``with_seg=False`` skips the mask decode entirely (the
    det-only iterator never uses it)."""
    import cv2
    if sample.image_span is not None:
        img = cv2.imdecode(read_span(sample.image_span), cv2.IMREAD_COLOR)
        assert img is not None, sample.image_span
    else:
        img = cv2.imread(sample.image_path, cv2.IMREAD_COLOR)
        assert img is not None, sample.image_path
    seg = None
    if not with_seg:
        return img, seg
    if sample.seg_span is not None:
        seg = cv2.imdecode(read_span(sample.seg_span), cv2.IMREAD_UNCHANGED)
        assert seg is not None, sample.seg_span
    elif sample.seg_path is not None:
        seg = cv2.imread(sample.seg_path, cv2.IMREAD_UNCHANGED)
        assert seg is not None, sample.seg_path
    return img, seg


class SampleIndex:
    """An ordered list of samples; the storage-neutral '.lst' equivalent."""

    def __init__(self, samples: Sequence[Sample]):
        self.samples = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> Sample:
        return self.samples[i]

    @staticmethod
    def pad_label(rows: np.ndarray) -> np.ndarray:
        out = np.full((MAX_OBJECTS, LABEL_WIDTH), -1.0, np.float32)
        n = min(len(rows), MAX_OBJECTS)
        if n:
            out[:n] = rows[:n]
        return out


class MultiTaskIterator:
    """Batches of {'images', 'label_det', 'seg_label'} (+ filenames).

    Args mirror the reference iterator: data_shape (H, W), mean_pixels RGB,
    enable_aug selects the augmented vs plain-resize path, seed 233 default.

    ``shard=(rank, world)`` gives multi-host data parallelism: every host
    draws the SAME global shuffle + augmentation tables (seed 233), then
    walks the disjoint slice ``rank::world`` of the epoch, so the union of
    all hosts' batches reproduces the single-host epoch sample-for-sample
    (each sample keeps its globally-assigned aug row). The reference has no
    multi-host story (SURVEY.md §2.7); this is the input-pipeline half of
    pod-scale DP over DCN.
    """

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        mean_pixels=aug.MEAN_PIXELS,
        enable_aug: bool = True,
        seed: int = 233,
        apply_seg_lut: bool = True,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        pad_last: bool = False,
        s2d: bool = False,
    ):
        """``pad_last``: also yield a final partial batch, padded to
        ``batch_size`` with empty rows (zero images, all -1 det labels,
        all-ignore seg) and ``fnames`` listing only the REAL samples —
        consumers slice outputs by ``len(fnames)``. Without it, a val set
        smaller than (or not divisible by) the batch silently drops its
        tail; eval paths must pass True. Train keeps False: a padded train
        batch would feed empty rows to the loss.

        ``s2d``: emit images as their 2x2 space-to-depth transform
        ([B, H/2, W/2, 12], models/layers.space_to_depth channel order) —
        the resnet stem's pre_s2d input contract, which removes the input
        relayout copies from the device step (docs/ROOFLINE.md r5)."""
        self.index = index
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.mean_pixels = mean_pixels
        self.enable_aug = enable_aug
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.lut = seg_label_lut() if apply_seg_lut else None
        self.num_samples = len(index)
        self.shard = tuple(shard)
        self.pad_last = pad_last
        self.s2d = bool(s2d)
        if s2d:
            H, W = self.data_shape
            assert H % 2 == 0 and W % 2 == 0, "s2d needs even data_shape"
        # epoch positions this host owns (indices into order/aug tables)
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples)
        if shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    def _resample_aug(self):
        self.aug_params = aug.sample_aug_params(self.num_samples, self.data_shape, self.rng)

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    def __iter__(self) -> Iterator:
        for batch, _ in self.epoch():
            yield batch

    def epoch(self) -> Iterator:
        """Like __iter__ but yields (batch, fnames) pairs (reference next())."""
        self.reset()
        while self.cursor + self.batch_size <= len(self.positions):
            yield self.next_batch()
        if self.pad_last and self.cursor < len(self.positions):
            yield self.next_batch()

    def _load(self, sample: Sample):
        img, seg = load_sample_arrays(sample)
        return img, sample.label.copy(), seg

    def next_batch(self):
        H, W = self.data_shape
        bs = self.batch_size
        images = np.zeros((bs, H, W, 3), np.float32)
        labels = np.full((bs, MAX_OBJECTS, LABEL_WIDTH), -1.0, np.float32)
        # samples without a mask must contribute NO seg loss: fill with the
        # ignore label, not 0 ('road') — a zero fill silently trains the seg
        # head toward road for every maskless image in a mixed batch
        segs = np.full((bs, H // 4, W // 4), 255, np.int32)
        has_seg = False
        fnames: List[str] = []
        n_real = min(bs, len(self.positions) - self.cursor)
        for b in range(n_real):
            pos = int(self.positions[self.cursor])
            sample = self.index[int(self.order[pos])]
            img, label, seg = self._load(sample)
            if self.enable_aug:
                img, label, seg = aug.augment_example(
                    img, label, seg, self.aug_params[pos], self.data_shape
                )
            else:
                img, label, seg = aug.resize_example(img, label, seg, self.data_shape)
            images[b] = aug.normalize_image(img, self.mean_pixels)
            labels[b] = label
            if seg is not None:
                has_seg = True
                segs[b] = aug.downsample_seg(seg.astype(np.uint8), self.lut)
            fnames.append(sample.image_path)
            self.cursor += 1
        if self.s2d:
            from dspnet_tpu.models.layers import space_to_depth

            images = space_to_depth(images)  # numpy in, numpy out
        batch = {"images": images, "label_det": labels}
        if has_seg:
            batch["seg_label"] = segs
        return batch, fnames
