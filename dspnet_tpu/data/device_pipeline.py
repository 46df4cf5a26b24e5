"""On-device augmentation pipeline — the device-side input path.

The reference burns host CPU on per-image cv2.warpAffine (reference
dataset/iterator.py:476-548) and ships float CHW batches to the device. This
pipeline inverts that split:

* host threads only DECODE (JPEG/PNG -> raw uint8, file- or .drec-span-backed);
* raw uint8 batches transfer to the device — 4x less H2D traffic than f32
  (host-to-device transfer is the usual bottleneck);
* ONE jitted program does the whole augmentation batched on device: affine
  warp (bilinear, border 128) + horizontal flip + BGR->RGB mean-sub for the
  image, nearest warp (border 255) + flip + 1/4 nearest downsample + LUT for
  the seg mask, and the exact box-corner transform / distance rescale /
  area + out-of-image filters / top-compaction of iterator.py:485-539 as
  fixed-shape masked ops.

Semantics match :mod:`dspnet_tpu.data.augment` (same seed-233 parameter
table, same matrix math); pixels differ from cv2 only by its fixed-point
interpolation rounding. Use when host CPU, not the device, limits step time.
"""

from __future__ import annotations

import queue
import threading
from functools import partial
from typing import Iterator, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from dspnet_tpu.data import augment as aug
from dspnet_tpu.data.cs_labels import seg_label_lut
from dspnet_tpu.data.iterator import (
    LABEL_WIDTH,
    MAX_OBJECTS,
    SampleIndex,
    load_sample_arrays,
    shard_positions,
)


def _filter_and_compact_jax(label, data_shape, out_of_image: bool):
    """Vectorized iterator.py:522-539: clear degenerate rows, survivors to top."""
    H, W = data_shape
    xmin, ymin, xmax, ymax = label[:, 1], label[:, 2], label[:, 3], label[:, 4]
    area = (xmax - xmin) * W * (ymax - ymin) * H
    bad = (label[:, 0] < 0) | (area < 100.0)
    if out_of_image:
        bad |= (xmax < 0.01) | (xmin > 0.99) | (ymax < 0.01) | (ymin > 0.99)
    label = jnp.where(bad[:, None], -1.0, label)
    order = jnp.argsort(bad, stable=True)  # valid rows first, original order kept
    return label[order]


def _augment_boxes_jax(label, params, data_shape):
    """iterator.py:485-539 / augment.augment_example box path, one sample."""
    H, W = data_shape
    flip, theta, sx, sy, tx, ty = (params[i] for i in range(6))
    valid = label[:, 0] >= 0
    pts = label[:, 1:5] * jnp.array([W, H, W, H], jnp.float32)
    ca, sa = jnp.cos(theta), jnp.sin(theta)

    def tf(x, y):
        return sx * ca * x - sy * sa * y + tx, sx * sa * x + sy * ca * y + ty

    x1, y1 = tf(pts[:, 0], pts[:, 1])
    x2, y2 = tf(pts[:, 2], pts[:, 3])
    do_flip = flip > 0.5
    x1f = jnp.where(do_flip, W - x1, x1)
    x2f = jnp.where(do_flip, W - x2, x2)
    # flip mirrors corners, then xmin/xmax swap (augment.py:102-108)
    nx1 = jnp.where(do_flip, x2f, x1f)
    nx2 = jnp.where(do_flip, x1f, x2f)
    box = jnp.stack([nx1 / W, y1 / H, nx2 / W, y2 / H], axis=1)
    box = jnp.clip(box, 0.0, 1.0)
    dist = label[:, 5] / jnp.sqrt(sx * sy)
    new = jnp.concatenate([label[:, :1], box, dist[:, None]], axis=1)
    label = jnp.where(valid[:, None], new, label)
    return _filter_and_compact_jax(label, data_shape, out_of_image=True)


@partial(jax.jit,
         static_argnames=("data_shape", "enable_aug", "apply_lut", "s2d"))
def device_augment_batch(
    raw_images,  # (B, hh, ww, 3) uint8 BGR
    raw_segs,  # (B, hh, ww) uint8 or None
    labels,  # (B, 200, 6) f32
    params,  # (B, 6) f32 [flip, theta, sx, sy, tx, ty]
    lut,  # (256,) int32
    data_shape: Tuple[int, int],
    enable_aug: bool = True,
    apply_lut: bool = True,
    mean_pixels: Tuple[float, float, float] = aug.MEAN_PIXELS,
    s2d: bool = False,
):
    """``s2d``: emit images as their space-to-depth transform (the resnet
    stem's pre_s2d contract). On this loader the transpose runs on-device
    (part of this jitted program), so unlike the host loaders it does not
    remove the relayout cost — it only keeps the batch contract uniform."""
    H, W = data_shape
    B, hh, ww = raw_images.shape[:3]
    if not enable_aug:
        params = jnp.tile(
            jnp.array([0.0, 0.0, 1.0, 1.0, 0.0, 0.0], jnp.float32), (B, 1))
    flip, theta = params[:, 0], params[:, 1]
    sx, sy, tx, ty = params[:, 2], params[:, 3], params[:, 4], params[:, 5]
    sx2, sy2 = sx * (W / float(ww)), sy * (H / float(hh))
    ca, sa = jnp.cos(theta), jnp.sin(theta)
    M = jnp.stack([
        jnp.stack([sx2 * ca, -sy2 * sa, tx], axis=-1),
        jnp.stack([sx2 * sa, sy2 * ca, ty], axis=-1),
    ], axis=1)  # (B, 2, 3)

    border = 128.0 if enable_aug else 0.0
    img = aug.warp_affine_batch_jax(raw_images, M, (H, W), border)
    do_flip = (flip > 0.5) & enable_aug
    img = jnp.where(do_flip[:, None, None, None], img[:, :, ::-1], img)
    img = img[..., ::-1] - jnp.asarray(mean_pixels, jnp.float32)  # BGR->RGB
    if s2d:
        from dspnet_tpu.models.layers import space_to_depth

        img = space_to_depth(img)

    out = {"images": img}
    if raw_segs is not None:
        seg_border = 255.0 if enable_aug else 0.0
        seg = aug.warp_affine_batch_jax(raw_segs, M, (H, W), seg_border, nearest=True)
        seg = jnp.where(do_flip[:, None, None], seg[:, :, ::-1], seg)
        seg = seg[:, ::4, ::4].astype(jnp.int32)  # nearest 1/4 (src = dst*4)
        if apply_lut:
            seg = lut[jnp.clip(seg, 0, 255)]
        out["seg_label"] = seg

    if enable_aug:
        lbl = jax.vmap(lambda l, p: _augment_boxes_jax(l, p, (H, W)))(labels, params)
    else:
        lbl = jax.vmap(
            lambda l: _filter_and_compact_jax(l, (H, W), out_of_image=False)
        )(labels)
    out["label_det"] = lbl
    return out


class DeviceAugIterator:
    """MultiTaskIterator-compatible batches, augmentation on the device.

    Host worker threads decode raw images/segs; the main thread runs the
    jitted :func:`device_augment_batch`. All images must share one raw
    resolution (Cityscapes: 1024x2048) — asserted at first decode.
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
        num_threads: int = 4,
        queue_cap: int = 3,
        predownscale: bool = False,
        pad_last: bool = False,
        s2d: bool = False,
    ):
        """``predownscale``: host-resize each raw image straight to
        ``data_shape`` (AREA for pixels, NEAREST for seg masks) before the
        H2D transfer. The device warp then resamples from train-res instead
        of raw-res pixels — bytes on the wire drop by raw_area/train_area
        (4x less than even the f32 host loaders at Cityscapes 1024x2048 ->
        512x1024), and mixed raw resolutions become batchable. Box labels
        are normalized and the warp matrix rescales by the raw size, so the
        geometry is unchanged; pixel values differ slightly from the
        one-step warp (two resampling passes)."""
        self.index = index
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.predownscale = predownscale
        self.pad_last = pad_last
        self.s2d = bool(s2d)
        self.mean_pixels = tuple(float(m) for m in mean_pixels)
        self.enable_aug = enable_aug
        self.apply_seg_lut = apply_seg_lut
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        # numpy by convention (a device array closed over a jitted fn is
        # fetched to the host while lowering); it is a traced ARGUMENT of the jitted
        # device_augment_batch, so it rides along with the batch H2D (1 KB)
        self.lut = seg_label_lut().astype(np.int32)
        self.num_samples = len(index)
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples)
        if shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0
        self.num_threads = num_threads
        self.queue_cap = queue_cap
        self.raw_hw: Optional[Tuple[int, int]] = None
        self._hw_lock = threading.Lock()

    def _resample_aug(self):
        self.aug_params = aug.sample_aug_params(
            self.num_samples, self.data_shape, self.rng)

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    # ------------------------------------------------------------- host side

    def _load_raw(self, pos: int):
        sample = self.index[int(self.order[pos])]
        img, seg = load_sample_arrays(sample)
        if self.predownscale:
            import cv2

            H, W = self.data_shape
            if img.shape[:2] != (H, W):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)
            if seg is not None and seg.shape[:2] != (H, W):
                seg = cv2.resize(seg, (W, H), interpolation=cv2.INTER_NEAREST)
        with self._hw_lock:
            if self.raw_hw is None:
                self.raw_hw = img.shape[:2]
        assert img.shape[:2] == self.raw_hw, (
            f"mixed raw resolutions {img.shape[:2]} vs {self.raw_hw}; "
            "on-device augmentation batches raw images — resize offline, "
            "use predownscale=True, or use MultiTaskIterator")
        return img, sample.label, seg, sample.image_path

    def _raw_batches(self) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor

        bs = self.batch_size
        n = len(self.positions)
        starts = list(range(0, n - bs + 1, bs))
        if self.pad_last and n % bs:
            starts.append((n // bs) * bs)  # padded tail
        with ThreadPoolExecutor(self.num_threads) as pool:
            for start in starts:
                poss = self.positions[start:start + bs]
                decoded = list(pool.map(lambda p: self._load_raw(int(p)), poss))
                n_real = len(decoded)
                # pad the tail by repeating the last decoded sample: the
                # MultiTaskIterator.pad_last contract exposes only the real
                # rows via fnames, so padded content is sliced off by
                # consumers and its value is irrelevant (repetition keeps
                # raw-resolution/shape invariants without a zero-image path)
                decoded.extend([decoded[-1]] * (bs - n_real))
                pad_params = np.concatenate(
                    [self.aug_params[poss],
                     np.repeat(self.aug_params[poss[-1:]],
                               bs - n_real, axis=0)]
                ) if bs - n_real else self.aug_params[poss]
                segs = [d[2] for d in decoded]
                # MultiTaskIterator contract: emit seg_label when ANY sample
                # in the batch has a mask, zero-filling the rest (a batch-
                # dependent key set would also retrigger jit compiles)
                seg_arr = None
                if any(s is not None for s in segs):
                    hw = next(s.shape for s in segs if s is not None)
                    # maskless samples fill with 255 (ignore), not 0 (road)
                    seg_arr = np.stack([
                        s if s is not None else np.full(hw, 255, np.uint8)
                        for s in segs
                    ]).astype(np.uint8)
                yield {
                    "raw": np.stack([d[0] for d in decoded]),
                    "segs": seg_arr,
                    "labels": np.stack([d[1] for d in decoded]).astype(np.float32),
                    "params": pad_params.astype(np.float32),
                    "names": [d[3] for d in decoded[:n_real]],
                }

    # ----------------------------------------------------------- device side

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs; decode prefetched on a background thread."""
        self.reset()
        q: queue.Queue = queue.Queue(maxsize=self.queue_cap)
        _END = object()
        stop = threading.Event()

        def offer(item) -> bool:
            # bounded put that gives up when the consumer abandoned the epoch
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for raw in self._raw_batches():
                    if not offer(raw):
                        return
                offer(_END)
            except BaseException as e:  # surface decode errors to the consumer
                offer(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch = device_augment_batch(
                    jnp.asarray(item["raw"]),
                    None if item["segs"] is None else jnp.asarray(item["segs"]),
                    jnp.asarray(item["labels"]),
                    jnp.asarray(item["params"]),
                    self.lut,
                    self.data_shape,
                    enable_aug=self.enable_aug,
                    apply_lut=self.apply_seg_lut,
                    mean_pixels=self.mean_pixels,
                    s2d=self.s2d,
                )
                yield batch, item["names"]
        finally:
            # abandoning the generator must not leave the producer blocked
            # on a full queue holding ~100s of MB of decoded batches
            stop.set()
            t.join(timeout=5.0)

    def __iter__(self):
        for batch, _ in self.epoch():
            yield batch
