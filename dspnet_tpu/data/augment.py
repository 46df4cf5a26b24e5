"""Deterministic multitask augmentation.

Exact behavioral port of the reference iterator's augmentation
(dataset/iterator.py:417-424 parameter sampling, :476-548 warp/box logic,
:439-474 no-aug resize), so labels/batches are comparable:

* per-epoch parameter table drawn once with numpy (seed 233 at startup,
  iterator.py:381): flip p=.5, rotation +-5 deg, x-scale U(0.5, 2), y-scale =
  x-scale * U(0.8, 1.2), translation keeping the scaled image covering the
  canvas;
* ONE affine warp for the RGB image (bilinear, border 128) and the seg mask
  (nearest, border 255);
* box corners through the same affine (normalized-coordinate variant), flip
  handled as a post-transform mirror; per-box distance scaled by
  1/sqrt(sx*sy) (iterator.py:519);
* filters: area < 100 px, or fully out of image (xmax<.01 / xmin>.99 /
  ymax<.01 / ymin>.99) -> row cleared to -1 and survivors compacted to the
  top (iterator.py:522-539).

Documented deviation: when EXACTLY ONE box survives filtering, the
reference's `np.squeeze(...)` collapses the (1, 6) row to shape (6,) and the
following assignment broadcasts it into six duplicate label rows
(iterator.py:535-539). We keep the compaction 2-D and emit the single row
once — the duplicates are a reference bug (they would sextuple that box's
weight in target matching), not a behavior to replicate.

Host path uses cv2.warpAffine like the reference. A batched JAX version of
the same warp (for on-device augmentation overlapped with the train step)
lives in :func:`warp_affine_batch_jax`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

MEAN_PIXELS = (123.68, 116.779, 103.939)  # RGB (iterator.py:340)


def sample_aug_params(num_samples: int, data_shape: Tuple[int, int], rng: np.random.RandomState) -> np.ndarray:
    """(N, 6) rows [flip, theta, sx, sy, tx, ty] — iterator.py:417-424."""
    H, W = data_shape
    p = np.zeros((num_samples, 6))
    p[:, 0] = rng.rand(num_samples) > 0.5
    p[:, 1] = np.radians(-5 + rng.rand(num_samples) * 10)
    p[:, 2] = 0.5 + rng.rand(num_samples) * 1.5
    p[:, 3] = p[:, 2] * (0.8 + rng.rand(num_samples) * 0.4)
    p[:, 4] = -(rng.rand(num_samples)) * W * (p[:, 2] - 1.0)
    p[:, 5] = -(rng.rand(num_samples)) * H * (p[:, 3] - 1.0)
    return p


def _filter_and_compact(label: np.ndarray, data_shape: Tuple[int, int], out_of_image: bool) -> np.ndarray:
    """Clear degenerate rows to -1 and move survivors to the top."""
    H, W = data_shape
    xmin, ymin, xmax, ymax = label[:, 1], label[:, 2], label[:, 3], label[:, 4]
    areas = (xmax - xmin) * W * (ymax - ymin) * H
    label[np.where(areas < 100)] = -1
    if out_of_image:
        label[np.where(xmax < 0.01)] = -1
        label[np.where(xmin > 0.99)] = -1
        label[np.where(ymax < 0.01)] = -1
        label[np.where(ymin > 0.99)] = -1
    keep = np.where(label[:, 3] > -0.5)[0]
    top = label[keep].copy()
    label.fill(-1)
    label[: top.shape[0]] = top
    return label


def augment_example(
    img: np.ndarray,
    label: np.ndarray,
    seg: Optional[np.ndarray],
    params: np.ndarray,
    data_shape: Tuple[int, int],
):
    """Augment one example. img HxWx3 BGR (cv2 layout), label (L, 6)
    normalized rows [cls, xmin, ymin, xmax, ymax, dist], seg HxW uint8
    at the SAME resolution as img — one affine maps both, so a mismatched
    mask would be sampled in the wrong coordinate frame.

    Returns (img, label, seg) at ``data_shape`` resolution.
    """
    import cv2
    H, W = data_shape
    hh, ww = img.shape[:2]
    if seg is not None:
        assert seg.shape[:2] == (hh, ww), (
            f"seg mask {seg.shape[:2]} != image {(hh, ww)} — prepare the "
            "dataset with matching resolutions (prepare_cityscapes --scale)")
    label = label.copy()
    flip, theta, sx, sy, tx, ty = tuple(params)
    sx2, sy2 = sx * (W / float(ww)), sy * (H / float(hh))
    M_img = np.array(
        [[sx2 * math.cos(theta), -sy2 * math.sin(theta), tx],
         [sx2 * math.sin(theta), sy2 * math.cos(theta), ty]]
    )
    img = cv2.warpAffine(img, M_img, (W, H), flags=cv2.INTER_LINEAR, borderValue=(128, 128, 128))
    if seg is not None:
        seg = cv2.warpAffine(seg, M_img, (W, H), flags=cv2.INTER_NEAREST, borderValue=(255, 255, 255))

    valid = np.where(label[:, 0] >= 0)[0]
    if valid.shape[0] >= 1:
        pts = label[valid, 1:5] * np.array([W, H, W, H])
        dist = label[valid, 5].copy()
        corners = np.vstack([pts[:, :2], pts[:, 2:]])  # (2n, 2)
        M_box = np.array(
            [[sx * math.cos(theta), -sy * math.sin(theta), tx],
             [sx * math.sin(theta), sy * math.cos(theta), ty]]
        )
        corners = corners @ M_box[:, :2].T + M_box[:, 2]
        if flip > 0.5:
            corners[:, 0] = W - corners[:, 0]
        corners /= np.array([W, H])
        n = valid.shape[0]
        pts_new = np.hstack([corners[:n], corners[n:]])
        if flip > 0.5:
            pts_new[:, [0, 2]] = pts_new[:, [2, 0]]
        pts_new[:, :4] = np.clip(pts_new[:, :4], 0, 1)
        label[valid, 1:5] = pts_new
        label[valid, 5] = dist / math.sqrt(sx * sy)
        label = _filter_and_compact(label, data_shape, out_of_image=True)

    if flip > 0.5:
        img = cv2.flip(img, 1)
        if seg is not None:
            seg = cv2.flip(seg, 1)
    return img, label, seg


def resize_example(
    img: np.ndarray,
    label: np.ndarray,
    seg: Optional[np.ndarray],
    data_shape: Tuple[int, int],
):
    """No-aug eval path (iterator.py:439-474): plain resize, small-box filter."""
    import cv2
    H, W = data_shape
    hh, ww = img.shape[:2]
    if seg is not None:
        assert seg.shape[:2] == (hh, ww), (
            f"seg mask {seg.shape[:2]} != image {(hh, ww)} — prepare the "
            "dataset with matching resolutions (prepare_cityscapes --scale)")
    label = label.copy()
    M = np.array([[W / float(ww), 0.0, 0.0], [0.0, H / float(hh), 0.0]])
    img = cv2.warpAffine(img, M, (W, H), flags=cv2.INTER_LINEAR)
    if seg is not None:
        seg = cv2.warpAffine(seg, M, (W, H), flags=cv2.INTER_NEAREST, borderValue=(0, 0, 0))
    if np.any(label[:, 0] >= 0):
        label = _filter_and_compact(label, data_shape, out_of_image=False)
    return img, label, seg


def color_jitter(img_bgr: np.ndarray, jitter, rng: np.random.RandomState) -> np.ndarray:
    """Random hue / saturation / illumination / contrast jitter.

    Capability parity with the reference's plain-SSD record path: the
    cfg.train.color_jitter probabilities/magnitudes
    (reference config/config.py:22-29 defaults, :50-51 training preset —
    each op p=0.5, hue ±18, saturation ±32, illumination ±32, contrast
    ±0.5) are forwarded as kwargs into the C++ ``mx.io.ImageDetRecordIter``
    (reference dataset/iterator.py:52-64). The C++ op semantics follow the
    standard HSV-space definitions that augmenter implements: hue adds a
    delta to the H channel mod 180, saturation adds a clamped delta to S,
    illumination adds a clamped delta to every BGR channel, contrast scales
    about the grayscale mean (``img*alpha + (1-alpha)*mean(gray)``). Ops are
    applied in the ColorJitter namedtuple's field order; each is gated by
    its own probability, so the order is not an observable contract.

    ``img_bgr`` must be uint8 HxWx3; draws come from ``rng`` so the
    pipeline stays deterministic under the canonical seed 233.
    """
    import cv2
    out = img_bgr
    p = jitter.get("random_hue_prob", 0.0)
    if p > 0 and rng.rand() < p:
        delta = rng.uniform(-jitter["max_random_hue"], jitter["max_random_hue"])
        hsv = cv2.cvtColor(out, cv2.COLOR_BGR2HSV).astype(np.int32)
        hsv[..., 0] = (hsv[..., 0] + int(round(delta))) % 180
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
    p = jitter.get("random_saturation_prob", 0.0)
    if p > 0 and rng.rand() < p:
        delta = rng.uniform(-jitter["max_random_saturation"],
                            jitter["max_random_saturation"])
        hsv = cv2.cvtColor(out, cv2.COLOR_BGR2HSV).astype(np.float32)
        hsv[..., 1] = np.clip(hsv[..., 1] + delta, 0, 255)
        out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
    p = jitter.get("random_illumination_prob", 0.0)
    if p > 0 and rng.rand() < p:
        delta = rng.uniform(-jitter["max_random_illumination"],
                            jitter["max_random_illumination"])
        out = np.clip(out.astype(np.float32) + delta, 0, 255).astype(np.uint8)
    p = jitter.get("random_contrast_prob", 0.0)
    if p > 0 and rng.rand() < p:
        alpha = 1.0 + rng.uniform(-jitter["max_random_contrast"],
                                  jitter["max_random_contrast"])
        gray_mean = float(cv2.cvtColor(out, cv2.COLOR_BGR2GRAY).mean())
        out = np.clip(out.astype(np.float32) * alpha
                      + (1.0 - alpha) * gray_mean, 0, 255).astype(np.uint8)
    return out


def normalize_image(img_bgr: np.ndarray, mean_pixels=MEAN_PIXELS) -> np.ndarray:
    """BGR uint8 HxWx3 -> float32 RGB NHWC-ready, mean-subtracted
    (iterator.py:570-571, kept in HWC instead of CHW — the models are NHWC)."""
    rgb = img_bgr[:, :, ::-1].astype(np.float32)
    return rgb - np.asarray(mean_pixels, np.float32)


def downsample_seg(seg: np.ndarray, lut: Optional[np.ndarray] = None) -> np.ndarray:
    """1/4-res nearest downsample + LUT (iterator.py:573-576)."""
    import cv2
    hh, ww = seg.shape
    out = cv2.resize(seg, (ww // 4, hh // 4), interpolation=cv2.INTER_NEAREST)
    if lut is not None:
        out = cv2.LUT(out, lut)
    return out.astype(np.int32)


# --------------------------------------------------------------- JAX path


def warp_affine_batch_jax(images, matrices, out_hw, border_value, nearest=False):
    """Batched inverse-mapped affine warp on device (NHWC or NHW).

    Same sampling semantics as cv2.warpAffine (dst(x) = src(M^-1 x), bilinear
    or nearest, constant border). Used to fuse augmentation into the input
    pipeline on the device instead of burning host CPU on cv2.
    """
    import jax
    import jax.numpy as jnp

    H, W = out_hw
    squeeze = images.ndim == 3
    if squeeze:
        images = images[..., None]
    B, sh, sw, C = images.shape

    # invert 2x3 affines
    a, b_, c = matrices[:, 0, 0], matrices[:, 0, 1], matrices[:, 0, 2]
    d, e, f = matrices[:, 1, 0], matrices[:, 1, 1], matrices[:, 1, 2]
    det = a * e - b_ * d
    ia, ib = e / det, -b_ / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)

    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32), jnp.arange(W, dtype=jnp.float32), indexing="ij")

    def warp_one(img, coefs):
        ia, ib, ic, id_, ie, if_ = coefs
        sx = ia * xs + ib * ys + ic
        sy = id_ * xs + ie * ys + if_
        if nearest:
            xi = jnp.round(sx).astype(jnp.int32)
            yi = jnp.round(sy).astype(jnp.int32)
            inside = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
            xi = jnp.clip(xi, 0, sw - 1)
            yi = jnp.clip(yi, 0, sh - 1)
            vals = img[yi, xi]
            return jnp.where(inside[..., None], vals, border_value)
        x0 = jnp.floor(sx)
        y0 = jnp.floor(sy)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)

        def fetch(yi, xi):
            inside = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
            v = img[jnp.clip(yi, 0, sh - 1), jnp.clip(xi, 0, sw - 1)]
            return jnp.where(inside[..., None], v, border_value)

        v00 = fetch(y0i, x0i)
        v01 = fetch(y0i, x0i + 1)
        v10 = fetch(y0i + 1, x0i)
        v11 = fetch(y0i + 1, x0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy

    coefs = jnp.stack([ia, ib, ic, id_, ie, if_], axis=-1)
    out = jax.vmap(lambda im, cf: warp_one(im, tuple(cf[i] for i in range(6))))(
        images.astype(jnp.float32), coefs
    )
    return out[..., 0] if squeeze else out
