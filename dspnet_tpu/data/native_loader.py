"""ctypes bindings for the native C++ data loader (native/dataloader.cpp).

Drop-in alternative to :class:`~dspnet_tpu.data.iterator.MultiTaskIterator`
backed by a multithreaded C++ pipeline (JPEG/PNG decode + affine warp + box
transform + mean-sub), the counterpart of the reference's
`preprocess_threads=48` C++ record iterator (config/config.py:56). The
shuffle order and augmentation parameter table stay on the Python side
(numpy seed 233) so batches match the pure-Python iterator.

The library is built from source on first use (``make -C native``; needs
g++, libjpeg and libpng) into ``native/`` of the checkout.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from dspnet_tpu.data import augment as aug
from dspnet_tpu.data.cs_labels import seg_label_lut
from dspnet_tpu.data.iterator import LABEL_WIDTH, MAX_OBJECTS, SampleIndex, shard_positions

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libdspnet_data.so")


def build_native() -> str:
    """Build (or bring up to date) the library with ``make -C native`` and
    return its path. An exclusive lock on the Makefile serialises
    concurrent builders (test workers, data-parallel processes). Raises
    RuntimeError with make's output when the build fails."""
    import fcntl
    import subprocess

    with open(os.path.join(_NATIVE_DIR, "Makefile")) as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                               text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run make: {e}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if r.returncode != 0:
        raise RuntimeError(f"make -C {_NATIVE_DIR} failed:\n{r.stdout}{r.stderr}")
    return _LIB_PATH


def _load_lib():
    lib = ctypes.CDLL(build_native())
    lib.dl_create.restype = ctypes.c_void_p
    lib.dl_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.dl_add_sample.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)
    ]
    lib.dl_add_sample2.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.dl_start_epoch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
    ]
    lib.dl_num_batches.argtypes = [ctypes.c_void_p]
    lib.dl_num_batches.restype = ctypes.c_int
    lib.dl_next_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dl_next_batch.restype = ctypes.c_int
    lib.dl_set_u8.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_set_pad_last.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_set_s2d.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_next_batch_u8.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.dl_next_batch_u8.restype = ctypes.c_int
    lib.dl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the library is built, or builds here."""
    try:
        build_native()
    except RuntimeError:
        return False
    return True


def _normalize_on_device(u8_batch: np.ndarray, mean_pixels) -> "jax.Array":
    """uint8 H2D + on-device f32 mean-sub (the 4x-less-bytes transfer)."""
    import jax
    import jax.numpy as jnp

    global _normalize_jit
    if "_normalize_jit" not in globals():
        _normalize_jit = jax.jit(
            lambda x, m: x.astype(jnp.float32) - m)
    return _normalize_jit(
        jnp.asarray(u8_batch), jnp.asarray(mean_pixels, jnp.float32))


class NativeMultiTaskIterator:
    """Same batch contract as MultiTaskIterator, C++ workers underneath."""

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        mean_pixels=aug.MEAN_PIXELS,
        enable_aug: bool = True,
        seed: int = 233,
        num_threads: int = 8,
        queue_cap: int = 4,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        device_normalize: bool = False,
        pad_last: bool = False,
        s2d: bool = False,
    ):
        """``device_normalize``: C++ workers emit the warped uint8 RGB batch
        and the f32 mean-sub runs as a tiny jitted op on device — 4x less
        host->device traffic, bit-identical images (uint8 -> f32 - mean is
        the exact same arithmetic the C++ does).

        ``pad_last``: also emit a final partial batch padded with empty
        rows (MultiTaskIterator.pad_last contract); ``epoch()``'s fnames
        then list only the real samples.

        ``s2d``: the C++ workers write each warped pixel straight into the
        2x2 space-to-depth arrangement ([B, H/2, W/2, 12], the resnet
        stem's pre_s2d input, models/layers.space_to_depth channel order) —
        free on the host (every pixel is written once either way) and it
        removes the input relayout copies from the device step entirely."""
        self.lib = _load_lib()
        self._index = index
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.enable_aug = enable_aug
        self.shuffle = shuffle
        self.device_normalize = device_normalize
        self.mean_pixels = tuple(float(m) for m in mean_pixels)
        self.rng = np.random.RandomState(seed)
        self.num_samples = len(index)
        H, W = self.data_shape
        mean = (ctypes.c_float * 3)(*[float(m) for m in mean_pixels])
        lut = seg_label_lut()
        lut_c = (ctypes.c_uint8 * 256)(*lut.tolist())
        self.handle = self.lib.dl_create(
            H, W, batch_size, num_threads, queue_cap, mean, int(enable_aug), lut_c
        )
        if device_normalize:
            self.lib.dl_set_u8(self.handle, 1)
        self.s2d = bool(s2d)
        if s2d:
            assert H % 2 == 0 and W % 2 == 0, "s2d needs even data_shape"
            self.lib.dl_set_s2d(self.handle, 1)
        self.pad_last = pad_last
        if pad_last:
            self.lib.dl_set_pad_last(self.handle, 1)
        for s in index.samples:
            lbl = np.ascontiguousarray(s.label, np.float32)
            lbl_p = lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if s.image_span is not None or s.seg_span is not None:
                # record-backed (.drec): the C++ workers fseek into the store
                ipath, ioff, ilen = s.image_span or (s.image_path, 0, 0)
                spath, soff, slen = s.seg_span or (s.seg_path, 0, 0)
                self.lib.dl_add_sample2(
                    self.handle,
                    ipath.encode(), ioff, ilen,
                    spath.encode() if spath else None, soff, slen,
                    lbl_p,
                )
            else:
                self.lib.dl_add_sample(
                    self.handle,
                    s.image_path.encode(),
                    s.seg_path.encode() if s.seg_path else None,
                    lbl_p,
                )
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples, dtype=np.int32)
        if shuffle:
            self.rng.shuffle(self.order)
        self._start_epoch()

    def _start_epoch(self):
        self.aug_params = aug.sample_aug_params(self.num_samples, self.data_shape, self.rng)
        order = np.ascontiguousarray(self.order[self.positions], np.int32)
        augp = np.ascontiguousarray(self.aug_params[self.positions], np.float64)
        self.lib.dl_start_epoch(
            self.handle,
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            augp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(self.positions),
        )
        self.num_batches = self.lib.dl_num_batches(self.handle)
        self._consumed = 0

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._start_epoch()

    def next_batch(self):
        H, W = self.data_shape
        B = self.batch_size
        img_shape = ((B, H // 2, W // 2, 12) if self.s2d else (B, H, W, 3))
        mean = (tuple(self.mean_pixels) * 4) if self.s2d else self.mean_pixels
        labels = np.empty((B, MAX_OBJECTS, LABEL_WIDTH), np.float32)
        segs = np.empty((B, H // 4, W // 4), np.int32)
        if self.device_normalize:
            u8 = np.empty(img_shape, np.uint8)
            n = self.lib.dl_next_batch_u8(
                self.handle,
                u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            assert n == B or (self.pad_last and 0 < n <= B), n
            images = _normalize_on_device(u8, mean)
        else:
            images = np.empty(img_shape, np.float32)
            n = self.lib.dl_next_batch(
                self.handle,
                images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            assert n == B or (self.pad_last and 0 < n <= B), n
        self._consumed += 1
        self._last_count = n  # real samples in this batch (pad_last tail)
        return {"images": images, "label_det": labels, "seg_label": segs}

    def __iter__(self):
        for batch, _ in self.epoch():
            yield batch

    def epoch(self):
        """(batch, fnames) pairs — MultiTaskIterator.epoch contract. Batch i
        maps to positions i*B:(i+1)*B of the order passed to dl_start_epoch
        (the C++ side emits batches in deterministic order, worker_main's
        next_emit sequencing)."""
        if self._consumed:
            self.reset()
        order = self.order[self.positions]
        B = self.batch_size
        while self._consumed < self.num_batches:
            i = self._consumed
            batch = self.next_batch()
            names = [self._index[int(j)].image_path
                     for j in order[i * B:i * B + self._last_count]]
            yield batch, names

    def close(self):
        if self.handle:
            self.lib.dl_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
