"""Native C++ loader parity vs the pure-Python iterator."""

import numpy as np
import pytest

from dspnet_tpu.data import synthetic
from dspnet_tpu.data.iterator import MultiTaskIterator
from dspnet_tpu.data.native_loader import NativeMultiTaskIterator


@pytest.fixture(scope="module", autouse=True)
def _built(native_lib):
    """Every test here needs the library (built from source on first use)."""


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native_synth"))
    return synthetic.build_dataset(root, num_samples=6, hw=(64, 128))


@pytest.mark.parametrize("enable_aug", [False, True])
def test_native_matches_python(dataset, enable_aug):
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=enable_aug, shuffle=True)
    py_it = MultiTaskIterator(dataset, **kw)
    nat_it = NativeMultiTaskIterator(dataset, num_threads=3, **kw)
    for _ in range(3):
        pb, _ = py_it.next_batch()
        nb = nat_it.next_batch()
        # labels must match exactly (same rng tables, same float math)
        np.testing.assert_allclose(nb["label_det"], pb["label_det"], atol=2e-5)
        # images: libjpeg vs cv2 decode + warp rounding can differ by a few
        # LSBs per pixel; demand close agreement
        diff = np.abs(nb["images"] - pb["images"])
        assert np.mean(diff) < 1.0, f"mean abs diff {np.mean(diff)}"
        assert np.percentile(diff, 99) <= 16.0
        # seg labels: nearest-neighbor — identical except warp-boundary pixels
        seg_mismatch = np.mean(nb["seg_label"] != pb["seg_label"])
        assert seg_mismatch < 0.02, f"seg mismatch rate {seg_mismatch}"
    nat_it.close()


def test_native_epoch_reset_deterministic(dataset):
    a = NativeMultiTaskIterator(dataset, batch_size=2, data_shape=(64, 128), num_threads=2)
    b = NativeMultiTaskIterator(dataset, batch_size=2, data_shape=(64, 128), num_threads=4)
    ba = a.next_batch()
    bb = b.next_batch()
    np.testing.assert_array_equal(ba["images"], bb["images"])  # thread count must not matter
    a.close()
    b.close()


def test_native_u8_device_normalize_parity(dataset):
    # uint8 H2D + device mean-sub must be bit-identical to the f32 path
    # (same arithmetic: float(u8) - mean)
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True,
              shuffle=True, num_threads=2)
    f32 = NativeMultiTaskIterator(dataset, **kw)
    u8 = NativeMultiTaskIterator(dataset, device_normalize=True, **kw)
    try:
        for _ in range(2):
            bf, bu = f32.next_batch(), u8.next_batch()
            np.testing.assert_array_equal(np.asarray(bu["images"]), bf["images"])
            np.testing.assert_array_equal(bu["label_det"], bf["label_det"])
            np.testing.assert_array_equal(bu["seg_label"], bf["seg_label"])
    finally:
        f32.close()
        u8.close()


def test_native_s2d_is_exact_permutation(dataset):
    """s2d mode must emit exactly space_to_depth(plain batch) — same pixels,
    rearranged — in both the f32 and the uint8 (device-normalize) modes."""
    from dspnet_tpu.models.layers import space_to_depth

    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True,
              shuffle=True, num_threads=2)
    plain = NativeMultiTaskIterator(dataset, **kw)
    s2d = NativeMultiTaskIterator(dataset, s2d=True, **kw)
    s2d_u8 = NativeMultiTaskIterator(dataset, s2d=True, device_normalize=True,
                                     **kw)
    try:
        for _ in range(2):
            bp, bs, bu = (plain.next_batch(), s2d.next_batch(),
                          s2d_u8.next_batch())
            assert bs["images"].shape == (2, 32, 64, 12)
            np.testing.assert_array_equal(
                bs["images"], space_to_depth(bp["images"]))
            np.testing.assert_array_equal(
                np.asarray(bu["images"]), space_to_depth(bp["images"]))
            np.testing.assert_array_equal(bs["label_det"], bp["label_det"])
            np.testing.assert_array_equal(bs["seg_label"], bp["seg_label"])
    finally:
        plain.close()
        s2d.close()
        s2d_u8.close()


def test_python_iterator_s2d_matches_plain(dataset):
    from dspnet_tpu.models.layers import space_to_depth

    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True, shuffle=True)
    plain = MultiTaskIterator(dataset, **kw)
    s2d = MultiTaskIterator(dataset, s2d=True, **kw)
    (bp, _), (bs, _) = plain.next_batch(), s2d.next_batch()
    np.testing.assert_array_equal(bs["images"], space_to_depth(bp["images"]))


def test_native_epoch_yields_fnames(dataset):
    # epoch() pairs each batch with its image paths in emitted order
    it = NativeMultiTaskIterator(dataset, batch_size=2, data_shape=(64, 128),
                                 enable_aug=False, shuffle=False, num_threads=2)
    try:
        seen = []
        for batch, names in it.epoch():
            assert len(names) == 2
            assert batch["images"].shape == (2, 64, 128, 3)
            seen.extend(names)
        expected = [dataset[i].image_path for i in range(len(seen))]
        assert seen == expected
    finally:
        it.close()


def test_native_pad_last(dataset):
    # 6 samples, batch 4, pad_last: 2 batches; the tail holds 2 real rows
    # and 2 padded rows (zero image after mean-sub offset, -1 labels, 255 seg)
    it = NativeMultiTaskIterator(dataset, batch_size=4, data_shape=(64, 128),
                                 enable_aug=False, shuffle=False,
                                 num_threads=2, pad_last=True)
    try:
        batches = list(it.epoch())
        assert len(batches) == 2
        tail, names = batches[-1]
        assert len(names) == 2
        assert tail["images"].shape == (4, 64, 128, 3)
        assert np.all(tail["label_det"][2:] == -1.0)
        assert np.all(tail["seg_label"][2:] == 255)
        assert np.any(tail["label_det"][0, :, 0] >= 0)
        # without pad_last the tail is dropped
        it2 = NativeMultiTaskIterator(dataset, batch_size=4,
                                      data_shape=(64, 128), enable_aug=False,
                                      shuffle=False, num_threads=2)
        assert len(list(it2.epoch())) == 1
        it2.close()
    finally:
        it.close()


def test_native_pad_last_u8(dataset):
    # pad_last composes with the uint8 device-normalize mode: padded image
    # rows are zero bytes -> -mean after on-device normalize; labels/seg
    # carry the empty-row sentinels
    it = NativeMultiTaskIterator(dataset, batch_size=4, data_shape=(64, 128),
                                 enable_aug=False, shuffle=False,
                                 num_threads=2, pad_last=True,
                                 device_normalize=True)
    try:
        batches = list(it.epoch())
        assert len(batches) == 2
        tail, names = batches[-1]
        assert len(names) == 2
        img = np.asarray(tail["images"])
        from dspnet_tpu.data.augment import MEAN_PIXELS
        np.testing.assert_allclose(
            img[2:],
            np.broadcast_to(-np.asarray(MEAN_PIXELS, np.float32),
                            img[2:].shape), atol=1e-5)
        assert np.all(tail["label_det"][2:] == -1.0)
        assert np.all(tail["seg_label"][2:] == 255)
    finally:
        it.close()
