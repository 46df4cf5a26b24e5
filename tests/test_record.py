"""Packed .drec record store: pack/load roundtrip + iterator parity.

The record path must be byte-identical to the file path (encoded bytes are
copied verbatim, mirroring the reference's im2rec pack-without-recompress,
tools/im2rec.py:86-92), so batches from a record-backed index must equal
batches from the plain file-backed index bit for bit.
"""

import os

import numpy as np
import pytest

from dspnet_tpu.data import record, synthetic
from dspnet_tpu.data.imdb import load_imglist, load_index
from dspnet_tpu.data.iterator import MultiTaskIterator, SampleIndex
from dspnet_tpu.data.native_loader import NativeMultiTaskIterator


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rec_synth"))
    return synthetic.build_dataset(root, num_samples=6, hw=(64, 128))




def _write_lst(dataset, path):
    """Write a save_imglist-format .lst for `dataset` (test fixture helper)."""
    with open(path, "w") as f:
        for i in range(len(dataset)):
            s = dataset[i]
            rows = s.label[s.label[:, 0] >= 0]
            flat = " ".join("%.6f" % v for v in rows.reshape(-1))
            f.write(f"{i}\t2\t6\t{flat}\t{s.image_path}\n")


@pytest.fixture(scope="module")
def packed(dataset, tmp_path_factory):
    prefix = os.path.join(str(tmp_path_factory.mktemp("rec_store")), "train")
    record.pack_records(dataset, prefix, quiet=True)
    return prefix


def test_roundtrip_labels_and_names(dataset, packed):
    idx = record.load_record_index(packed)
    assert len(idx) == len(dataset)
    for i in range(len(idx)):
        np.testing.assert_array_equal(idx[i].label, dataset[i].label)
        assert idx[i].image_path == dataset[i].image_path
        assert (idx[i].seg_span is not None) == (dataset[i].seg_path is not None)


def test_record_batches_bit_identical(dataset, packed):
    """Same seed tables + verbatim bytes => identical batches."""
    rec_idx = record.load_record_index(packed)
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True, shuffle=True)
    it_file = MultiTaskIterator(dataset, **kw)
    it_rec = MultiTaskIterator(rec_idx, **kw)
    for _ in range(3):
        bf, nf = it_file.next_batch()
        br, nr = it_rec.next_batch()
        assert nf == nr  # original paths preserved for the fnames contract
        for k in bf:
            np.testing.assert_array_equal(bf[k], br[k])


def test_load_index_autodetects_records(dataset, packed):
    idx = load_index(os.path.dirname(packed), "train")
    assert len(idx) == len(dataset)
    assert idx[0].image_span is not None
    # pointing straight at the .drec file also works
    idx2 = load_index(packed + ".drec", "ignored")
    assert len(idx2) == len(dataset)


def test_imglist_roundtrip_and_pack(dataset, tmp_path):
    """save_imglist -> load_imglist -> pack: the .lst leg of the pipeline."""
    lst = str(tmp_path / "train.lst")
    _write_lst(dataset, lst)
    idx = load_imglist(lst)
    assert len(idx) == len(dataset)
    np.testing.assert_allclose(idx[0].label, dataset[0].label, atol=1e-5)
    assert idx[0].seg_path == dataset[0].seg_path  # seg derived by naming rule
    prefix = str(tmp_path / "packed")
    record.pack_records(idx, prefix, quiet=True)
    assert len(record.load_record_index(prefix)) == len(dataset)


def test_im2rec_cli(dataset, tmp_path):
    from dspnet_tpu.tools import im2rec

    lst = str(tmp_path / "train.lst")
    _write_lst(dataset, lst)
    out = str(tmp_path / "cli_train")
    im2rec.main(["--lst", lst, "--out", out])
    assert os.path.exists(out + ".drec") and os.path.exists(out + ".idx")
    assert len(record.load_record_index(out)) == len(dataset)


@pytest.mark.parametrize("enable_aug", [False, True])
def test_native_reads_records(native_lib, dataset, packed, enable_aug):
    """C++ workers fseek into the .drec: parity with the file-backed native path."""
    rec_idx = record.load_record_index(packed)
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=enable_aug, shuffle=True)
    nat_file = NativeMultiTaskIterator(dataset, num_threads=2, **kw)
    nat_rec = NativeMultiTaskIterator(rec_idx, num_threads=3, **kw)
    for _ in range(3):
        bf = nat_file.next_batch()
        br = nat_rec.next_batch()
        for k in ("images", "label_det", "seg_label"):
            np.testing.assert_array_equal(bf[k], br[k])
    nat_file.close()
    nat_rec.close()


def test_repack_from_record_index(packed, tmp_path):
    """Packing a record-backed index copies spans verbatim."""
    idx = record.load_record_index(packed)
    prefix = str(tmp_path / "repacked")
    record.pack_records(idx, prefix, quiet=True)
    idx2 = record.load_record_index(prefix)
    s1, s2 = idx[0], idx2[0]
    from dspnet_tpu.data.iterator import read_span

    np.testing.assert_array_equal(read_span(s1.image_span), read_span(s2.image_span))


def test_drec_root_respects_split(dataset, packed, tmp_path):
    """--dataset-root pointing at train.drec must NOT serve the training
    records for the val split when a sibling val.drec exists."""
    import shutil

    d = str(tmp_path / "store")
    os.makedirs(d)
    shutil.copy(packed + ".drec", os.path.join(d, "train.drec"))
    shutil.copy(packed + ".idx", os.path.join(d, "train.idx"))
    val_idx = SampleIndex([dataset[0], dataset[1]])
    record.pack_records(val_idx, os.path.join(d, "val"), quiet=True)
    got = load_index(os.path.join(d, "train.drec"), "val")
    assert len(got) == 2  # the sibling val store, not the named train one
    got_train = load_index(os.path.join(d, "train.drec"), "train")
    assert len(got_train) == len(dataset)
