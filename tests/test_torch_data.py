"""The port's data modules against the JAX package's: the same splits
byte for byte, the same epoch index stream, the same IDX reader, and the
pinned prefetch's delivery and shutdown."""

import gzip
import struct
import threading

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import native
from distributed_tensorflow_tpu.data import datasets as jdata
from distributed_tensorflow_tpu.data import idx as jidx
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.data import idx as tidx
from distributed_tensorflow_tpu_torch.data.pipeline import (
    batch_iterator,
    prefetch_to_device,
)


@pytest.fixture
def small_splits(monkeypatch):
    """Both packages' synthetic splits cut to 600/200 examples, so that
    rendering them takes a fraction of a second."""
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "SYNTHETIC_TRAIN", 600)
        monkeypatch.setattr(mod, "SYNTHETIC_TEST", 200)


def _native_or_skip():
    if not native.available():
        pytest.skip(f"the JAX package's native library did not load "
                    f"({native.build_error()}); its shuffle is then numpy's, "
                    f"which the port does not copy")


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
@pytest.mark.parametrize("validation_size", [0, 100])
def test_synthetic_splits_are_byte_identical(tmp_path, small_splits,
                                             validation_size, dataset):
    j = jdata.read_data_sets(str(tmp_path / "none"), seed=3,
                             validation_size=validation_size,
                             dataset=dataset)
    t = tdata.read_data_sets(str(tmp_path / "none"), seed=3,
                             validation_size=validation_size,
                             dataset=dataset)
    assert t.source == j.source == "synthetic" and t.meta == j.meta
    names = ["train", "test"] + (["validation"] if validation_size else [])
    for name in names:
        a, b = getattr(j, name), getattr(t, name)
        assert a.images.tobytes() == b.images.tobytes(), name
        assert a.labels.tobytes() == b.labels.tobytes(), name
        assert a.labels_int.tobytes() == b.labels_int.tobytes(), name


@pytest.mark.parametrize("n,seed", [(1, 5), (10, 0), (997, 2**63 - 5),
                                    (20000, 12345678901234567)])
def test_permutation_is_the_native_one(n, seed):
    _native_or_skip()
    np.testing.assert_array_equal(tdata.permutation(n, seed),
                                  native.permutation(n, seed))


@pytest.mark.parametrize("raw", [False, True])
def test_next_batch_stream_crosses_epochs_like_jax(raw):
    _native_or_skip()
    rng = np.random.default_rng(0)
    images = rng.random((50, 784), dtype=np.float32)
    labels = rng.integers(0, 10, 50)
    j = jdata.DataSet(images, labels, seed=7)
    t = tdata.DataSet(images, labels, seed=7)
    for _ in range(9):  # 9 x 16 = 144 examples: two epoch boundaries
        a = j.next_batch_raw(16) if raw else j.next_batch(16)
        b = t.next_batch_raw(16) if raw else t.next_batch(16)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert t.epochs_completed == j.epochs_completed == 2


def test_u8_source_batches_match_native_gather():
    _native_or_skip()
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (40, 784), dtype=np.uint8)
    labels = rng.integers(0, 10, 40)
    j = jdata.DataSet(images, labels, seed=2)
    t = tdata.DataSet(images, labels, seed=2)
    for _ in range(4):
        for x, y in zip(j.next_batch(12), t.next_batch(12)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t.images, j.images)
    a, b = j.shard(1, 3), t.shard(1, 3)
    np.testing.assert_array_equal(a.next_batch(5)[0], b.next_batch(5)[0])


def test_labels_out_of_range_are_refused():
    with pytest.raises(ValueError, match="label out of range"):
        tdata.DataSet(np.zeros((3, 4), np.float32), np.array([0, 10, 1]))


def test_other_datasets_are_not_ported(tmp_path):
    # "lm" is ported now (tests/test_torch_lm.py holds it to JAX); an
    # unknown name still raises
    ds = tdata.read_data_sets(str(tmp_path), dataset="lm", seq_len=8,
                              vocab_size=5)
    assert ds.meta["kind"] == "lm" and ds.train.images.shape[1] == 8
    with pytest.raises(ValueError, match="unknown dataset"):
        tdata.read_data_sets(str(tmp_path), dataset="imagenet")


def test_synthetic_cifar_is_byte_identical():
    from distributed_tensorflow_tpu.data import synthetic as jsyn
    from distributed_tensorflow_tpu_torch.data import synthetic as tsyn

    for n, seed in ((5, 0), (64, 7)):
        (jx, jy), (tx, ty) = (jsyn.synthetic_cifar(n, seed=seed),
                              tsyn.synthetic_cifar(n, seed=seed))
        assert tx.shape == (n, 32, 32, 3) and tx.dtype == np.float32
        assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


def _write_cifar_pickles(root, n_train=12, n_test=6):
    """The CIFAR-10 python-version batches (``data_batch_1..5``,
    ``test_batch``: dicts of uint8 rows in CHW order and a label list)."""
    import os
    import pickle

    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.default_rng(8)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name in names:
        n = n_test if name == "test_batch" else n_train
        blob = {b"data": rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(blob, f)


def test_cifar10_pickles_read_as_jax_reads_them(tmp_path, small_splits):
    _write_cifar_pickles(str(tmp_path))
    want = jdata._load_cifar10(str(tmp_path))
    got = tdata._load_cifar10(str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    j = jdata.read_data_sets(str(tmp_path), dataset="cifar10", seed=1)
    t = tdata.read_data_sets(str(tmp_path), dataset="cifar10", seed=1)
    assert t.source == j.source == "cifar" and t.meta == j.meta
    assert t.meta == {"image_size": 32, "channels": 3, "num_classes": 10,
                      "flat": False}
    assert t.train.num_examples == 60 and t.test.num_examples == 6
    for name in ("train", "test"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.images.tobytes() == b.images.tobytes()
        # the thin wire quantizes the float source to uint8 once
        assert b._raw_u8().shape == (b.num_examples, 3072)
        assert a._raw_u8().tobytes() == b._raw_u8().tobytes()
    assert tdata.read_data_sets(str(tmp_path / "missing"),
                                dataset="cifar10").source == "synthetic"


def _write_idx(path, arr, gz=False):
    head = bytes([0, 0, 0x08, arr.ndim]) + struct.pack(f">{arr.ndim}i",
                                                       *arr.shape)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(head + arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_files_are_read_first(tmp_path, gz):
    rng = np.random.default_rng(4)
    ext = ".gz" if gz else ""
    arrays = {"train-images-idx3-ubyte": rng.integers(0, 256, (30, 28, 28)),
              "train-labels-idx1-ubyte": rng.integers(0, 10, 30),
              "t10k-images-idx3-ubyte": rng.integers(0, 256, (12, 28, 28)),
              "t10k-labels-idx1-ubyte": rng.integers(0, 10, 12)}
    for name, a in arrays.items():
        _write_idx(str(tmp_path / (name + ext)), a.astype(np.uint8), gz)
    p = tidx.find_idx_file(str(tmp_path), "t10k-images-idx3-ubyte")
    assert p == jidx.find_idx_file(str(tmp_path), "t10k-images-idx3-ubyte")
    np.testing.assert_array_equal(tidx.read_idx(p), jidx.read_idx(p))
    j = jdata.read_data_sets(str(tmp_path))
    t = tdata.read_data_sets(str(tmp_path))
    assert t.source == j.source == "idx"
    np.testing.assert_array_equal(t.test.images, j.test.images)
    np.testing.assert_array_equal(t.train.labels, j.train.labels)


def test_prefetch_delivers_the_stream_in_order():
    rng = np.random.default_rng(5)
    images = rng.random((30, 8), dtype=np.float32)
    labels = rng.integers(0, 10, 30)
    ds = tdata.DataSet(images, labels, seed=1)
    want = tdata.DataSet(images, labels, seed=1)
    it = prefetch_to_device(batch_iterator(ds, 7), size=2, device="cpu")
    for _ in range(6):
        x, y = next(it)
        wx, wy = want.next_batch(7)
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    it.close()


def test_prefetch_worker_error_reaches_the_consumer():
    def broken():
        yield (np.zeros(2), np.zeros(2))
        raise RuntimeError("loader died")

    it = prefetch_to_device(broken(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)


def test_prefetch_close_stops_the_worker():
    before = {t.ident for t in threading.enumerate()}

    def endless():
        while True:
            yield (np.zeros(4, np.float32),)

    it = prefetch_to_device(endless(), size=2, device="cpu")
    next(it)
    workers = [t for t in threading.enumerate()
               if t.ident not in before and t.name == "prefetch"]
    assert len(workers) == 1 and workers[0].is_alive()
    it.close()  # the queue is full: the worker must see the stop flag
    workers[0].join(timeout=10)
    assert not workers[0].is_alive()
