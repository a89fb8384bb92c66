"""Dataset objects with the reference's input-data semantics.

The counterpart of ``distributed_tensorflow_tpu/data/datasets.py`` for
``mnist``, ``fashion_mnist``, ``cifar10`` and the token set ``lm``:
``read_data_sets(data_dir, one_hot=True)``
plus per-worker ``next_batch(batch_size)``, every worker drawing its own
independently shuffled minibatches (``MNISTDist.py:167,178``), and
``DataSet.shard`` for disjoint shards.

Sources, in priority order: IDX files (MNIST) or the CIFAR-10 python
pickles in ``data_dir``, then the procedural sets of ``synthetic.py``.
``lm`` is always procedural (``data/lm.py``).

The epoch shuffle is the JAX package's native one (``native/fastdata.cpp``
``permutation``: Fisher-Yates driven by xorshift64*), written here in
Python with the uint64 wraparound explicit, so that a seed gives the port
the index stream the JAX package has when its native library is built.
"""

from __future__ import annotations

import functools
import os
import pickle
from dataclasses import dataclass, field

import numpy as np

from distributed_tensorflow_tpu_torch.data import synthetic
from distributed_tensorflow_tpu_torch.data.idx import find_idx_file, read_idx
from distributed_tensorflow_tpu_torch.data.lm import LMDataSet

_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

SYNTHETIC_TRAIN = 20000
SYNTHETIC_TEST = 2000
LM_TRAIN = 4096  # lm split sizes: sequences are procedural, fresh-
LM_TEST = 512    # permutation-per-row; memorization is impossible anyway

_U64 = 0xFFFFFFFFFFFFFFFF
# batches normalize as the JAX package's native gather does (x * 1.0f/255.0f)
_INV_255 = np.float32(1.0 / 255.0)


def permutation(n: int, seed: int) -> np.ndarray:
    """A permutation of ``range(n)``: Fisher-Yates from the top, each
    swap index drawn by xorshift64* (``fastdata.cpp`` ``permutation``).
    Python integers do not wrap, so every shift left and the multiply
    are masked back to 64 bits."""
    out = list(range(n))
    s = (seed & _U64) or 0x9E3779B97F4A7C15
    for i in range(n - 1, 0, -1):
        s ^= s >> 12
        s ^= (s << 25) & _U64
        s ^= s >> 27
        j = ((s * 0x2545F4914F6CDD1D) & _U64) % (i + 1)
        out[i], out[j] = out[j], out[i]
    return np.asarray(out, dtype=np.int64)


class DataSet:
    """One split. ``next_batch`` matches the reference tutorial DataSet:
    shuffled epochs, each worker shuffling independently from its seed.

    Images may be float32 (already normalized) or uint8: uint8 storage
    keeps the split at a quarter of the memory and batches normalize on
    demand."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *,
                 one_hot: bool = True, num_classes: int = 10, seed: int = 0):
        if images.shape[0] != labels.shape[0]:
            raise ValueError(f"{images.shape[0]} images but "
                             f"{labels.shape[0]} labels")
        if images.dtype == np.uint8:
            self._images_u8 = images.reshape(len(images), -1)
            self._images_f32: np.ndarray | None = None
        else:
            self._images_u8 = None
            self._images_f32 = images
        self.labels_int = labels.astype(np.int64)
        # out-of-range ids fail here, at load time: the loss one-hots
        # integer labels, and an invalid id would silently drop the
        # example from the loss
        bad = (self.labels_int < 0) | (self.labels_int >= num_classes)
        if bad.any():
            idx = int(np.argmax(bad))
            raise ValueError(
                f"label out of range: labels[{idx}] = "
                f"{int(self.labels_int[idx])} not in [0, {num_classes}) "
                f"({int(bad.sum())} invalid of {len(self.labels_int)})")
        self.one_hot = one_hot
        self.num_classes = num_classes
        self._rng = np.random.default_rng(seed)
        self._order = self._fresh_order(images.shape[0])
        self._pos = 0
        self.epochs_completed = 0

    def _fresh_order(self, n: int) -> np.ndarray:
        """Epoch shuffle order; each epoch's sub-seed is drawn from this
        DataSet's seeded generator, as in the JAX package."""
        sub_seed = int(self._rng.integers(0, 2**63 - 1))
        return permutation(n, sub_seed)

    @property
    def images(self) -> np.ndarray:
        """Full split as float32 in [0,1] (materialized once for u8 storage)."""
        if self._images_f32 is None:
            self._images_f32 = self._images_u8.astype(np.float32) / 255.0
        return self._images_f32

    @property
    def num_examples(self) -> int:
        return len(self.labels_int)

    @property
    def labels(self) -> np.ndarray:
        if self.one_hot:
            return self._one_hot(self.labels_int)
        return self.labels_int

    def _one_hot(self, ids: np.ndarray) -> np.ndarray:
        out = np.zeros((len(ids), self.num_classes), np.float32)
        out[np.arange(len(ids)), ids] = 1.0
        return out

    def _next_indices(self, batch_size: int) -> np.ndarray:
        """Sequential walk over a shuffled order, reshuffling each epoch."""
        if self.num_examples == 0:
            raise ValueError("next_batch on an empty DataSet (0 examples)")
        idx = np.empty(batch_size, dtype=np.int64)
        filled = 0
        while filled < batch_size:
            take = min(batch_size - filled, len(self._order) - self._pos)
            idx[filled:filled + take] = self._order[self._pos:self._pos + take]
            self._pos += take
            filled += take
            if self._pos >= len(self._order):
                self._order = self._fresh_order(self.num_examples)
                self._pos = 0
                self.epochs_completed += 1
        return idx

    def next_batch(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """(float32 images in [0,1], one-hot or int64 labels) — the
        reference tutorial API (``MNISTDist.py:178``)."""
        idx = self._next_indices(batch_size)
        if self._images_u8 is not None:
            xs = self._images_u8[idx].astype(np.float32) * _INV_255
        else:
            xs = self._images_f32[idx]
        ids = self.labels_int[idx]
        return xs, (self._one_hot(ids) if self.one_hot else ids)

    def next_batch_raw(self, batch_size: int) -> tuple[np.ndarray, np.ndarray]:
        """(uint8 images, int32 class ids): the thin-wire batch format,
        a quarter of the bytes per example; the model normalizes on the
        device. Same index stream as ``next_batch``."""
        idx = self._next_indices(batch_size)
        return self._raw_u8()[idx], self.labels_int[idx].astype(np.int32)

    def _raw_u8(self) -> np.ndarray:
        if self._images_u8 is not None:
            return self._images_u8
        if getattr(self, "_u8_cache", None) is None:
            # one-time quantization of a float-stored source, kept apart
            # so the f32 next_batch path stays exactly as loaded
            self._u8_cache = np.clip(
                np.round(self._images_f32 * 255.0), 0, 255
            ).astype(np.uint8).reshape(len(self._images_f32), -1)
        return self._u8_cache

    def shard(self, index: int, count: int) -> "DataSet":
        """Disjoint contiguous shard (the sync-DP alternative to every
        worker loading everything)."""
        sl = slice(index * self.num_examples // count,
                   (index + 1) * self.num_examples // count)
        src = self._images_u8 if self._images_u8 is not None \
            else self._images_f32
        return DataSet(src[sl], self.labels_int[sl], one_hot=self.one_hot,
                       num_classes=self.num_classes, seed=index)


@dataclass
class Datasets:
    train: DataSet
    test: DataSet
    validation: DataSet | None = None
    source: str = "synthetic"  # "idx" | "cifar" | "synthetic"
    meta: dict = field(default_factory=dict)


def _load_mnist_idx(data_dir: str) -> dict[str, np.ndarray] | None:
    paths = {k: find_idx_file(data_dir, v) for k, v in _MNIST_FILES.items()}
    if not all(paths.values()):
        return None
    return {k: read_idx(p) for k, p in paths.items()}


def _load_cifar10(data_dir: str):
    """The CIFAR-10 python-version pickle batches (``data_batch_1..5``,
    ``test_batch``, in ``data_dir`` or its ``cifar-10-batches-py``) ->
    (train images, train labels, test images, test labels), images
    float32 [N, 32, 32, 3] in [0, 1]; None when a file is missing."""
    def _find(name):
        for root in (data_dir, os.path.join(data_dir, "cifar-10-batches-py")):
            p = os.path.join(root, name)
            if os.path.exists(p):
                return p
        return None

    train_paths = [_find(f"data_batch_{i}") for i in range(1, 6)]
    test_path = _find("test_batch")
    if not all(train_paths) or test_path is None:
        return None

    def _read(p):
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(d[b"labels"], np.int64)

    xs, ys = zip(*[_read(p) for p in train_paths])
    tx, ty = _read(test_path)
    return np.concatenate(xs), np.concatenate(ys), tx, ty


_SYNTHETIC = {"mnist": synthetic.synthetic_digits,
              "cifar10": synthetic.synthetic_cifar}


@functools.lru_cache(maxsize=4)
def _synthetic_split(num: int, seed: int,
                     kind: str = "mnist") -> tuple[np.ndarray, np.ndarray]:
    """A procedural split (``synthetic_digits`` or ``synthetic_cifar``)
    made read-only and kept for reuse: rendering 20,000 examples takes
    seconds, and every array is a pure function of (num, seed, kind)."""
    images, labels = _SYNTHETIC[kind](num, seed=seed)
    images.setflags(write=False)
    labels.setflags(write=False)
    return images, labels


def read_data_sets(data_dir: str, one_hot: bool = True,
                   dataset: str = "mnist", seed: int = 0,
                   validation_size: int = 0, seq_len: int = 256,
                   vocab_size: int = 64) -> Datasets:
    """API parity with the tutorial loader the reference imports
    (``MNISTDist.py:11,167``) for "mnist" and "fashion_mnist" (the same
    IDX format) and "cifar10" (the python pickles; float32 images, which
    the thin-wire and device-resident paths quantize to uint8 once),
    and "lm", procedural associative-recall token sequences for the
    causal LM (``seq_len``/``vocab_size`` apply only there). Falls back
    to procedural data when the files are absent (offline hosts)."""
    dataset = dataset.lower().replace("-", "_")
    if dataset == "lm":
        return _read_lm(seed, validation_size, seq_len, vocab_size)
    have_dir = bool(data_dir) and os.path.isdir(data_dir)
    if dataset in ("mnist", "fashion_mnist"):
        raw = _load_mnist_idx(data_dir) if have_dir else None
        if raw is not None:
            # keep u8 storage: batches normalize on demand
            trx = raw["train_images"].reshape(-1, 784)
            trl = raw["train_labels"].astype(np.int64)
            tex = raw["test_images"].reshape(-1, 784)
            tel = raw["test_labels"].astype(np.int64)
            source = "idx"
        else:
            trx, trl = _synthetic_split(SYNTHETIC_TRAIN, seed)
            tex, tel = _synthetic_split(SYNTHETIC_TEST, seed + 1)
            source = "synthetic"
        meta = {"image_size": 28, "channels": 1, "num_classes": 10,
                "flat": True}
    elif dataset == "cifar10":
        raw = _load_cifar10(data_dir) if have_dir else None
        if raw is not None:
            trx, trl, tex, tel = raw
            source = "cifar"
        else:
            trx, trl = _synthetic_split(SYNTHETIC_TRAIN, seed, "cifar10")
            tex, tel = _synthetic_split(SYNTHETIC_TEST, seed + 1, "cifar10")
            source = "synthetic"
        meta = {"image_size": 32, "channels": 3, "num_classes": 10,
                "flat": False}
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    val = None
    if validation_size:
        if not 0 <= validation_size < len(trx):
            raise ValueError(
                f"validation_size={validation_size} must be in "
                f"[0, {len(trx)}) for this train split")
        val = DataSet(trx[:validation_size], trl[:validation_size],
                      one_hot=one_hot, seed=seed + 2)
        trx, trl = trx[validation_size:], trl[validation_size:]

    return Datasets(
        train=DataSet(trx, trl, one_hot=one_hot, seed=seed),
        test=DataSet(tex, tel, one_hot=one_hot, seed=seed + 1),
        validation=val,
        source=source,
        meta=meta,
    )


def _read_lm(seed: int, validation_size: int, seq_len: int,
             vocab_size: int) -> Datasets:
    """The ``lm`` splits: ``LM_TRAIN`` and ``LM_TEST`` sequences from
    seeds ``seed`` and ``seed + 10000``, and a validation split of any
    positive size generated from its own seed space (``seed + 20000``),
    not carved from the train split."""
    if validation_size < 0:
        raise ValueError(f"validation_size={validation_size} must be >= 0")
    train = LMDataSet(LM_TRAIN, seq_len, vocab_size, seed=seed)
    test = LMDataSet(LM_TEST, seq_len, vocab_size, seed=seed + 10_000)
    val = (LMDataSet(validation_size, seq_len, vocab_size,
                     seed=seed + 20_000) if validation_size else None)
    return Datasets(
        train=train, test=test, validation=val, source="synthetic",
        meta={"kind": "lm", "seq_len": seq_len, "vocab_size": vocab_size,
              "num_classes": vocab_size})
