"""IDX file format reader (the MNIST/Fashion-MNIST on-disk format).

The counterpart of ``distributed_tensorflow_tpu/data/idx.py``: the four
(optionally gzipped) IDX files the TF tutorial downloader leaves in
``--data_dir``, read with numpy alone.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_IDX_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_idx(path: str) -> np.ndarray:
    """Parse one IDX file (optionally gzipped) into a numpy array."""
    with _open_maybe_gzip(path) as f:
        magic = f.read(4)
        if len(magic) != 4 or magic[0] != 0 or magic[1] != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic {magic!r})")
        dtype_code, ndim = magic[2], magic[3]
        if dtype_code not in _IDX_DTYPES:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
        dims = struct.unpack(f">{ndim}i", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=_IDX_DTYPES[dtype_code])
        if data.size != int(np.prod(dims)):
            raise ValueError(
                f"{path}: payload has {data.size} elements, header says {dims}"
            )
        return data.reshape(dims)


def find_idx_file(data_dir: str, stem: str) -> str | None:
    """Locate ``stem`` under data_dir, tolerating .gz and the common
    '-idx3-ubyte'/'.idx3-ubyte' naming variants."""
    candidates = [
        stem,
        stem + ".gz",
        stem.replace("-idx", ".idx"),
        stem.replace("-idx", ".idx") + ".gz",
    ]
    for name in candidates:
        p = os.path.join(data_dir, name)
        if os.path.exists(p):
            return p
    return None
