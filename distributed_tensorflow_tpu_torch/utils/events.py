"""CRC-32C (Castagnoli) for the checkpoint manifests.

The counterpart of ``distributed_tensorflow_tpu/utils/events.py``'s
``crc32c``, numpy only: the optional ``google_crc32c`` C extension is not
assumed. The TensorBoard event writer comes with the training slice.

``_crc32c`` is the scalar table recurrence (the reference implementation).
``crc32c`` computes the identical checksum at bulk speed by CRC's GF(2)
linearity: the message is cut into fixed-length chunks, every chunk's
checksum from state 0 is computed at once (one vectorized recurrence over a
chunk-wide state vector), and the per-chunk results fold together through
the cached linear "advance the state over L zero bytes" operator, stored as
4x256 byte-indexed tables.
"""

from __future__ import annotations

import numpy as np

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)

_CRC_CHUNK_LEN = 1024
_ZERO_TABLE_CACHE: dict[int, np.ndarray] = {}


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _zero_advance_tables(length: int) -> np.ndarray:
    """4x256 uint32 tables for the linear map s -> R(s, 0^length)."""
    tables = _ZERO_TABLE_CACHE.get(length)
    if tables is None:
        t32 = np.asarray(_CRC_TABLE, dtype=np.uint32)
        vals = np.arange(256, dtype=np.uint32)
        s = np.concatenate([vals << np.uint32(8 * p) for p in range(4)])
        for _ in range(length):
            s = t32[s & np.uint32(0xFF)] ^ (s >> np.uint32(8))
        tables = s.reshape(4, 256)
        _ZERO_TABLE_CACHE[length] = tables
    return tables


def _crc32c_numpy(u8: np.ndarray) -> int:
    """Chunk-parallel CRC-32C of a 1-D uint8 array."""
    t32 = np.asarray(_CRC_TABLE, dtype=np.uint32)
    crc = 0xFFFFFFFF
    n = int(u8.size)
    L = _CRC_CHUNK_LEN
    pos = (n // L) * L
    if n // L >= 2:
        # columns contiguous so the L-iteration recurrence streams
        cols = np.ascontiguousarray(u8[:pos].reshape(n // L, L).T)
        s = np.zeros(n // L, np.uint32)
        for j in range(L):
            s = t32[(s ^ cols[j]) & np.uint32(0xFF)] ^ (s >> np.uint32(8))
        z0, z1, z2, z3 = _zero_advance_tables(L)
        for r in s.tolist():
            crc = (int(z0[crc & 0xFF]) ^ int(z1[(crc >> 8) & 0xFF])
                   ^ int(z2[(crc >> 16) & 0xFF]) ^ int(z3[crc >> 24]) ^ r)
    else:
        pos = 0
    for b in u8[pos:].tolist():
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data) -> int:
    """CRC-32C of ``data`` (bytes-like or ndarray), equal to ``_crc32c``."""
    if isinstance(data, np.ndarray):
        u8 = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        u8 = np.frombuffer(data, dtype=np.uint8)
    return _crc32c_numpy(u8)
