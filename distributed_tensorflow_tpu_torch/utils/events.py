"""CRC-32C (Castagnoli) and the TensorBoard scalar event-file writer.

The counterpart of ``distributed_tensorflow_tpu/utils/events.py``, numpy
only: the optional ``google_crc32c`` C extension is not assumed.

``EventFileWriter`` writes standard ``events.out.tfevents.*`` logs that
TensorBoard reads directly, the sink of the reference's summary op
(``MNISTDist.py:155,162``):

  TFRecord framing: u64 length | u32 masked_crc32c(length) | payload
                    | u32 masked_crc32c(payload)
  payload: a tensorflow.Event proto, encoded by hand (wall_time=1 double,
  step=2 int64, file_version=3 string,
  summary=5 { repeated Value { tag=1 string, simple_value=2 float } })

``_crc32c`` is the scalar table recurrence (the reference implementation).
``crc32c`` computes the identical checksum at bulk speed by CRC's GF(2)
linearity: the message is cut into fixed-length chunks, every chunk's
checksum from state 0 is computed at once (one vectorized recurrence over a
chunk-wide state vector), and the per-chunk results fold together through
the cached linear "advance the state over L zero bytes" operator, stored as
4x256 byte-indexed tables.
"""

from __future__ import annotations

import os
import socket
import struct
import time

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


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    body = _len_delimited(1, tag.encode())  # Value.tag = 1
    body += _varint((2 << 3) | 5) + struct.pack("<f", float(value))  # simple_value = 2
    return body


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    body = _varint((1 << 3) | 1) + struct.pack("<d", wall_time)  # wall_time = 1
    body += _varint(2 << 3) + _varint(int(step))  # step = 2 (varint)
    if file_version is not None:
        body += _len_delimited(3, file_version.encode())  # file_version = 3
    if scalars:
        summary = b"".join(
            _len_delimited(1, _scalar_value(tag, v))  # Summary.value = 1
            for tag, v in sorted(scalars.items()))
        body += _len_delimited(5, summary)  # Event.summary = 5
    return body


class EventFileWriter:
    """Append-only TensorBoard scalar log for one run directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._file = open(self.path, "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars: dict) -> None:
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float))}
        if clean:
            self._write(_event(time.time(), step, scalars=clean))
            self._file.flush()

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
