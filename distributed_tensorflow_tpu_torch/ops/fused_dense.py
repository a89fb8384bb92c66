"""``relu(x @ w + b)`` as one hand-written CUDA kernel, with its gradient.

The counterpart of ``distributed_tensorflow_tpu/ops/pallas_ops.py``: the
forward is the kernel in ``csrc/fused_dense_relu.cu`` (it replaces the TPU
kernel ``_kernel`` behind ``pl.pallas_call`` in ``_forward``); the
backward, plain XLA in the reference (``_bwd``), is plain torch matmuls
here.

``fused_dense_relu`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts the kernel's launches (``LAUNCHES_BY_VARIANT`` by
variant), so a run can show that its main path went through the kernel.
A call made while a CUDA graph is being captured launches nothing: it is
recorded into the ``recording()`` that is open, and the code that
replays the graph counts the recorded launches at each replay
(``count_replay``).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

LAUNCHES = 0  # kernel launches since the last reset (a plain integer)
# the same launches by variant: "tma" (TMA ring, wgmma in bf16, cluster
# split-K) and "simt" (shapes TMA cannot describe)
LAUNCHES_BY_VARIANT = {"tma": 0, "simt": 0}
_recordings: list[dict[str, int]] = []  # open recording() dicts

BLOCK_N = 64  # output columns per CTA, as in the kernel (both variants)
# K depth of one ring stage of variant "tma": one 128-byte row of x
BLOCK_K = {torch.float32: 32, torch.bfloat16: 64}
# M tiles of variant "tma": wgmma's N slot in bf16; in f32, two
# warpgroups of 8 x 4 register tiles cover at most 64 rows
BLOCK_M = {torch.float32: (8, 16, 32, 64),
           torch.bfloat16: (8, 16, 32, 64, 128)}
MAX_CLUSTER = 8  # CTAs that split one tile's K (the portable cluster size)
CTAS_PER_SM = 1  # split-K target: at most one CTA per SM, one wave
SIMT_BLOCK_M = (16, 64)  # M tiles of variant "simt"
SIMT_BLOCK_K = 32  # K depth of one shared-memory round of variant "simt"

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODE = {"tma": 0, "simt": 1}
_sm_count: dict[int, int] = {}


class LaunchConfig(NamedTuple):
    variant: str  # "tma" or "simt"
    block_m: int  # rows of M per CTA
    cluster: int  # CTAs per cluster, each a split of K
    grid: tuple[int, int, int]  # (splits, N tiles, M tiles)


def fused_dense_relu_reference(x, w, b):
    """The plain version: ``relu(x @ w + b)`` summed in float32, returned
    in ``x``'s dtype."""
    return torch.relu(x.float() @ w.float() + b.float()).to(x.dtype)


def tma_ok(n: int, k: int, dtype: torch.dtype, x_ptr: int, w_ptr: int) -> bool:
    """True when TMA can describe x [m,k] and w [k,n]: 16-byte aligned
    base pointers and row strides."""
    es = torch.tensor([], dtype=dtype).element_size()
    return (k * es) % 16 == 0 and (n * es) % 16 == 0 and x_ptr % 16 == 0 \
        and w_ptr % 16 == 0


def split_chunks(rank: int, splits: int, chunks: int) -> range:
    """The K chunks that split ``rank`` of ``splits`` sums, as the kernel
    cuts them."""
    return range(rank * chunks // splits, (rank + 1) * chunks // splits)


def _cluster(tiles: int, chunks: int, sms: int) -> int:
    """CTAs per cluster, each a split of K: the largest power of two up to
    ``MAX_CLUSTER`` and ``chunks`` that keeps ``tiles`` clusters within
    ``CTAS_PER_SM`` CTAs per SM."""
    cap = max(1, min(MAX_CLUSTER, chunks, CTAS_PER_SM * sms // tiles))
    return 1 << (cap.bit_length() - 1)


def launch_config(m: int, n: int, k: int, dtype: torch.dtype, x_ptr: int,
                  w_ptr: int, sms: int) -> LaunchConfig:
    """The kernel variant and launch for an [m,k] @ [k,n] product of x
    and w at addresses ``x_ptr`` and ``w_ptr`` on a card with ``sms``
    multiprocessors (`sm_count`).

    Variant "tma" whenever TMA can describe the operands (`tma_ok`). Its M
    tile is the smallest in ``BLOCK_M[dtype]`` that holds m. Past the
    largest, bf16 takes the largest; f32 takes the smallest that leaves
    room for two K splits per tile on a grid of ``CTAS_PER_SM`` per SM,
    since its FMA loop ran faster as two splits than as one split of
    wider tiles or four of narrower ones (M = 128 and 256 on an H100).
    K is split over a cluster of CTAs (`_cluster`; N = 1024 gives only
    16 tiles at m <= 8, so 8 splits). Otherwise variant "simt": a 16-row
    M tile for m <= 16, else 64 rows, and K split the same way over
    ``SIMT_BLOCK_K``-deep chunks."""
    n_tiles = math.ceil(n / BLOCK_N)
    if not tma_ok(n, k, dtype, x_ptr, w_ptr):
        block_m = SIMT_BLOCK_M[0] if m <= SIMT_BLOCK_M[0] else SIMT_BLOCK_M[1]
        chunks = math.ceil(k / SIMT_BLOCK_K)
        variant = "simt"
    else:
        tiles = BLOCK_M[dtype]
        if m <= tiles[-1]:
            block_m = next(bm for bm in tiles if bm >= m)
        elif dtype == torch.float32:
            block_m = next((bm for bm in tiles
                            if 2 * n_tiles * math.ceil(m / bm)
                            <= CTAS_PER_SM * sms), tiles[-1])
        else:
            block_m = tiles[-1]
        chunks = math.ceil(k / BLOCK_K[dtype])
        variant = "tma"
    m_tiles = math.ceil(m / block_m)
    cluster = _cluster(n_tiles * m_tiles, chunks, sms)
    return LaunchConfig(variant, block_m, cluster, (cluster, n_tiles, m_tiles))


def _check(x, w, b):
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"fused_dense_relu takes x [M,K], w [K,N], b [N]; "
                         f"got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.shape[1] != w.shape[0] or b.shape[0] != w.shape[1]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not x.device == w.device == b.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}, {b.device}")
    if not x.dtype == w.dtype == b.dtype:
        raise TypeError(f"operands of different dtypes: {x.dtype}, "
                        f"{w.dtype}, {b.dtype}")


def _library():
    from distributed_tensorflow_tpu_torch.ops._build import load_library

    lib = load_library("fused_dense_relu")
    fn = lib.fused_dense_relu_launch
    if fn.argtypes is None:  # first use of this library
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_dense_relu_error_string.argtypes = [ctypes.c_int]
        lib.fused_dense_relu_error_string.restype = ctypes.c_char_p
    return lib


def sm_count(dev: int) -> int:
    """The multiprocessors of CUDA device ``dev``."""
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count[dev]


def _raise(lib, err: int, what: str):
    raise RuntimeError(f"fused_dense_relu {what} failed: "
                       f"{lib.fused_dense_relu_error_string(err).decode()} "
                       f"(code {err})")


@contextlib.contextmanager
def recording():
    """Collect, by variant, the launches recorded into a CUDA graph under
    capture inside the block."""
    recorded = {"tma": 0, "simt": 0}
    _recordings.append(recorded)
    try:
        yield recorded
    finally:
        _recordings.remove(recorded)


def count_replay(recorded: dict[str, int]) -> None:
    """Count the launches that one replay of a graph runs: ``recorded``
    is what its capture recorded (``recording``)."""
    global LAUNCHES
    for variant, n in recorded.items():
        LAUNCHES += n
        LAUNCHES_BY_VARIANT[variant] += n


def _launch(x, w, b):
    global LAUNCHES
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("the kernel takes contiguous (row-major) operands")
    m, k = x.shape
    n = w.shape[1]
    dev = x.device.index
    cfg = launch_config(m, n, k, x.dtype, x.data_ptr(), w.data_ptr(),
                        sm_count(dev))
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_dense_relu_launch(
        _DTYPE_CODE[x.dtype], _VARIANT_CODE[cfg.variant], x.data_ptr(),
        w.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, cfg.block_m,
        cfg.cluster, dev, stream)
    if err != 0:
        _raise(lib, err, f"kernel launch (M={m} N={n} K={k} {cfg})")
    if torch.cuda.is_current_stream_capturing():
        for recorded in _recordings:
            recorded[cfg.variant] += 1
    else:
        LAUNCHES += 1
        LAUNCHES_BY_VARIANT[cfg.variant] += 1
    return out


def _forward(x, w, b):
    _check(x, w, b)
    if x.device.type == "cpu":
        return fused_dense_relu_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dense_relu runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, w, b)


class _FusedDenseRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y = _forward(x, w, b)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # the reference's _bwd: mask by y > 0, then three plain products
        x, w, y = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros_like(g)).to(x.dtype)
        return g @ w.T, x.T @ g, g.sum(dim=0).to(x.dtype)


def fused_dense_relu(x, w, b):
    """relu(x @ w + b): x [M,K], w [K,N], b [N], one dtype (float32 or
    bfloat16), float32 accumulation, output in that dtype."""
    return _FusedDenseRelu.apply(x, w, b)
