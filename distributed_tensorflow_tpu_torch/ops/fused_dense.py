"""``relu(x @ w + b)`` as one hand-written CUDA kernel, with its gradient.

The counterpart of ``distributed_tensorflow_tpu/ops/pallas_ops.py``: the
forward is the kernel in ``csrc/fused_dense_relu.cu`` (it replaces the TPU
kernel ``_kernel`` behind ``pl.pallas_call`` in ``_forward``); the
backward, plain XLA in the reference (``_bwd``), is plain torch matmuls
here.

``fused_dense_relu`` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

LAUNCHES = 0  # kernel launches since the last reset (a plain integer)

BLOCK_N = 64  # output columns per block, as in the kernel
BLOCK_K = 32  # K depth per shared-memory round, as in the kernel
BLOCKS_PER_SM = 4  # split-K target: grid of about this many blocks per SM

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_sm_count: dict[int, int] = {}


def fused_dense_relu_reference(x, w, b):
    """The plain version: ``relu(x @ w + b)`` summed in float32, returned
    in ``x``'s dtype."""
    return torch.relu(x.float() @ w.float() + b.float()).to(x.dtype)


def launch_config(m: int, n: int, k: int, sms: int) -> tuple[int, int, int]:
    """(block_m, splits, k_per_split) for an [m,k] @ [k,n] product on a
    card with ``sms`` multiprocessors: a 16-row M tile for m <= 16, else
    64 rows; K split into whole 32-deep chunks so the grid holds about
    ``BLOCKS_PER_SM`` blocks per SM (the serving shapes have only 16
    output tiles)."""
    block_m = 16 if m <= 16 else 64
    tiles = math.ceil(m / block_m) * math.ceil(n / BLOCK_N)
    chunks = math.ceil(k / BLOCK_K)
    want = max(1, min(chunks, math.ceil(BLOCKS_PER_SM * sms / tiles)))
    per = math.ceil(chunks / want)
    return block_m, math.ceil(chunks / per), per * BLOCK_K


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
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_dense_relu_error_string.argtypes = [ctypes.c_int]
        lib.fused_dense_relu_error_string.restype = ctypes.c_char_p
    return lib


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
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    block_m, splits, k_per_split = launch_config(m, n, k, _sm_count[dev])
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_dense_relu_launch(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        m, n, k, block_m, splits, k_per_split, dev, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_dense_relu kernel launch failed: "
            f"{lib.fused_dense_relu_error_string(err).decode()} "
            f"(M={m} N={n} K={k} block_m={block_m} splits={splits})")
    LAUNCHES += 1
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
