"""The port's fused_dense_relu against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version; the JAX side runs
the Pallas kernel in interpret mode, as tests/test_pallas_ops.py does.
Inputs are made with numpy from a seed and handed to both. The CUDA kernel
itself is held against the plain version by the `cuda`-marked test (and
by chip_smoke.py on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import pallas_ops
from distributed_tensorflow_tpu_torch.ops import _build, fused_dense
from distributed_tensorflow_tpu_torch.ops.fused_dense import (
    BLOCK_K,
    BLOCK_N,
    MAX_CLUSTER,
    fused_dense_relu,
    fused_dense_relu_reference,
    launch_config,
    split_chunks,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

WD1_M = (1, 2, 4, 8, 128, 256)  # the serving buckets and the training batches
DTYPES = (torch.float32, torch.bfloat16)


def _inputs(shape, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, w, b


def _jax(x, w, b, dtype=jnp.float32):
    return pallas_ops.fused_dense_relu(jnp.asarray(x, dtype),
                                       jnp.asarray(w, dtype),
                                       jnp.asarray(b, dtype), True)


@pytest.mark.parametrize("shape", [(128, 256, 128), (8, 100, 10),
                                   (130, 257, 70)])
def test_forward_matches_pallas(shape):
    # the tolerance of tests/test_pallas_ops.py
    x, w, b = _inputs(shape)
    got = fused_dense_relu(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(x, w, b)),
                               rtol=1e-4, atol=1e-5)


def test_forward_matches_pallas_at_wd1_shape_f32():
    # a 3136-term sum taken in another order: rtol 1e-4, atol 1e-4
    x, w, b = _inputs((8, 3136, 1024), seed=1)
    got = fused_dense_relu(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(x, w, b)),
                               rtol=1e-4, atol=1e-4)


def test_forward_matches_pallas_at_wd1_shape_bf16():
    # both round one float32 sum to bfloat16: within one bf16 ulp
    # (relative spacing 2**-7), plus 1e-3 for sums that sit near zero
    x, w, b = _inputs((8, 3136, 1024), seed=2)
    xt, wt, bt = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b))
    got = fused_dense_relu(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    want = np.asarray(_jax(x, w, b, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_grad_matches_jax_vjp():
    x, w, b = _inputs((32, 64, 48), seed=3)

    def loss_jax(x, w, b):
        return jnp.sum(pallas_ops.fused_dense_relu(x, w, b, True) ** 2)

    gj = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (fused_dense_relu(xt, wt, bt) ** 2).sum().backward()
    for got, want in zip((xt.grad, wt.grad, bt.grad), gj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_cpu_tensor_takes_plain_version_without_launching(monkeypatch):
    monkeypatch.setattr(fused_dense, "LAUNCHES", 0)
    x, w, b = map(torch.from_numpy, _inputs((4, 20, 12)))
    got = fused_dense_relu(x, w, b)
    assert torch.equal(got, fused_dense_relu_reference(x, w, b))
    assert fused_dense.LAUNCHES == 0


def test_wrapper_rejects_mismatched_operands():
    x, w, b = map(torch.from_numpy, _inputs((4, 20, 12)))
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_dense_relu(x, w[:10], b)
    with pytest.raises(TypeError, match="dtypes"):
        fused_dense_relu(x, w.double(), b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k", [(1, 1024, 3136), (8, 1024, 3136),
                                   (256, 1024, 3136), (130, 70, 257)])
def test_launch_config_covers_k_and_fills_the_card(m, n, k, dtype):
    cfg = launch_config(m, n, k, dtype, x_ptr=0, w_ptr=0, sms=132)
    splits, n_tiles, m_tiles = cfg.grid
    assert splits == cfg.cluster
    # the grid covers the output
    assert n_tiles * BLOCK_N >= n > (n_tiles - 1) * BLOCK_N
    assert m_tiles * cfg.block_m >= m > (m_tiles - 1) * cfg.block_m
    assert cfg.variant == ("simt" if (m, n, k) == (130, 70, 257) else "tma")
    # every K chunk in exactly one split, no empty split
    depth = fused_dense.SIMT_BLOCK_K if cfg.variant == "simt" else BLOCK_K[dtype]
    chunks = -(-k // depth)
    parts = [split_chunks(r, splits, chunks) for r in range(splits)]
    assert [c for p in parts for c in p] == list(range(chunks))
    assert all(len(p) > 0 for p in parts)
    # a portable cluster, a power of two; at most one CTA per SM
    assert 1 <= cfg.cluster <= MAX_CLUSTER <= 8
    assert cfg.cluster & (cfg.cluster - 1) == 0
    assert splits * n_tiles * m_tiles <= 132
    # ... and the card is at least half full unless K is too short to split
    assert (splits * n_tiles * m_tiles > 132 // 2 or cfg.cluster == MAX_CLUSTER
            or 2 * cfg.cluster > chunks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", WD1_M)
def test_launch_config_takes_tma_at_every_wd1_shape(m, dtype):
    cfg = launch_config(m, 1024, 3136, dtype, x_ptr=256, w_ptr=512, sms=132)
    assert cfg.variant == "tma"
    tiles = fused_dense.BLOCK_M[dtype]
    assert cfg.block_m in tiles
    ctas = cfg.grid[0] * cfg.grid[1] * cfg.grid[2]
    if m <= 8:  # 16 output tiles: K split 8 ways streams w from 128 SMs
        assert cfg.block_m == 8 and cfg.cluster == MAX_CLUSTER
        assert ctas >= 128
    elif dtype == torch.float32:  # past 64 rows: two K splits per tile
        assert cfg.cluster == 2 and ctas == 128
    else:  # bf16: the widest tile, wgmma's N slot
        assert cfg.block_m == tiles[-1]
    assert ctas <= 132


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,n,k,x_off,w_off", [
    (130, 70, 257, 0, 0),      # row strides not multiples of 16 bytes
    (8, 1024, 3136, 4, 0),     # x's base 4 bytes past a 16-byte boundary
    (8, 1024, 3136, 0, 8),     # w's base 8 bytes past one
    (8, 1024, 3138, 0, 0),     # x's rows 3138 elements long
])
def test_launch_config_takes_simt_where_tma_cannot_describe(m, n, k, x_off,
                                                            w_off, dtype):
    cfg = launch_config(m, n, k, dtype, x_ptr=1024 + x_off, w_ptr=2048 + w_off,
                        sms=132)
    es = torch.tensor([], dtype=dtype).element_size()
    if dtype == torch.float32 and k == 3138:
        assert (k * es) % 16 != 0
    assert cfg.variant == "simt"
    assert cfg.block_m in fused_dense.SIMT_BLOCK_M
    # K split over a cluster as in variant "tma": a power of two, <= 8
    assert cfg.cluster in (1, 2, 4, 8) and cfg.grid[0] == cfg.cluster


def test_library_path_hashes_headers_and_flags(tmp_path, monkeypatch):
    # editing a header, the source or the flags must rebuild the library
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _build.library_path("k")
    assert third != second
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    fourth = _build.library_path("k")
    assert fourth != third
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    assert _build.library_path("k") != fourth


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    # full f32 on the card: no TF32 in cuBLAS (the reference) or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3136, 1024), (8, 3136, 1024),
                                   (64, 3136, 1024), (128, 3136, 1024),
                                   (256, 3136, 1024), (130, 257, 70)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, dtype):
    x, w, b = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _inputs(shape, seed=4))
    variant = launch_config(shape[0], shape[2], shape[1], dtype, x.data_ptr(),
                            w.data_ptr(),
                            fused_dense.sm_count(x.device.index)).variant
    assert variant == ("simt" if shape == (130, 257, 70) else "tma")
    before = fused_dense.LAUNCHES
    by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
    got = fused_dense_relu(x, w, b)
    torch.cuda.synchronize()
    assert fused_dense.LAUNCHES == before + 1
    assert fused_dense.LAUNCHES_BY_VARIANT[variant] == by_variant[variant] + 1
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(got.float(),
                               fused_dense_relu_reference(x, w, b).float(),
                               **tol)
    # the split-K sum is taken in a fixed order: a second call is bitwise equal
    assert torch.equal(fused_dense_relu(x, w, b), got)


def _dyadic_inputs(m, seed):
    """x, w, b and an upstream gradient g of wd1's shape whose entries are
    small multiples of powers of two: every product is exact, and every
    sum of them is exact in float32 in any order, so the forward's ReLU
    mask cannot differ between the kernel and the plain version."""
    r = np.random.default_rng(seed)
    x = r.integers(-8, 9, (m, 3136)) / 8
    w = r.integers(-8, 9, (3136, 1024)) / 256
    b = r.integers(-8, 9, 1024) / 64
    g = r.integers(-8, 9, (m, 1024)) / 8
    return [a.astype(np.float32) for a in (x, w, b, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [128, 1000])
def test_kernel_gradient_matches_plain_autograd_on_card(cuda_device, m,
                                                        dtype):
    """dx, dw, db through the kernel's forward and the port's backward
    against autograd through the plain version, at the training (M = 128)
    and test-eval (M = 1000) shapes of wd1. On dyadic inputs every sum is
    exact, so the two agree to the last bit but for rounding the bf16
    outputs: rtol 2**-8 (half a bf16 ulp), atol 1e-6."""
    x, w, b, g = (torch.from_numpy(a).to(cuda_device, dtype)
                  for a in _dyadic_inputs(m, seed=5))
    for t in (x, w, b):
        t.requires_grad_()
    before = fused_dense.LAUNCHES
    y = fused_dense_relu(x, w, b)
    y.backward(g)
    assert fused_dense.LAUNCHES == before + 1  # the forward, nothing else
    got = [t.grad.float() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    ref = fused_dense_relu_reference(x, w, b)
    ref.backward(g)
    tol = dict(rtol=2 ** -8, atol=1e-6)
    torch.testing.assert_close(y.float(), ref.float(), **tol)
    for name, a, t in zip(("dx", "dw", "db"), got, (x, w, b)):
        torch.testing.assert_close(a, t.grad.float(), **tol,
                                   msg=lambda s, n=name: f"{n}: {s}")
