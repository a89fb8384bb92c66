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
from distributed_tensorflow_tpu_torch.ops import fused_dense
from distributed_tensorflow_tpu_torch.ops.fused_dense import (
    fused_dense_relu,
    fused_dense_relu_reference,
    launch_config,
)


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


@pytest.mark.parametrize("m,n,k", [(1, 1024, 3136), (8, 1024, 3136),
                                   (256, 1024, 3136), (130, 70, 257)])
def test_launch_config_covers_k_and_fills_the_card(m, n, k):
    block_m, splits, k_per_split = launch_config(m, n, k, sms=132)
    assert block_m == (16 if m <= 16 else 64)
    assert k_per_split % fused_dense.BLOCK_K == 0
    # every K index in exactly one split, no empty split
    assert (splits - 1) * k_per_split < k <= splits * k_per_split
    tiles = -(-m // block_m) * -(-n // fused_dense.BLOCK_N)
    chunks = -(-k // fused_dense.BLOCK_K)
    assert tiles * splits >= min(132, tiles * chunks)


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
@pytest.mark.parametrize("shape", [(8, 3136, 1024), (130, 257, 70)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape, dtype):
    x, w, b = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _inputs(shape, seed=4))
    before = fused_dense.LAUNCHES
    got = fused_dense_relu(x, w, b)
    torch.cuda.synchronize()
    assert fused_dense.LAUNCHES == before + 1
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-3))
    torch.testing.assert_close(got.float(),
                               fused_dense_relu_reference(x, w, b).float(),
                               **tol)
