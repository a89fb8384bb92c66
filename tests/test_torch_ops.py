"""The port's ops/nn.py against the JAX package's, on the same numpy
inputs. f32 tolerances cover a reordered float32 sum; bf16 ones cover two
frameworks rounding the same bfloat16 products at different places."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import nn as jnn
from distributed_tensorflow_tpu_torch.ops import nn as tnn

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

_F32 = dict(rtol=1e-5, atol=1e-5)
_BF16 = dict(rtol=2e-2, atol=2e-2)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("hw,cin,cout,stride,bf16", [
    (28, 1, 32, 1, False), (14, 32, 64, 1, False), (9, 3, 8, 2, False),
    (14, 32, 64, 1, True)])
def test_conv2d_matches_jax(hw, cin, cout, stride, bf16):
    r = _rng(hw + cin)
    x = r.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (r.standard_normal((5, 5, cin, cout)) * 0.1).astype(np.float32)
    b = (r.standard_normal(cout) * 0.1).astype(np.float32)
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      stride, compute_dtype=jnp.bfloat16 if bf16 else None)
    got = tnn.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride,
                     compute_dtype=torch.bfloat16 if bf16 else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(_BF16 if bf16 else _F32))


@pytest.mark.parametrize("hw", [28, 7, 5])
def test_maxpool2d_matches_jax_including_odd_sizes(hw):
    # odd sizes pad the end with -inf (SAME): 7 -> 4, 5 -> 3
    x = _rng(hw).standard_normal((2, hw, hw, 3)).astype(np.float32) - 5.0
    want = np.asarray(jnn.maxpool2d(jnp.asarray(x), k=2))
    got = tnn.maxpool2d(torch.from_numpy(x), k=2).numpy()
    assert got.shape == want.shape == (2, -(-hw // 2), -(-hw // 2), 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_matches_jax(bf16):
    r = _rng(7)
    x = r.standard_normal((4, 96)).astype(np.float32)
    w = (r.standard_normal((96, 10)) * 0.1).astype(np.float32)
    b = r.standard_normal(10).astype(np.float32)
    cd = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    want = jnn.dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     compute_dtype=cd[0])
    got = tnn.dense(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), compute_dtype=cd[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(_BF16 if bf16 else _F32))


def test_normalize_if_u8_matches_jax():
    u8 = _rng(8).integers(0, 256, (3, 784), dtype=np.uint8)
    np.testing.assert_allclose(
        tnn.normalize_if_u8(torch.from_numpy(u8)).numpy(),
        np.asarray(jnn.normalize_if_u8(jnp.asarray(u8))), rtol=1e-6)
    f = torch.rand(3, 4)
    assert tnn.normalize_if_u8(f) is f  # floats pass through


def test_dropout_eval_is_identity_and_train_scales():
    x = torch.ones(64, 64)
    assert tnn.dropout(x, 0.5, None) is x
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(x, 0.5, g)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.count_nonzero(tnn.dropout(x, 0.0, g)) == 0


@pytest.mark.parametrize("int_labels", [False, True])
def test_loss_and_accuracy_match_jax(int_labels):
    r = _rng(11)
    logits = (r.standard_normal((16, 10)) * 3).astype(np.float32)
    ids = r.integers(0, 10, 16)
    labels = ids if int_labels else np.eye(10, dtype=np.float32)[ids]
    want_loss = jnn.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels))
    want_acc = jnn.accuracy(jnp.asarray(logits), jnp.asarray(labels))
    got_loss = tnn.softmax_cross_entropy(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    got_acc = tnn.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **_F32)
    assert got_acc.item() == float(want_acc)


def test_out_of_range_id_gives_zero_loss_and_gradient():
    logits = torch.tensor([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]],
                          requires_grad=True)
    labels = torch.tensor([1, 7], dtype=torch.int32)  # 7: no such class
    loss = tnn.softmax_cross_entropy(logits, labels)
    want = jnn.softmax_cross_entropy(jnp.asarray(logits.detach().numpy()),
                                     jnp.asarray(labels.numpy()))
    np.testing.assert_allclose(loss.item(), float(want), **_F32)
    loss.backward()
    assert torch.all(logits.grad[1] == 0)


def test_minus_inf_logit_is_not_nan():
    logits = torch.tensor([[0.0, -math.inf, 1.0]])
    loss = tnn.softmax_cross_entropy(logits, torch.tensor([2]))
    assert torch.isfinite(loss)
    np.testing.assert_allclose(
        loss.item(), float(jnn.softmax_cross_entropy(
            jnp.asarray(logits.numpy()), jnp.asarray([2]))), **_F32)
