"""The port's attention and streamed loss head against the JAX package's.

The same numpy-seeded inputs go through ``multi_head_attention``,
``blockwise_attention`` (the flash forward and its recomputing backward)
and ``streamed_softmax_ce_head`` in both packages, float32 on the CPU:
values and gradients at rtol 1e-4 (atol 1e-6 for entries near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu.ops import nn as jnn
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops import nn as tnn

TOL = dict(rtol=1e-4, atol=1e-6)


def _qkvg(seed, b=2, s=16, h=2, dh=8):
    r = np.random.default_rng(seed)
    return [r.standard_normal((b, s, h, dh)).astype(np.float32)
            for _ in range(4)]


def _jax_vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(out)] + [np.asarray(a) for a in vjp(jnp.asarray(g))]


def _torch_vjp(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [None, 4, 16])
def test_attention_values_and_grads_match_jax(causal, block):
    """Dense (block None) and blockwise attention: out, dq, dk, dv."""
    q, k, v, g = _qkvg(seed=1 + 2 * causal)
    if block is None:
        def jf(q, k, v):
            return jattn.multi_head_attention(q, k, v, causal=causal)

        def tf(q, k, v):
            return tattn.multi_head_attention(q, k, v, causal=causal)
    else:
        def jf(q, k, v):
            return jattn.blockwise_attention(q, k, v, block, causal=causal)

        def tf(q, k, v):
            return tattn.blockwise_attention(q, k, v, block, causal=causal)
    want = _jax_vjp(jf, (q, k, v), g)
    got = _torch_vjp(tf, (q, k, v), g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


def test_blockwise_equals_dense_in_the_port_and_keeps_bf16():
    q, k, v, g = _qkvg(seed=5)
    dense = _torch_vjp(lambda *a: tattn.multi_head_attention(
        *a, causal=True), (q, k, v), g)
    flash = _torch_vjp(lambda *a: tattn.blockwise_attention(
        *a, 8, causal=True), (q, k, v), g)
    for a, b in zip(flash, dense):
        np.testing.assert_allclose(a, b, **TOL)
    qb, kb, vb = (torch.from_numpy(a).bfloat16().requires_grad_()
                  for a in (q, k, v))
    out = tattn.blockwise_attention(qb, kb, vb, 8, causal=True)
    out.float().sum().backward()
    assert out.dtype == qb.grad.dtype == kb.grad.dtype == torch.bfloat16


def test_blockwise_rejects_ragged_blocks():
    q = torch.zeros((1, 12, 1, 4))
    with pytest.raises(ValueError, match="divide"):
        tattn.blockwise_attention(q, q, q, 5)


def _head_inputs(seed, n, d=8, vocab=11, bad=()):
    r = np.random.default_rng(seed)
    h = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal((d, vocab)) * 0.5).astype(np.float32)
    b = (r.standard_normal(vocab) * 0.1).astype(np.float32)
    y = r.integers(0, vocab, n).astype(np.int32)
    for i in bad:
        y[i] = vocab + i  # out of range: zero loss and grad, a miss
    return h, w, b, y


def _jax_head(h, w, b, y, block):
    def f(h, w, b):
        return jnn.streamed_softmax_ce_head(h, w, b, jnp.asarray(y), block)

    (loss, acc), vjp = jax.vjp(f, *map(jnp.asarray, (h, w, b)))
    grads = vjp((jnp.float32(1.0), jnp.float32(0.0)))
    return [np.asarray(loss), np.asarray(acc)] + [np.asarray(x)
                                                  for x in grads]


def _torch_head(h, w, b, y, block):
    ts = [torch.from_numpy(a).requires_grad_() for a in (h, w, b)]
    if block is None:
        logits = tnn.dense(ts[0], ts[1], ts[2])
        yt = torch.from_numpy(y)
        loss, acc = tnn.softmax_cross_entropy(logits, yt), \
            tnn.accuracy(logits, yt)
    else:
        loss, acc = tnn.streamed_softmax_ce_head(*ts, torch.from_numpy(y),
                                                 block)
    grads = torch.autograd.grad(loss, ts)
    return [loss.detach().numpy(), acc.numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("n,block,bad", [
    (32, 8, ()),          # rows divide into blocks
    (30, 8, ()),          # 2 rows of padding
    (30, 8, (3, 17)),     # padding and out-of-range labels
    (12, 64, (0,)),       # one block, mostly padding
])
def test_streamed_head_matches_jax(n, block, bad):
    """loss, accuracy, dh, dw, db; and the unstreamed head of the port
    (dense + softmax_cross_entropy + accuracy) on the same inputs."""
    args = _head_inputs(seed=n + len(bad), n=n, bad=bad)
    want = _jax_head(*args, block)
    got = _torch_head(*args, block)
    plain = _torch_head(*args, None)
    for name, a, b, c in zip(("loss", "acc", "dh", "dw", "db"), got, want,
                             plain):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)
        np.testing.assert_allclose(a, c, **TOL, err_msg=name)
    for i in bad:
        assert not got[2][i].any()  # an out-of-range row has no gradient


def test_streamed_head_bf16_matches_jax():
    """compute_dtype bf16: the dot in bf16, cast back, then float32, in
    both packages: within 2e-2 of each output's scale."""
    h, w, b, y = _head_inputs(seed=9, n=24)
    (jl, ja), vjp = jax.vjp(
        lambda h, w, b: jnn.streamed_softmax_ce_head(
            h, w, b, jnp.asarray(y), 8, compute_dtype=jnp.bfloat16),
        *map(jnp.asarray, (h, w, b)))
    want = [np.asarray(jl)] + [np.asarray(x) for x in vjp(
        (jnp.float32(1.0), jnp.float32(0.0)))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (h, w, b)]
    loss, acc = tnn.streamed_softmax_ce_head(
        *ts, torch.from_numpy(y), 8, compute_dtype=torch.bfloat16)
    got = [loss.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(loss, ts)]
    for a, b_ in zip(got, want):
        assert np.abs(a - b_).max() <= 2e-2 * np.abs(b_).max()
    np.testing.assert_allclose(float(acc), float(ja), rtol=1e-6)


def test_token_labels_in_loss_and_accuracy_match_jax():
    """(B, S) integer labels against (B, S, V) logits."""
    r = np.random.default_rng(4)
    logits = r.standard_normal((3, 5, 7)).astype(np.float32)
    y = r.integers(0, 7, (3, 5)).astype(np.int32)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(y)
    np.testing.assert_allclose(
        tnn.softmax_cross_entropy(tl, ty).numpy(),
        np.asarray(jnn.softmax_cross_entropy(logits, y)), **TOL)
    np.testing.assert_allclose(float(tnn.accuracy(tl, ty)),
                               float(jnn.accuracy(logits, y)), rtol=1e-6)
