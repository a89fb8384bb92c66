"""The port's DeepCNN against the JAX package's, at the full width.

JAX initializes the parameters; ``params_from_jax`` carries them into the
port's module; both forward the same numpy batch of 4. With ``use_pallas``
the JAX side runs the Pallas kernel in interpret mode and the port its
kernel's plain version (CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu_torch.data import synthetic_digits
from distributed_tensorflow_tpu_torch.models import DeepCNN, get_model
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_from_jax,
    params_to_numpy,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxDeepCNN().init(jax.random.key(0)))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_logits_match_jax(jax_params, use_pallas, bf16):
    x, _ = synthetic_digits(4, seed=3)
    jm = JaxDeepCNN(compute_dtype=jnp.bfloat16 if bf16 else None,
                    use_pallas=use_pallas)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, jax_params),
                               jnp.asarray(x)))
    tm = DeepCNN(compute_dtype=torch.bfloat16 if bf16 else None,
                 use_pallas=use_pallas)
    tm.load_state_dict(params_from_jax(jax_params))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    # f32: reordered float32 sums. bf16: the two frameworks round the
    # bfloat16 conv and matmul results at different places, and the
    # logits are themselves rounded to bfloat16 (2**-7 relative)
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_params_roundtrip_and_names(jax_params):
    tm = DeepCNN()
    tm.load_state_dict(params_from_jax(jax_params))
    back = params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(jax_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, b)
    n_jax = sum(a.size for a in jax.tree.leaves(jax_params))
    assert tm.num_params() == n_jax == 3274634


def test_init_is_reference_truncated_normal():
    m = get_model("deep_cnn").init(torch.Generator().manual_seed(0))
    for name, p in m.weights.items():
        assert p.abs().max() <= 0.2, name  # truncated at 2 sigma
    assert 0.07 < m.weights["wd1"].std() < 0.1  # sigma 0.1, truncated
    for p in m.biases.values():
        assert torch.all(p == 0.1)
    again = DeepCNN().init(torch.Generator().manual_seed(0))
    assert torch.equal(again.weights["wd1"], m.weights["wd1"])


def test_flatten_is_nhwc_order(jax_params):
    """wd1's rows are in (H, W, C) order: a permuted NCHW flatten would
    still run and give other logits, so pin one hidden unit by hand."""
    tm = DeepCNN()
    tm.load_state_dict(params_from_jax(jax_params))
    x = torch.from_numpy(synthetic_digits(1, seed=5)[0])
    with torch.inference_mode():
        h = x.reshape(-1, 28, 28, 1)
        from distributed_tensorflow_tpu_torch.ops import nn as ops

        for wk, bk in (("wc1", "bc1"), ("wc2", "bc2")):
            h = ops.maxpool2d(ops.conv2d(h, tm.weights[wk], tm.biases[bk]))
        unit0 = (h[0].reshape(-1) @ tm.weights["wd1"][:, 0]
                 + tm.biases["bd1"][0])
        # the same unit from an explicit (h, w, c) index walk
        manual = sum(h[0, i, j, c] * tm.weights["wd1"][(i * 7 + j) * 64 + c, 0]
                     for i in range(7) for j in range(7) for c in range(64))
    torch.testing.assert_close(unit0, manual + tm.biases["bd1"][0],
                               rtol=1e-4, atol=1e-4)
