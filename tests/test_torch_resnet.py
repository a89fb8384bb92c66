"""The port's batch norm, SAME conv, ResNet and MLP against the JAX
package's, on the same numpy-seeded inputs (CPU), at ResNet-20's
published widths (16/32/64, n = 3).

JAX initializes the variables; ``params_from_jax`` carries the
``{"params", "state"}`` tree into the port's parameters and batch-norm
buffers. Tolerances, beside each check: batch norm at rtol 1e-5 in f32
(a reordered float32 mean and variance); the ResNet's f32 logits and
state at rtol 1e-4 (the same through 19 convs), its f32 gradients at
1e-4 of each leaf's largest magnitude; bf16 logits within 2e-2 of the
logits' largest magnitude (the two frameworks round the bfloat16 convs
at different places, and the error scales with the logits, not each
logit); the MLP at rtol 1e-5.

The 5-step trajectories run in float64 in both frameworks (JAX under
``jax.enable_x64``, the port's module ``.double()``), at rtol 1e-4. In
float32 they are not comparable entry by entry: train-mode batch norm
at batch 8 subtracts the batch mean of the gradient, and where the
examples' features are alike (uniform noise, or these textures once the
batch norms have moved) the early stages' gradients are a small
difference of large terms. There each framework's own float32 gradient
differs from its float64 one by up to 1e-2 of the leaf's scale, and a
few adam steps turn that into parameters apart by a learning rate. The
float32 losses of the same steps agree at rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distributed_tensorflow_tpu.models.mlp import MLP as JaxMLP
from distributed_tensorflow_tpu.models.resnet import ResNet as JaxResNet
from distributed_tensorflow_tpu.ops import nn as jnn
from distributed_tensorflow_tpu.training import train_state as jts
from distributed_tensorflow_tpu_torch.data import synthetic_cifar
from distributed_tensorflow_tpu_torch.models import MLP, ResNet, get_model
from distributed_tensorflow_tpu_torch.ops import nn as tnn
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_from_jax,
    params_to_numpy,
    state_to_numpy,
    tree_leaves,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

BN_F32 = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=1e-4, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(8, 8, 8, 64), (4, 32, 32, 16)])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(shape, train):
    """Forward, input gradient and running stats. (8, 8, 8, 64) is the
    last stage's maps at batch 8, where the unbiased variance of
    ``F.batch_norm`` would be 512/511 of the biased one."""
    r = _rng(sum(shape))
    c = shape[-1]
    x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = r.uniform(0.5, 1.5, c).astype(np.float32)
    bias = r.standard_normal(c).astype(np.float32)
    mean = (r.standard_normal(c) * 0.1).astype(np.float32)
    var = r.uniform(0.5, 1.5, c).astype(np.float32)
    g = r.standard_normal(shape).astype(np.float32)

    def jf(x_):
        y, st = jnn.batch_norm(x_, jnp.asarray(scale), jnp.asarray(bias),
                               jnp.asarray(mean), jnp.asarray(var),
                               train=train, momentum=0.9)
        return jnp.sum(y * g), (y, st)

    (_, (jy, (jm, jv))), jdx = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty, (tm, tv) = tnn.batch_norm(
        tx, torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean), torch.from_numpy(var), train=train,
        momentum=0.9)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **BN_F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **BN_F32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    assert not tm.requires_grad and not tv.requires_grad
    if not train:  # eval passes the running stats through
        np.testing.assert_array_equal(tm.numpy(), mean)
        np.testing.assert_array_equal(tv.numpy(), var)


def test_batch_norm_bf16_input_keeps_the_jax_dtype_chain():
    """A bfloat16 input (the stem's conv output on uint8 batches) gives
    bfloat16 batch stats and a float32 output through ``* scale``."""
    r = _rng(5)
    x = r.standard_normal((4, 8, 8, 16)).astype(np.float32)
    p = [np.ones(16, np.float32), np.zeros(16, np.float32),
         np.zeros(16, np.float32), np.ones(16, np.float32)]
    jy, (jm, jv) = jnn.batch_norm(jnp.asarray(x, jnp.bfloat16),
                                  *map(jnp.asarray, p), train=True)
    ty, (tm, tv) = tnn.batch_norm(torch.from_numpy(x).bfloat16(),
                                  *map(torch.from_numpy, p), train=True)
    assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
    assert tm.dtype == torch.float32 and jm.dtype == jnp.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-2)


@pytest.mark.parametrize("hw,k,stride", [(32, 3, 2), (32, 1, 2), (16, 3, 1),
                                         (9, 3, 2)])
def test_bare_conv_pads_as_xla_same(hw, k, stride):
    """At stride 2 XLA's SAME pads a 3x3 kernel over 32 by (0, 1): a
    symmetric padding=1 would shift every map of stages 1 and 2."""
    r = _rng(hw + k)
    x = r.standard_normal((2, hw, hw, 4)).astype(np.float32)
    w = r.standard_normal((k, k, 4, 8)).astype(np.float32)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tnn.conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def jax_variables():
    """ResNet-20 variables from JAX's init, with the zero head, the batch
    norms' parameters and the running stats made nonzero, so that every
    path of the forward and backward carries signal."""
    v = _np(JaxResNet().init(jax.random.PRNGKey(0)))
    r = _rng(1)
    v["params"]["head"]["w"] = (r.standard_normal((64, 10)) * 0.1).astype(
        np.float32)
    v["params"]["head"]["b"] = (r.standard_normal(10) * 0.1).astype(
        np.float32)

    def perturb(tree, key):
        for k, sub in tree.items():
            if isinstance(sub, dict):
                perturb(sub, key)
            elif k == "scale":
                tree[k] = r.uniform(0.8, 1.2, sub.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                tree[k] = (r.standard_normal(sub.shape) * 0.1).astype(
                    np.float32)
            elif k == "var":
                tree[k] = r.uniform(0.5, 1.5, sub.shape).astype(np.float32)

    perturb(v["params"], "params")
    perturb(v["state"], "state")
    return v


def _port(v, compute_dtype=None):
    m = ResNet(compute_dtype=compute_dtype)
    m.load_state_dict(params_from_jax(v))
    return m


def _batch(n=8, seed=3):
    x, y = synthetic_cifar(n, seed=seed)
    return x, np.eye(10, dtype=np.float32)[y]


@pytest.mark.parametrize("train", [False, True])
def test_resnet20_logits_and_state_match_jax(jax_variables, train):
    x, _ = _batch()
    out = JaxResNet().apply(jax.tree.map(jnp.asarray, jax_variables),
                            jnp.asarray(x), train=train)
    want, want_state = (out if train else (out, jax_variables["state"]))
    tm = _port(jax_variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    got_state = state_to_numpy(tm)
    assert jax.tree.structure(got_state) == jax.tree.structure(
        _np(want_state))
    for a, b in zip(jax.tree.leaves(got_state),
                    jax.tree.leaves(_np(want_state))):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_resnet20_bf16_logits_match_jax(jax_variables, u8, train):
    """Float32 batches (host-fed) and uint8 batches (device-resident,
    normalized straight to bfloat16, so the stem's batch norm sees a
    bfloat16 input): two dtype chains."""
    x, _ = _batch()
    if u8:
        x = np.round(x * 255).astype(np.uint8)
    out = JaxResNet(compute_dtype=jnp.bfloat16).apply(
        jax.tree.map(jnp.asarray, jax_variables), jnp.asarray(x),
        train=train)
    want = np.asarray(out[0] if train else out)
    tm = _port(jax_variables, torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train=train).numpy()
    assert got.dtype == np.float32
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 2e-2 * scale


def test_resnet20_gradients_match_jax():
    """Gradients in float32 at JAX's init with a random head (a zero head
    passes no gradient to the body): within 1e-4 of each leaf's largest
    magnitude."""
    v = _np(JaxResNet().init(jax.random.PRNGKey(2)))
    v["params"]["head"]["w"] = (_rng(2).standard_normal((64, 10))
                                * 0.1).astype(np.float32)
    x, y = _batch()
    jm = JaxResNet()

    def loss(params):
        logits, _ = jm.apply(params, jnp.asarray(x), train=True,
                             state=jax.tree.map(jnp.asarray, v["state"]))
        return jnn.softmax_cross_entropy(logits, jnp.asarray(y))

    want = _np(jax.grad(loss)(jax.tree.map(jnp.asarray, v["params"])))
    tm = _port(v)
    grads, _, _ = tts.compute_grads(
        tm, tts.params_of(tm), (torch.from_numpy(x), torch.from_numpy(y)),
        keep_prob=1.0, rng=None, model_state=tts.state_of(tm))
    got = jax.tree.map(lambda t: t.numpy(), grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.abs(b).max() > 0
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("name,n", [("resnet20", 3), ("resnet32", 5)])
def test_parameter_counts_and_names_match_jax(name, n):
    jm = JaxResNet(blocks_per_stage=n)
    v = _np(jm.init(jax.random.PRNGKey(1)))
    tm = get_model(name)
    assert tm.num_params() == jm.num_params() == {3: 272474, 5: 466906}[n]
    tm.load_state_dict(params_from_jax(v))
    back = params_to_numpy(tm)
    assert jax.tree.structure(back) == jax.tree.structure(v["params"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v["params"])):
        np.testing.assert_array_equal(a, b)
    state = state_to_numpy(tm)
    assert jax.tree.structure(state) == jax.tree.structure(v["state"])
    # the port's own init: He-normal convs, zero head, unit batch norms
    tm.init(torch.Generator().manual_seed(0))
    assert torch.all(tm.head.w == 0) and torch.all(tm.stem.bn.var == 1)
    std = float(tm.stage2.block2.conv2.std())
    assert 0.8 < std / (2.0 / (9 * 64)) ** 0.5 < 1.2


def test_state_of_is_the_modules_buffers_and_others_are_refused():
    tm = ResNet().init(torch.Generator().manual_seed(0))
    st = tts.state_of(tm)
    assert st["stem"]["bn"]["mean"] is tm.stem.bn.mean
    assert sorted(st["stage1"]["block0"]) == ["bn1", "bn2", "proj_bn"]
    x = torch.from_numpy(_batch(4)[0])
    y = torch.zeros(4, dtype=torch.int64)
    copy = jax.tree.map(lambda t: t.clone(), st)
    with pytest.raises(ValueError, match="own buffers"):
        tts.loss_and_metrics(tm, (x, y), train=True, model_state=copy)
    before = tm.stem.bn.mean.clone()
    tts.loss_and_metrics(tm, (x, y), train=True, model_state=st)
    assert not torch.equal(before, tm.stem.bn.mean)  # moved in place
    assert tts.state_of(MLP()) == ()


def test_mlp_logits_match_jax():
    jm = JaxMLP(image_size=32, channels=3, hidden_units=100)
    p = _np(jm.init(jax.random.key(0)))
    x, _ = _batch(6)
    want = np.asarray(jm.apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tm = MLP(image_size=32, channels=3, hidden_units=100)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert tm.num_params() == jm.num_params()
    init = MLP().init(torch.Generator().manual_seed(0))
    assert init.weights["h1"].abs().max() <= 0.2
    assert torch.all(init.biases["out"] == 0.1)


def _fed_batches(steps, batch):
    x, y = synthetic_cifar(steps * batch, seed=11)
    yo = np.eye(10, dtype=np.float32)[y]
    return [(x[i * batch:(i + 1) * batch], yo[i * batch:(i + 1) * batch])
            for i in range(steps)]


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("name,lr,accum", [("adam", 1e-3, 1),
                                           ("momentum", 0.05, 1),
                                           ("momentum", 0.05, 2)])
def test_trajectory_matches_jax(name, lr, accum):
    """5 steps of ResNet-20 on fed batches of 8, keep_prob 1, from JAX's
    init, in float64 (see the module's docstring): losses, parameters and
    batch-norm state at rtol 1e-4. With accumulation the state threads
    through the two microbatches in order."""
    jm = JaxResNet()
    batches = [tuple(a.astype(np.float64) for a in b)
               for b in _fed_batches(5, 8)]
    with jax.enable_x64(True):
        jopt = jts.get_optimizer(name, lr)
        js = jts.create_train_state(jm, jopt, seed=0)
        js = js._replace(params=_f64(js.params),
                         model_state=_f64(js.model_state))
        js = js._replace(opt_state=jopt.init(js.params))
        init = {"params": _np(js.params), "state": _np(js.model_state)}
        jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False,
                                    accum_steps=accum)
        jlosses = []
        for b in batches:
            js, jmet = jstep(js, tuple(map(jnp.asarray, b)))
            jlosses.append(float(jmet["loss"]))
        jparams, jstate = _np(js.params), _np(js.model_state)
    tm = ResNet().double()
    topt = tts.get_optimizer(name, lr)
    ts = tts.create_train_state(tm, topt, seed=0)
    tm.load_state_dict(params_from_jax(init))
    tstep = tts.make_train_step(tm, topt, keep_prob=1.0, accum_steps=accum)
    tlosses = []
    for b in batches:
        ts, tmet = tstep(ts, tuple(map(torch.from_numpy, b)))
        tlosses.append(float(tmet["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert int(ts.step) == 5
    assert ts.model_state != () and all(
        a is b for a, b in zip(tree_leaves(ts.model_state),
                               tree_leaves(tts.state_of(tm))))
    got = params_to_numpy(tm)
    assert jax.tree.structure(got) == jax.tree.structure(jparams)
    for a, b in zip(tree_leaves(got), tree_leaves(jparams)):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(tree_leaves(state_to_numpy(tm)), tree_leaves(jstate)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
