"""The port's train state, optimizers, schedules and train step against the
JAX package's, on the same numpy-seeded inputs (CPU).

Elementwise float32 arithmetic is compared at rtol 1e-6 (atol 1e-9): the
two frameworks may round pow, sqrt and cos one ulp apart. The global norm
is a float32 sum taken in another order: rtol 1e-6. Trajectory tolerances
are stated beside them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.training import schedules as jsched
from distributed_tensorflow_tpu.training import train_state as jts
from distributed_tensorflow_tpu_torch.data import synthetic_digits
from distributed_tensorflow_tpu_torch.models import DeepCNN
from distributed_tensorflow_tpu_torch.training import schedules as tsched
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_from_jax,
    params_to_numpy,
    tree_leaves,
    tree_map,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

ELEMENTWISE = dict(rtol=1e-6, atol=1e-9)


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"weights": {"a": (r.standard_normal((7, 5)) * scale).astype(np.float32),
                        "b": (r.standard_normal((3, 2, 4)) * scale).astype(np.float32)},
            "biases": {"a": (r.standard_normal(5) * scale).astype(np.float32)}}


def _np(tree):
    return tree_map(lambda t: np.asarray(t), tree)


def _assert_trees_close(got, want, **tol):
    for a, b in zip(tree_leaves(_np(got)), tree_leaves(_np(want))):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("scheduled", [False, True])
def test_optimizer_updates_match_jax(name, wd, scheduled):
    lr = jsched.get_schedule("cosine", 0.05, 10) if scheduled else 0.05
    tlr = tsched.get_schedule("cosine", 0.05, 10) if scheduled else 0.05
    jopt = jts.get_optimizer(name, lr, weight_decay=wd)
    topt = tts.get_optimizer(name, tlr, weight_decay=wd)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jst, tst = jopt.init(jp), topt.init(tp)
    for step in range(3):  # adam's t reaches 3; the velocity accumulates
        grads = _tree(10 + step, scale=0.1)
        ju, jst = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                              jnp.asarray(step, jnp.int32))
        tu, tst = topt.update(tree_map(torch.from_numpy, grads), tst, tp,
                              torch.tensor(step, dtype=torch.int32))
        _assert_trees_close(tu, ju, **ELEMENTWISE)
        jp = jts.apply_updates(jp, ju)
        tp = tts.apply_updates(tp, tu)
        _assert_trees_close(tp, jp, **ELEMENTWISE)
    if name == "sgd":
        assert tst == jst == ()
    elif name == "momentum":  # the bare velocity tree
        _assert_trees_close(tst, jst, **ELEMENTWISE)
    else:
        assert tst["t"].dtype == torch.int32 and int(tst["t"]) == 3
        _assert_trees_close(tst["m"], jst["m"], **ELEMENTWISE)
        _assert_trees_close(tst["v"], jst["v"], **ELEMENTWISE)


def test_adam_scale_is_float32():
    """lr * sqrt(1 - b2**t) / (1 - b1**t) in float32, as the JAX package
    takes it: a float64 scale would differ in the last bits."""
    g = {"w": np.full(4, 0.3, np.float32)}
    jopt, topt = jts.adam(1e-3), tts.adam(1e-3)
    ju, _ = jopt.update({"w": jnp.asarray(g["w"])},
                        jopt.init({"w": jnp.zeros(4)}), None)
    tu, _ = topt.update({"w": torch.from_numpy(g["w"])},
                        topt.init({"w": torch.zeros(4)}), None)
    np.testing.assert_array_equal(tu["w"].numpy(), np.asarray(ju["w"]))


@pytest.mark.parametrize("name", ["constant", "cosine", "linear",
                                  "exponential"])
@pytest.mark.parametrize("warmup", [0, 4])
def test_schedules_match_jax(name, warmup):
    kw = dict(warmup_steps=warmup, decay_rate=0.9)
    js = jsched.get_schedule(name, 0.1, 20, **kw)
    ts = tsched.get_schedule(name, 0.1, 20, **kw)
    if name == "constant" and not warmup:
        assert js == ts == 0.1
        return
    for step in (0, 1, 3, 4, 5, 10, 19, 20, 24, 50):
        want = float(js(jnp.asarray(step, jnp.int32)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, **ELEMENTWISE)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    grads = _tree(3)
    want = jts.clip_by_global_norm(max_norm)(
        jax.tree.map(jnp.asarray, grads))
    got = tts.clip_by_global_norm(max_norm)(
        tree_map(torch.from_numpy, grads))
    _assert_trees_close(got, want, rtol=1e-6, atol=1e-9)


def test_train_state_keys_and_dtypes_match_jax():
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    j = jflat(jts.create_train_state(JaxDeepCNN(), jts.adam(1e-3), seed=0))
    t = flatten_pytree(tts.create_train_state(DeepCNN(), tts.adam(1e-3),
                                              seed=0))
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k


def _batches(n_steps, batch):
    x, y = synthetic_digits(n_steps * batch, seed=5)
    yo = np.eye(10, dtype=np.float32)[y]
    return [(x[i * batch:(i + 1) * batch], yo[i * batch:(i + 1) * batch])
            for i in range(n_steps)]


@pytest.mark.parametrize("name,lr,use_pallas", [("sgd", 1e-3, True),
                                                ("adam", 1e-3, True),
                                                ("momentum", 1e-3, False)])
def test_trajectory_matches_jax_at_full_width(name, lr, use_pallas):
    """5 steps of the full-width deep CNN, batch 8, keep_prob 1, from JAX's
    init; with use_pallas the JAX side runs the Pallas kernel in interpret
    mode and the port its kernel's plain version."""
    jm = JaxDeepCNN(use_pallas=use_pallas)
    jopt = jts.get_optimizer(name, lr)
    js = jts.create_train_state(jm, jopt, seed=0)
    jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False)
    tm = DeepCNN(use_pallas=use_pallas)
    topt = tts.get_optimizer(name, lr)
    ts = tts.create_train_state(tm, topt, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, js.params)))
    tstep = tts.make_train_step(tm, topt, keep_prob=1.0)
    for b in _batches(5, 8):
        js, jm_ = jstep(js, tuple(map(jnp.asarray, b)))
        ts, tm_ = tstep(ts, tuple(map(torch.from_numpy, b)))
        # reordered float32 sums through conv, matmul and softmax,
        # compounded over the steps: rtol 1e-4
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        assert float(tm_["accuracy"]) == float(jm_["accuracy"])
    assert int(ts.step) == int(js.step) == 5
    got = params_to_numpy(tm)
    want = jax.tree.map(np.asarray, js.params)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = np.abs(a - b)
        if name == "adam":
            # adam divides each gradient by its own RMS, so a weight whose
            # gradient is summation noise moves by up to lr per step in
            # either direction: at most 1 in 10^4 entries past 1e-5, and
            # none past 2 lr per step
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 10 * lr
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("accum", [1, 2])
def test_accumulated_step_matches_jax(accum):
    """--accum_steps: microbatch gradients averaged before one update."""
    jm, tm = JaxDeepCNN(), DeepCNN()
    jopt, topt = jts.sgd(0.01), tts.sgd(0.01)
    js = jts.create_train_state(jm, jopt, seed=1)
    ts = tts.create_train_state(tm, topt, seed=1)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, js.params)))
    b = _batches(1, 8)[0]
    js, jm_ = jts.make_train_step(jm, jopt, accum_steps=accum, donate=False)(
        js, tuple(map(jnp.asarray, b)))
    ts, tm_ = tts.make_train_step(tm, topt, accum_steps=accum)(
        ts, tuple(map(torch.from_numpy, b)))
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    for a, b_ in zip(tree_leaves(params_to_numpy(tm)),
                     tree_leaves(jax.tree.map(np.asarray, js.params))):
        np.testing.assert_allclose(a, b_, rtol=1e-4, atol=1e-6)


def test_dropout_draws_from_key_and_step():
    """The dropout masks are a function of (key, step): the same state
    gives the same step, another step another mask. They are not JAX's
    threefry masks, so no test compares them with JAX."""
    tm = DeepCNN()
    opt = tts.sgd(0.0)  # no update: only the masks differ between steps
    ts = tts.create_train_state(tm, opt, seed=0)
    step = tts.make_train_step(tm, opt, keep_prob=0.5)
    b = tuple(map(torch.from_numpy, _batches(1, 8)[0]))
    _, m0 = step(ts, b)
    _, m0_again = step(ts, b)
    _, m1 = step(ts._replace(step=ts.step + 1), b)
    assert float(m0["loss"]) == float(m0_again["loss"])
    assert float(m0["loss"]) != float(m1["loss"])
    assert tts.dropout_seed(ts.rng, 3) != tts.dropout_seed(ts.rng, 4)


def test_evaluate_matches_jax():
    from distributed_tensorflow_tpu.data.datasets import DataSet as JDataSet
    from distributed_tensorflow_tpu_torch.data import DataSet

    x, y = synthetic_digits(1300, seed=9)
    jm, tm = JaxDeepCNN(), DeepCNN()
    jp = jm.init(jax.random.key(2))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    want = jts.evaluate(jm, jp, JDataSet(x, y), batch_size=500)
    got = tts.evaluate(tm, DataSet(x, y), batch_size=500)
    assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-7)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
