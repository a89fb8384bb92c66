"""The port's Switch MoE (``ops/moe.py``) and the MoE ``TransformerLM``
against the JAX package's, on the CPU.

``switch_moe``: expert ids first (inputs drawn so every token's top-2
router probabilities differ by at least 1e-3, far above float32 noise,
so both argmaxes must agree), then the output, ``lb_loss``,
``dropped_frac`` and the gradients of every leaf (router, w1, b1, w2, b2
and h) at rtol 1e-5 and an absolute floor of 1e-6 of each array's
scale (max |value|, here 1-20) for entries that cancel to near zero
(reordered float32 sums), with and without dropped tokens, and the
overflow
and first-arrival cases of ``tests/test_moe.py``. The MoE LM: logits,
``loss_with_metrics`` in train and eval mode and the gradients from the
JAX package's parameters carried over, a 5-step adam trajectory against
JAX's ``make_train_step`` at rtol 1e-4 (parameters with atol 1e-5: adam
divides by sqrt(v), so a weight whose gradient is float32 noise takes a
noise-sized step), and train states crossing both ways. f32 at the
tests' ``highest`` matmul precision; bf16 outputs within 2e-2 of their
scale, the LM's with its routers scaled so that bf16 rounding upstream
cannot flip a route. Small sizes: d 16-32, E 4, T <= 64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.models.transformer import (
    TransformerLM as JaxLM,
)
from distributed_tensorflow_tpu.ops import moe as jmoe
from distributed_tensorflow_tpu.training import train_state as jts
from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data.lm import LMDataSet
from distributed_tensorflow_tpu_torch.models import TransformerLM
from distributed_tensorflow_tpu_torch.ops import moe
from distributed_tensorflow_tpu_torch.serving import decode
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.training.loop import build_model_for
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
from distributed_tensorflow_tpu_torch.utils.pytree import (
    flatten_pytree,
    params_from_jax,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

D, E, M = 16, 4, 32
LEAVES = ("router", "w1", "b1", "w2", "b2")
MOE_KW = dict(vocab_size=16, seq_len=32, d_model=32, num_heads=2,
              num_blocks=2, moe_experts=4)
MARGIN = 1e-3


def _close(got, want, err_msg=""):
    """rtol 1e-5, and 1e-6 of ``want``'s scale for near-zero entries."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale,
                               err_msg=err_msg)


def _layer(seed, b=2, s=32, cap_bias=None):
    """(h (b, s, D), params) from numpy, every token's top-2 router
    probabilities at least ``MARGIN`` apart; ``cap_bias`` routes every
    token to that expert (tests/test_moe.py's overflow cases)."""
    rng = np.random.default_rng(seed)
    params = {"router": rng.normal(0, 0.5, (D, E)),
              "w1": rng.normal(0, 0.3, (E, D, M)),
              "b1": rng.normal(0, 0.1, (E, M)),
              "w2": rng.normal(0, 0.3, (E, M, D)),
              "b2": rng.normal(0, 0.1, (E, D))}
    h = rng.normal(0, 1, (b * s, D))
    if cap_bias is not None:
        params["router"] = np.zeros((D, E))
        params["router"][:, cap_bias] = 100.0
        h = np.abs(h) + 0.1
    for _ in range(100):
        z = h @ params["router"]
        p = np.exp(z - z.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        top2 = np.sort(p, -1)[:, -2:]
        close = top2[:, 1] - top2[:, 0] < MARGIN
        if not close.any():
            break
        h[close] = rng.normal(0, 1, (int(close.sum()), D))
    else:
        raise AssertionError("could not draw well-separated routes")
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(h.reshape(b, s, D)), {k: f32(v) for k, v in params.items()}


def _jax_moe(h, params, cf, cd=None):
    """JAX's output, aux, expert ids and gradients (of sum(y * ct) + 0.3
    lb_loss, ``ct`` a fixed cotangent) in one jitted call."""
    ct = np.random.default_rng(99).normal(size=h.shape).astype(np.float32)

    @jax.jit
    def f(h, p):
        def loss(h, p):
            y, aux = jmoe.switch_moe(h, p, capacity_factor=cf,
                                     compute_dtype=cd)
            obj = jnp.sum(y.astype(jnp.float32) * ct) + 0.3 * aux["lb_loss"]
            return obj, (y, aux)
        (_, (y, aux)), grads = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(h, p)
        ids = jnp.argmax(jax.nn.softmax(
            h.reshape(-1, h.shape[-1]) @ p["router"], -1), -1)
        return y, aux, ids, grads

    y, aux, ids, (gh, gp) = f(jnp.asarray(h), jax.tree.map(jnp.asarray,
                                                          params))
    return (np.asarray(y, np.float32), {k: float(v) for k, v in aux.items()},
            np.asarray(ids), np.asarray(gh), {k: np.asarray(gp[k])
                                              for k in LEAVES}, ct)


def _port_moe(h, params, cf, ct, cd=None):
    th = torch.from_numpy(h).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y, aux = moe.switch_moe(th, tp, capacity_factor=cf, compute_dtype=cd)
    obj = (y.float() * torch.from_numpy(ct)).sum() + 0.3 * aux["lb_loss"]
    grads = torch.autograd.grad(obj, [th] + [tp[k] for k in LEAVES])
    ids = torch.softmax(th.detach().reshape(-1, D) @ tp["router"].detach(),
                        -1).argmax(-1)
    return (y.detach().float().numpy(),
            {k: float(v.detach()) for k, v in aux.items()},
            ids.numpy(), grads[0].numpy(),
            {k: g.numpy() for k, g in zip(LEAVES, grads[1:])})


def test_capacity_math_equals_jax():
    for args in ((64, 4, 1.0), (64, 4, 1.25), (3, 8, 1.0), (2048, 8, 1.25),
                 (96, 4, 0.5)):
        assert moe.moe_capacity(*args) == jmoe.moe_capacity(*args)
    assert moe.moe_capacity(2048, 8, 1.25) == 320  # the bench MoE layer


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5],
                         ids=["no_drops", "default", "tight"])
def test_switch_moe_matches_jax(cf):
    h, params = _layer(seed=int(cf * 4))
    want_y, want_aux, want_ids, want_gh, want_gp, ct = _jax_moe(h, params,
                                                                cf)
    y, aux, ids, gh, gp = _port_moe(h, params, cf, ct)
    np.testing.assert_array_equal(ids, want_ids)  # routing first
    assert (aux["dropped_frac"] == 0.0) == (cf == 8.0)
    np.testing.assert_allclose(aux["dropped_frac"], want_aux["dropped_frac"],
                               rtol=1e-6)
    np.testing.assert_allclose(aux["lb_loss"], want_aux["lb_loss"], rtol=1e-5)
    _close(y, want_y)
    _close(gh, want_gh)
    for k in LEAVES:
        _close(gp[k], want_gp[k], err_msg=k)


def test_switch_moe_bf16_within_its_scale():
    h, params = _layer(seed=7)
    want_y, want_aux, want_ids, _, _, ct = _jax_moe(h, params, 1.25,
                                                    cd=jnp.bfloat16)
    y, aux, ids, _, _ = _port_moe(h, params, 1.25, ct, cd=torch.bfloat16)
    np.testing.assert_array_equal(ids, want_ids)  # the router is float32
    assert aux["dropped_frac"] == want_aux["dropped_frac"]
    np.testing.assert_allclose(aux["lb_loss"], want_aux["lb_loss"], rtol=1e-5)
    assert np.abs(y - want_y).max() <= 2e-2 * np.abs(want_y).max()


def test_overflow_drops_all_but_the_first_arrivals():
    """Every token routed to expert 2 at capacity 4 of 16 tokens: 12
    dropped, exactly the first 4 in arrival order carry output, the
    rest (and every unassigned expert's slots: JAX's one_hot(-1) rows)
    are exact zeros, as in the JAX package."""
    h, params = _layer(seed=3, b=1, s=16, cap_bias=2)
    want_y, want_aux, want_ids, want_gh, want_gp, ct = _jax_moe(h, params,
                                                                1.0)
    y, aux, ids, gh, gp = _port_moe(h, params, 1.0, ct)
    assert np.all(ids == 2) and np.all(want_ids == 2)
    assert aux["dropped_frac"] == want_aux["dropped_frac"] == 0.75
    nonzero = np.abs(y.reshape(16, D)).sum(-1) > 0
    np.testing.assert_array_equal(nonzero, np.arange(16) < 4)
    np.testing.assert_array_equal(y.reshape(16, D)[4:], 0.0)
    _close(y, want_y)
    _close(gh, want_gh)
    for k in LEAVES:
        _close(gp[k], want_gp[k], err_msg=k)


def test_expert_parallelism_and_moe_decode_are_refused():
    h, params = _layer(seed=1, b=1, s=8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        moe.switch_moe(torch.from_numpy(h), tp, axis_name="model")
    with pytest.raises(NotImplementedError, match="moe_axis"):
        TransformerLM(**MOE_KW, moe_axis="model")
    with pytest.raises(ValueError, match="MoE"):
        decode.check_decodable(TransformerLM(**MOE_KW))
    flags.define_reference_flags()
    flags.FLAGS._reset()
    try:
        flags.FLAGS._parse(["--model", "lm", "--dataset", "lm",
                            "--moe_experts", "4", "--expert_parallel"])
        meta = {"kind": "lm", "seq_len": 32, "vocab_size": 16}
        with pytest.raises(NotImplementedError, match="expert_parallel"):
            build_model_for(flags.FLAGS, meta)
        flags.FLAGS.expert_parallel = False
        model = build_model_for(flags.FLAGS, meta)
        assert (model.moe_experts, model.moe_capacity, model.moe_aux) == \
            (4, 1.25, 0.01)
        flags.FLAGS._reset()
        with pytest.raises(ValueError, match="expert_parallel"):
            flags.FLAGS._parse(["--zero", "1", "--mode", "sync",
                                "--expert_parallel"])
        flags.FLAGS._reset()
        with pytest.raises(ValueError, match="moe_capacity"):
            flags.FLAGS._parse(["--moe_capacity", "0"])
    finally:
        flags.FLAGS._reset()


# ------------------------------------------------------------- the MoE LM


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxLM(**MOE_KW).init(jax.random.key(0)))


def _batch(seed, b=2):
    return LMDataSet(8, MOE_KW["seq_len"], MOE_KW["vocab_size"],
                     seed=seed).next_batch(b)


@pytest.mark.parametrize("kwargs", [{}, {"ce_block": 24, "remat": True}],
                         ids=["dense", "ce_block_remat"])
def test_moe_lm_matches_jax(jax_params, kwargs):
    """Logits, per mode (train, eval) the loss and the metrics, and the
    training loss's gradients of every leaf, from the JAX package's
    parameters."""
    jm, tm = JaxLM(**MOE_KW, **kwargs), TransformerLM(**MOE_KW, **kwargs)
    tm.load_state_dict(params_from_jax(jax_params))
    assert tm.wants_loss_hook and jm.wants_loss_hook
    x, y = _batch(seed=1)

    @jax.jit
    def jax_side(p, x, y):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jts.loss_and_metrics(jm, p, (x, y), train=True),
            has_aux=True)(p)
        ev_loss, ev_aux = jts.loss_and_metrics(jm, p, (x, y), train=False)
        return {"logits": jm.apply(p, x),
                "True": (loss, aux["metrics"], grads),
                "False": (ev_loss, ev_aux["metrics"], None)}

    want = jax_side(jax.tree.map(jnp.asarray, jax_params), jnp.asarray(x),
                    jnp.asarray(y))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        np.testing.assert_allclose(tm(tx).numpy(), want["logits"],
                                   rtol=1e-4, atol=1e-6)
    for mode in (True, False):
        loss, aux = tts.loss_and_metrics(tm, (tx, ty), train=mode)
        wl, wm, wg = want[str(mode)]
        assert sorted(aux["metrics"]) == sorted(wm) == ["accuracy", "loss",
                                                        "moe_lb"]
        np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
        for k in wm:
            np.testing.assert_allclose(float(aux["metrics"][k]),
                                       float(wm[k]), rtol=1e-5, err_msg=k)
        # the aux term is in the training loss only
        gap = float(loss) - float(aux["metrics"]["loss"])
        want_gap = 0.01 * float(wm["moe_lb"]) if mode else 0.0
        np.testing.assert_allclose(gap, want_gap, rtol=1e-3, atol=1e-7)
        if mode:  # the training loss's gradients, the aux term's included
            grads = torch.autograd.grad(
                loss, jax.tree.leaves(tts.params_of(tm)))
            for g, w in zip(grads, jax.tree.leaves(wg)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-4, atol=1e-6)


def test_moe_lm_bf16_logits_within_their_scale(jax_params):
    """bf16 rounds at other places in the two frameworks, and at the
    init's router scale (sigma 0.02) the top-2 probabilities of many
    tokens lie within that noise; routers 100x larger route decisively,
    so the comparison is of the arithmetic, not of a flipped route."""
    params = jax.tree.map(np.copy, jax_params)
    for blk in params["blocks"]:
        blk["moe"]["router"] *= 100.0
    jm = JaxLM(**MOE_KW, compute_dtype=jnp.bfloat16)
    tm = TransformerLM(**MOE_KW, compute_dtype=torch.bfloat16)
    tm.load_state_dict(params_from_jax(params))
    x = _batch(seed=2)[0]
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, params),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.fixture(scope="module")
def trajectories():
    """5 adam steps of the MoE LM in both packages from JAX's initial
    state, on the same batches."""
    jm, tm = JaxLM(**MOE_KW), TransformerLM(**MOE_KW)
    jopt, topt = jts.adam(3e-3), tts.adam(3e-3)
    js = jts.create_train_state(jm, jopt, seed=0)
    ts = tts.create_train_state(tm, topt, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, js.params)))
    jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False)
    tstep = tts.make_train_step(tm, topt, keep_prob=1.0)
    split = LMDataSet(32, MOE_KW["seq_len"], MOE_KW["vocab_size"], seed=4)
    jm_, tm_ = [], []
    for _ in range(5):
        batch = split.next_batch(4)
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, tuple(torch.from_numpy(a) for a in batch))
        jm_.append({k: float(v) for k, v in jmet.items()})
        tm_.append({k: float(v) for k, v in tmet.items()})
    return js, ts, jm_, tm_


def test_five_step_adam_trajectory_matches_jax(trajectories):
    js, ts, jmet, tmet = trajectories
    for a, b in zip(tmet, jmet):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert tmet[-1]["moe_lb"] >= 2 * 0.99  # two blocks, near uniform
    have, want = flatten_pytree(ts), jflat(js)
    assert "params/blocks/1/moe/w1" in want
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_moe_lm_train_states_cross_both_ways(trajectories, tmp_path):
    js, ts, _, _ = trajectories
    tckpt.save_checkpoint(str(tmp_path / "port"), ts, 5)
    template = jts.create_train_state(JaxLM(**MOE_KW), jts.adam(3e-3),
                                      seed=1)
    got, step, _ = jckpt.restore_with_fallback(str(tmp_path / "port"),
                                               template)
    have, want = jflat(got), flatten_pytree(ts)
    assert step == 5 and sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, 5)
    live = tts.create_train_state(TransformerLM(**MOE_KW), tts.adam(3e-3),
                                  seed=1)
    router = live.params["blocks"][0]["moe"]["router"]
    state, step = Supervisor(True, str(tmp_path / "jax")).init_or_restore(
        live)
    assert step == 5 and state.params["blocks"][0]["moe"]["router"] is router
    have, want = flatten_pytree(state), jflat(js)
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
