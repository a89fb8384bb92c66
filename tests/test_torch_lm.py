"""The port's causal LM stack against the JAX package's, on the CPU.

The token dataset byte for byte; ``TransformerLM`` (dense attention,
``attn_block``, ``ce_block``, ``remat``) and ``MiniTransformer`` logits
and gradients from parameters the JAX package initialized, carried over
with ``params_from_jax``; a 5-step adam trajectory against JAX's
``make_train_step``; train states crossing between the packages; the
loop's LM branch, its pairing errors and the paths not ported yet. Small
sizes: S = 32, d = 32, V = 16, 2 blocks. f32 at rtol 1e-4 (atol 1e-6),
bf16 logits within 2e-2 of their scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.data import read_data_sets as jread
from distributed_tensorflow_tpu.data.lm import LMDataSet as JaxLMDataSet
from distributed_tensorflow_tpu.data.lm import recall_ceiling as jceiling
from distributed_tensorflow_tpu.models.transformer import (
    MiniTransformer as JaxMini,
)
from distributed_tensorflow_tpu.models.transformer import (
    TransformerLM as JaxLM,
)
from distributed_tensorflow_tpu.training import train_state as jts
from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import read_data_sets
from distributed_tensorflow_tpu_torch.data.lm import LMDataSet, recall_ceiling
from distributed_tensorflow_tpu_torch.models import (
    MiniTransformer,
    TransformerLM,
    get_model,
)
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.training.loop import (
    _eval_batch_for,
    build_model_for,
    train,
)
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
from distributed_tensorflow_tpu_torch.utils.pytree import (
    flatten_pytree,
    params_from_jax,
    params_to_numpy,
)

V, S, D, H, NB = 16, 32, 32, 2, 2
TOL = dict(rtol=1e-4, atol=1e-6)
LM_ARGS = ["--model", "lm", "--dataset", "lm", "--seq_len", str(S),
           "--vocab_size", str(V), "--d_model", str(D), "--num_heads",
           str(H), "--num_blocks", str(NB)]


# ----------------------------------------------------------------- dataset


@pytest.mark.parametrize("vocab", [16, 300])  # u8 and u16 storage
def test_lm_dataset_equals_jax_byte_for_byte(vocab):
    mine, ref = LMDataSet(40, 24, vocab, seed=3), JaxLMDataSet(40, 24, vocab,
                                                              seed=3)
    assert mine._tokens.dtype == ref._tokens.dtype == (
        np.uint8 if vocab <= 256 else np.uint16)
    np.testing.assert_array_equal(mine._tokens, ref._tokens)
    np.testing.assert_array_equal(mine.images, ref.images)
    np.testing.assert_array_equal(mine.labels, ref.labels)
    for n in (7, 30, 16):  # crosses an epoch boundary
        for a, b in zip(mine.next_batch(n), ref.next_batch(n)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    assert mine.epochs_completed == ref.epochs_completed == 1
    assert mine.recall_ceiling() == ref.recall_ceiling()
    assert recall_ceiling(mine._tokens.astype(np.int64)) == jceiling(
        ref._tokens.astype(np.int64))
    ms, rs = mine.shard(1, 3), ref.shard(1, 3)
    np.testing.assert_array_equal(ms.images, rs.images)
    for a, b in zip(ms.next_batch(9), rs.next_batch(9)):
        np.testing.assert_array_equal(a, b)


def test_read_data_sets_lm_equals_jax():
    mine = read_data_sets("", dataset="lm", seed=2, validation_size=5,
                          seq_len=S, vocab_size=V)
    ref = jread("", dataset="lm", seed=2, validation_size=5, seq_len=S,
                vocab_size=V)
    assert mine.meta == ref.meta == {"kind": "lm", "seq_len": S,
                                     "vocab_size": V, "num_classes": V}
    assert mine.source == ref.source == "synthetic"
    for split in ("train", "test", "validation"):
        np.testing.assert_array_equal(getattr(mine, split).images,
                                      getattr(ref, split).images)
    assert 0.3 < mine.test.recall_ceiling() < 1.0


# ------------------------------------------------------------------- model


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxLM(
        vocab_size=V, seq_len=S, d_model=D, num_heads=H,
        num_blocks=NB).init(jax.random.key(0)))


def _batch(seed, b=3):
    return read_data_sets("", dataset="lm", seed=seed, seq_len=S,
                          vocab_size=V).train.next_batch(b)


def _jax_forward_loss_grads(model, params, batch):
    """JAX's logits, loss, accuracy and gradients in one jitted call
    (eager JAX dispatches op by op, seconds at these sizes)."""
    @jax.jit
    def f(p, x, y):
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jts.loss_and_metrics(model, p, (x, y)),
            has_aux=True)(p)
        return model.apply(p, x), loss, aux["metrics"]["accuracy"], grads

    logits, loss, acc, grads = f(jax.tree.map(jnp.asarray, params),
                                 *map(jnp.asarray, batch))
    return np.asarray(logits), float(loss), float(acc), \
        jax.tree.map(np.asarray, grads)


def _port_loss_grads(model, batch):
    x, y = (torch.from_numpy(a) for a in batch)
    loss, aux = tts.loss_and_metrics(model, (x, y))
    params = tts.params_of(model)
    grads = torch.autograd.grad(loss, jax.tree.leaves(params))
    return float(loss.detach()), float(aux["metrics"]["accuracy"]), [
        g.numpy() for g in grads]


@pytest.mark.parametrize("kwargs", [
    {}, {"attn_block": 8}, {"ce_block": 16}, {"remat": True},
    {"attn_block": 16, "ce_block": 40, "remat": True}],
    ids=["dense", "attn_block", "ce_block", "remat", "all"])
def test_lm_logits_and_grads_match_jax(jax_params, kwargs):
    jm = JaxLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
               num_blocks=NB, **kwargs)
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB, **kwargs)
    tm.load_state_dict(params_from_jax(jax_params))
    batch = _batch(seed=1)
    want, jl, ja, jg = _jax_forward_loss_grads(jm, jax_params, batch)
    with torch.no_grad():
        got = tm(torch.from_numpy(batch[0]))
    assert got.dtype == torch.float32 and got.shape == (3, S, V)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tm.wants_loss_hook == jm.wants_loss_hook
    tl, ta, tg = _port_loss_grads(tm, batch)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_lm_bf16_logits_within_their_scale(jax_params):
    jm = JaxLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
               num_blocks=NB, compute_dtype=jnp.bfloat16, attn_block=8)
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB, compute_dtype=torch.bfloat16,
                       attn_block=8)
    tm.load_state_dict(params_from_jax(jax_params))
    x = _batch(seed=2)[0]
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray,
                                                     jax_params),
                                        jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_params_carry_the_jax_tree_with_its_block_list(jax_params):
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB)
    tm.load_state_dict(params_from_jax(jax_params))
    back = params_to_numpy(tm)
    assert isinstance(back["blocks"], list)
    assert jax.tree.structure(back) == jax.tree.structure(jax_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        np.testing.assert_array_equal(a, b)
    assert tm.num_params() == sum(a.size for a in jax.tree.leaves(
        jax_params))
    fresh = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                          num_blocks=NB).init(torch.Generator().manual_seed(0))
    assert fresh.blocks[0].qkv.abs().max() <= 0.04  # 0.02 truncated at 2 sigma
    assert torch.all(fresh.blocks[1].ln2_g == 1)


def test_mini_transformer_logits_match_jax():
    jm = JaxMini(d_model=D, num_heads=H, num_blocks=NB)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    tm = MiniTransformer(d_model=D, num_heads=H, num_blocks=NB, remat=True)
    tm.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(0).random((3, 784), dtype=np.float32)
    y = np.array([1, 5, 9], np.int32)
    want, jl, _, jg = _jax_forward_loss_grads(jm, params, (x, y))
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    tl, _, tg = _port_loss_grads(tm, (x, y))
    np.testing.assert_allclose(tl, jl, **TOL)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- training


@pytest.fixture(scope="module")
def trajectories():
    """5 adam steps of the LM (flash attention and the streamed head) in
    both packages from JAX's initial state, on the same batches."""
    kw = dict(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
              num_blocks=NB, attn_block=8, ce_block=24)
    jm, tm = JaxLM(**kw), TransformerLM(**kw)
    jopt, topt = jts.adam(3e-3), tts.adam(3e-3)
    js = jts.create_train_state(jm, jopt, seed=0)
    ts = tts.create_train_state(tm, topt, seed=0)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, js.params)))
    jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False)
    tstep = tts.make_train_step(tm, topt, keep_prob=1.0)
    train_split = read_data_sets("", dataset="lm", seed=4, seq_len=S,
                                 vocab_size=V).train
    jl, tl = [], []
    for _ in range(5):
        batch = train_split.next_batch(4)
        js, jmet = jstep(js, batch)
        ts, tmet = tstep(ts, tuple(torch.from_numpy(a) for a in batch))
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
    return js, ts, jl, tl


def test_five_step_adam_trajectory_matches_jax(trajectories):
    js, ts, jl, tl = trajectories
    np.testing.assert_allclose(tl, jl, **TOL)
    have, want = flatten_pytree(ts), jflat(js)
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_lm_train_states_cross_both_ways(trajectories, tmp_path):
    js, ts, _, _ = trajectories
    # the port's state restores bitwise in JAX ...
    tckpt.save_checkpoint(str(tmp_path / "port"), ts, 5)
    template = jts.create_train_state(
        JaxLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
              num_blocks=NB), jts.adam(3e-3), seed=1)
    got, step, _ = jckpt.restore_with_fallback(str(tmp_path / "port"),
                                               template)
    have, want = jflat(got), flatten_pytree(ts)
    assert step == 5 and sorted(have) == sorted(want)
    assert "params/blocks/1/mlp_in/w" in want
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k])
    # ... and JAX's restores bitwise in the port, in place
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, 5)
    tm = TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                       num_blocks=NB)
    live = tts.create_train_state(tm, tts.adam(3e-3), seed=1)
    qkv = live.params["blocks"][1]["qkv"]
    state, step = Supervisor(True, str(tmp_path / "jax")).init_or_restore(
        live)
    assert step == 5 and state.params["blocks"][1]["qkv"] is qkv
    have, want = flatten_pytree(state), jflat(js)
    assert sorted(have) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k])


@pytest.fixture
def fresh_flags():
    flags.define_reference_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


def test_train_lm_local_and_sync_through_the_loop(fresh_flags, tmp_path):
    """``train(FLAGS)`` host-fed on the CPU, local and as a one-rank gloo
    group: the same losses, a checkpoint with JAX's keys, the LM eval
    batch rule."""
    import socket

    from distributed_tensorflow_tpu_torch.cluster import (
        ClusterSpec,
        maybe_initialize_distributed,
    )

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    common = ["--device", "cpu", *LM_ARGS, "--optimizer", "adam",
              "--learning_rate", "0.003", "--batch_size", "8",
              "--training_iter", "3", "--display_step", "1",
              "--keep_prob", "1.0", "--attn_block", "16", "--ce_block", "64",
              "--save_model_secs", "100000"]
    fresh_flags._parse(common + ["--logdir", str(tmp_path / "local")])
    local = train(fresh_flags)
    assert local.final_step == 3 and 0 <= local.test_metrics["accuracy"] <= 1
    fresh_flags._reset()
    fresh_flags._parse(common + ["--logdir", str(tmp_path / "sync"),
                                 "--mode", "sync", "--worker_hosts",
                                 f"127.0.0.1:{port}"])
    assert maybe_initialize_distributed(
        ClusterSpec({"worker": [f"127.0.0.1:{port}"]}), 0, "cpu")
    try:
        synced = train(fresh_flags, mode="sync")
    finally:
        torch.distributed.destroy_process_group()
    assert synced.train_metrics == local.train_metrics
    assert synced.test_metrics == local.test_metrics
    keys = tckpt.checkpoint_keys(str(tmp_path / "local" / "ckpt-3.npz"))
    js = jts.create_train_state(JaxLM(vocab_size=V, seq_len=S, d_model=D,
                                      num_heads=H, num_blocks=NB),
                                jts.adam(3e-3))
    assert sorted(keys) == sorted(jflat(js))
    model = build_model_for(fresh_flags, {"kind": "lm", "seq_len": 4096,
                                          "vocab_size": V})
    assert _eval_batch_for(model, {"kind": "lm"}) == 64
    assert _eval_batch_for(model, {"image_size": 28}) == 1000


def test_pairing_errors_and_paths_not_yet_ported(fresh_flags):
    fresh_flags._parse(["--device", "cpu", *LM_ARGS])
    with pytest.raises(ValueError, match="Use --model lm"):
        fresh_flags.model = "deep_cnn"
        build_model_for(fresh_flags, {"kind": "lm", "seq_len": S,
                                      "vocab_size": V})
    fresh_flags.model = "lm"
    with pytest.raises(ValueError, match="use --dataset lm"):
        build_model_for(fresh_flags, {"image_size": 28, "channels": 1,
                                      "num_classes": 10})
    for extra in (["--device_data"], ["--zero", "1", "--mode", "sync",
                                      "--worker_hosts", "127.0.0.1:1"]):
        fresh_flags._reset()
        fresh_flags._parse(["--device", "cpu", *LM_ARGS, *extra])
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train(fresh_flags)
    fresh_flags._reset()
    with pytest.raises(ValueError, match="augment"):
        fresh_flags._parse(["--device", "cpu", *LM_ARGS, "--augment"])
    with pytest.raises(NotImplementedError, match="moe_experts"):
        get_model("lm", moe_experts=2)
    with pytest.raises(NotImplementedError, match="seq_axis"):
        get_model("lm", seq_axis="model")
    with pytest.raises(NotImplementedError, match="seq_axis"):
        get_model("transformer", seq_axis="model")


def test_ps_roles_refuse_the_lm(fresh_flags):
    from distributed_tensorflow_tpu_torch.cluster import ClusterSpec
    from distributed_tensorflow_tpu_torch.parallel import ps_emulation

    fresh_flags._parse(["--device", "cpu", *LM_ARGS, "--job_name", "ps",
                        "--ps_hosts", "127.0.0.1:1",
                        "--worker_hosts", "127.0.0.1:2"])
    cluster = ClusterSpec.from_flags(fresh_flags)
    with pytest.raises(NotImplementedError, match="ps topology"):
        ps_emulation.run_parameter_server(cluster, fresh_flags)
    with pytest.raises(NotImplementedError, match="ps topology"):
        ps_emulation.run_worker(cluster, fresh_flags)
