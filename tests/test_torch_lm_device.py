"""The LM on the port's device-resident and ZeRO paths, on the CPU.

A token split staged once as the (N, S + 1) table (uint8 as uint8,
uint16 as int32) with inputs and targets as its two shifted views; the
device step on injected indices against the JAX package's
``make_train_step`` on the same rows (rtol 1e-4; parameters atol 1e-5,
adam's noise-sized steps) and against the port's host-fed step (bitwise:
the same ops on the same ids); ``--zero 1``, ``--zero 3`` and ``--zero 3
--zero_overlap`` on the MoE LM over 2 gloo ranks against ``--mode sync``
DP, host-fed and device-resident, bitwise (at two ranks the
reduce-scatter sums what the all-reduce sums, ``tests/test_torch_zero.py``;
under ``--clip_norm`` levels 1 and 3 bitwise, DP within rtol 1e-5, atol
1e-7, the clip's squared norm summed in another order),
each rank routing its own batch's tokens as the JAX package's DP does
(``tests/test_moe.py``); and the loop: ``--dataset lm --device_data``
and ``--zero 3 --device_data`` through ``train``, the ZeRO run's
standard-layout checkpoint resumed by a replicated run.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import socket

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import datasets, put_device_data
from distributed_tensorflow_tpu_torch.data.lm import LMDataSet
from distributed_tensorflow_tpu_torch.models import TransformerLM
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.training.device_step import (
    make_device_train_step,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    flatten_pytree,
    params_from_jax,
)
from tests.test_torch_parallel import _join_group, _spawn, free_port

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

V, S = 16, 32
MOE_KW = dict(vocab_size=V, seq_len=S, d_model=32, num_heads=2,
              num_blocks=2, moe_experts=4)
STEPS, BATCH, LR = 3, 8, 3e-3
ZERO_STEPS = 2  # adam steps of each ZeRO and DP configuration
CLIP = 0.5
LM_ARGS = ["--model", "lm", "--dataset", "lm", "--seq_len", str(S),
           "--vocab_size", str(V), "--d_model", "32", "--num_heads", "2",
           "--num_blocks", "2", "--moe_experts", "4"]


def _rows(step: int, n: int = 48) -> torch.Tensor:
    """The injected indices of global step ``step``: a fixed draw."""
    g = np.random.default_rng(1000 + step)
    return torch.from_numpy(g.integers(0, n, BATCH))


@pytest.mark.parametrize("vocab", [16, 300])  # u8 and u16 storage
def test_token_split_stages_once_as_two_views(vocab):
    split = LMDataSet(12, 8, vocab, seed=3)
    data = put_device_data(split, "cpu")
    assert data.tokens and data.num_examples == 12
    assert data.images.dtype == data.labels.dtype == (
        torch.uint8 if vocab <= 256 else torch.int32)
    assert data.images.shape == data.labels.shape == (12, 8)
    # one staged table, the inputs and targets two views of it
    assert data.images.data_ptr() + data.images.element_size() == \
        data.labels.data_ptr()
    assert data.images.untyped_storage().nbytes() == \
        12 * 9 * data.images.element_size()
    idx = torch.tensor([5, 0, 5, 11])
    x, y = data.batch(idx)
    assert x.dtype == y.dtype == torch.int32
    np.testing.assert_array_equal(x.numpy(), split._tokens[idx, :-1])
    np.testing.assert_array_equal(y.numpy(), split._tokens[idx, 1:])


@pytest.fixture(scope="module")
def device_vs_jax():
    """3 adam steps of the MoE LM (streamed head) through the
    port's device step on injected rows, the port's host-fed step and
    the JAX package's ``make_train_step`` on the same rows, from JAX's
    initial state."""
    import jax

    from distributed_tensorflow_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.training import train_state as jts

    kw = dict(MOE_KW, ce_block=24)
    split = LMDataSet(48, S, V, seed=5)
    jm, jopt = JaxLM(**kw), jts.adam(LR)
    js = jts.create_train_state(jm, jopt, seed=0)
    init = params_from_jax(jax.tree.map(np.asarray, js.params))
    jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False)
    runs = {}
    for name in ("device", "host"):
        tm, topt = TransformerLM(**kw), tts.adam(LR)
        ts = tts.create_train_state(tm, topt, seed=0)
        tm.load_state_dict(init)
        runs[name] = (tm, topt, ts, [])
    tm, topt, ts, dev_metrics = runs["device"]
    dstep = make_device_train_step(tm, topt, put_device_data(split, "cpu"),
                                   BATCH, indices=_rows)
    tm_h, topt_h, ts_h, host_metrics = runs["host"]
    hstep = tts.make_train_step(tm_h, topt_h, keep_prob=1.0)
    jmet = []
    for i in range(STEPS):
        t = split._tokens[_rows(i).numpy()]
        batch = (t[:, :-1].astype(np.int32), t[:, 1:].astype(np.int32))
        js, m = jstep(js, batch)
        jmet.append({k: float(v) for k, v in m.items()})
        ts_h, m = hstep(ts_h, tuple(torch.from_numpy(a) for a in batch))
        host_metrics.append({k: float(v) for k, v in m.items()})
        _, m = dstep(ts, i)
        dev_metrics.append({k: float(v) for k, v in m.items()})
    return js, jmet, ts, dev_metrics, ts_h, host_metrics


def test_lm_device_step_matches_jax_on_the_same_rows(device_vs_jax):
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jf

    js, jmet, ts, dev_metrics, _, _ = device_vs_jax
    assert int(ts.step) == STEPS
    for got, want in zip(dev_metrics, jmet):
        assert sorted(got) == sorted(want) == ["accuracy", "loss", "moe_lb"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    have, want = flatten_pytree(ts), jf(js)
    assert sorted(have) == sorted(want)
    for k in want:
        if k.startswith("params/"):
            np.testing.assert_allclose(have[k], want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_lm_device_step_equals_the_host_fed_step(device_vs_jax):
    _, _, ts, dev_metrics, ts_h, host_metrics = device_vs_jax
    assert dev_metrics == host_metrics
    have, want = flatten_pytree(ts), flatten_pytree(ts_h)
    for k in want:
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)


# ------------------------------------------------------------ ZeRO ranks

# name -> (level, overlap, clip_norm)
CONFIGS = {"dp": (0, False, 0.0), "z1": (1, False, 0.0),
           "z3": (3, False, 0.0), "z3o": (3, True, 0.0),
           "dp_clip": (0, False, CLIP), "z1_clip": (1, False, CLIP),
           "z3_clip": (3, False, CLIP)}


def _zero_rank(rank, world, port, out_dir):
    """Every configuration, host-fed and device-resident, on this rank's
    half of each global batch; the standard layout saved per config."""
    from distributed_tensorflow_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        replicate_state,
        zero,
    )
    from distributed_tensorflow_tpu_torch.training.device_step import (
        make_device_dp_train_step,
        make_zero_device_train_step,
    )

    _join_group(rank, world, port)
    mesh = make_mesh("cpu")
    split = LMDataSet(48, S, V, seed=5)
    data = put_device_data(split, "cpu")
    local = BATCH // world
    out = {}

    def mine(i):
        """This rank's share of global step ``i``'s rows."""
        return _rows(i)[rank * local:(rank + 1) * local]

    for name, (level, overlap, clip_norm) in CONFIGS.items():
        # the clip acts on the reduced gradients, whatever fed them
        for path in ("host",) if clip_norm else ("host", "device"):
            model, opt = TransformerLM(**MOE_KW), tts.adam(LR)
            state = replicate_state(mesh, tts.create_train_state(
                model, opt, seed=rank))  # rank 0's init everywhere
            clip = None
            if clip_norm:
                clip = (zero.zero_clip_transform(clip_norm, mesh) if level
                        else tts.clip_by_global_norm(clip_norm))
            if level:
                state = zero.shard_state_zero(state, mesh, level)
            if path == "host":
                step = (zero.make_zero_train_step(
                    model, opt, mesh, level, grad_transform=clip,
                    overlap=overlap, bucket_mb=0.05) if level
                    else make_dp_train_step(model, opt, mesh,
                                            grad_transform=clip))
            elif level:
                step = make_zero_device_train_step(
                    model, opt, mesh, level, data, BATCH,
                    grad_transform=clip, indices=mine, overlap=overlap,
                    bucket_mb=0.05)
            else:
                step = make_device_dp_train_step(
                    model, opt, mesh, data, BATCH, grad_transform=clip,
                    indices=mine)
            losses = []
            for i in range(ZERO_STEPS):
                if path == "host":
                    batch = data.batch(mine(i))
                    state, m = step(state, batch)
                else:
                    state, m = step(state, i)
                losses.append([float(m[k]) for k in sorted(m)])
            if level:
                state = zero.fetch_state_zero(state, model, mesh, level)
            flat = flatten_pytree(state)
            out.update({f"{name}/{path}/{k}": np.array(v)
                        for k, v in flat.items()})
            out[f"{name}/{path}/losses"] = np.array(losses)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


def test_zero_levels_on_the_moe_lm_equal_dp_over_two_gloo_ranks(tmp_path):
    from distributed_tensorflow_tpu.models.transformer import (
        TransformerLM as JaxLM,
    )
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jf

    _spawn(_zero_rank, 2, free_port(), str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in ranks[0]:  # the replicas, bit for bit
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    got = ranks[0]
    std = sorted(jf(jts.create_train_state(JaxLM(**MOE_KW), jts.adam(LR))))
    assert "params/blocks/1/moe/router" in std
    for path in ("host", "device"):
        base = {k.split("/", 2)[2]: v for k, v in got.items()
                if k.startswith(f"dp/{path}/")}
        assert sorted(k for k in base if k != "losses") == std
        assert np.all(np.isfinite(base["losses"]))
        for name in ("z1", "z3", "z3o"):
            for k, v in base.items():
                np.testing.assert_array_equal(
                    got[f"{name}/{path}/{k}"], v, err_msg=f"{name} {path} {k}")
    # the clip's squared norm sums the chunks in another order than the
    # replicated clip: levels 1 and 3 bitwise, DP within 1e-5
    for key, v in got.items():
        if key.startswith("dp_clip/host/"):
            k = key.removeprefix("dp_clip/host/")
            z1, z3 = (got[f"{n}/host/{k}"] for n in ("z1_clip", "z3_clip"))
            np.testing.assert_array_equal(z3, z1, err_msg=k)
            np.testing.assert_allclose(z1, v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


# ------------------------------------------------------------------- loop


@pytest.fixture
def lm_flags(monkeypatch):
    monkeypatch.setattr(datasets, "LM_TRAIN", 48)
    monkeypatch.setattr(datasets, "LM_TEST", 16)
    flags.define_reference_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


def test_lm_device_data_and_zero_train_through_the_loop(lm_flags, tmp_path):
    """``--dataset lm --device_data`` trains locally; in a one-rank gloo
    group ``--zero 3 --device_data`` trains the same steps to the same
    losses, saves the standard layout, and a replicated run resumes it."""
    from distributed_tensorflow_tpu_torch.cluster import (
        ClusterSpec,
        maybe_initialize_distributed,
    )
    from distributed_tensorflow_tpu_torch.training.loop import train

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    common = ["--device", "cpu", *LM_ARGS, "--optimizer", "adam",
              "--learning_rate", str(LR), "--batch_size", str(BATCH),
              "--display_step", "2", "--keep_prob", "1.0",
              "--save_model_secs", "100000", "--device_data",
              "--device_chunk", "3"]
    sync = ["--mode", "sync", "--worker_hosts", f"127.0.0.1:{port}"]

    def run(logdir, *extra, mode="local"):
        lm_flags._reset()
        lm_flags._parse(common + ["--logdir", str(tmp_path / logdir),
                                  *extra])
        return train(lm_flags, mode=mode)

    local = run("local", "--training_iter", "4")
    assert local.final_step == 4 and "moe_lb" in local.train_metrics
    assert maybe_initialize_distributed(
        ClusterSpec({"worker": [f"127.0.0.1:{port}"]}), 0, "cpu")
    try:
        zeroed = run("zero", "--training_iter", "4", "--zero", "3", *sync,
                     mode="sync")
        resumed = run("zero", "--training_iter", "6", *sync, mode="sync")
    finally:
        torch.distributed.destroy_process_group()
    assert zeroed.train_metrics == local.train_metrics
    assert zeroed.test_metrics == local.test_metrics
    assert resumed.final_step == 6
    want = tckpt.load_flat(str(tmp_path / "local" / "ckpt-4.npz"))
    got = tckpt.load_flat(str(tmp_path / "zero" / "ckpt-4.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(tckpt.load_flat(str(tmp_path / "zero" / "ckpt-6.npz"))[
        "step"]) == 6
