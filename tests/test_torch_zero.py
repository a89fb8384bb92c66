"""The port's ZeRO-sharded sync DP (``parallel/zero.py``) on gloo ranks
against the port's replicated DP step and the JAX package's
``make_zero_train_step`` on a slice of the tests' virtual CPU mesh; its
analytics against the JAX package's; the ZeRO loop's boundary fetch,
checkpoints and resumes.

Tolerances. At one rank and at two, a reduce-scatter sums what the
all-reduce sums in the same order (a + b = b + a), every optimizer op is
elementwise and the padding lanes are inert, so ZeRO-1, ZeRO-3 and
ZeRO-3 overlapped equal replicated DP bit for bit. gloo at four ranks
orders each element's sum by its place in the buffer, so DP's one packed
all-reduce, the per-leaf scatters and the bucketed scatters round in
different last ulps: levels 1 and 3 (the same per-leaf layout) stay
bitwise equal to each other, and the rest agree within the adam rule of
``tests/test_torch_train_state.py`` (a weight whose gradient is
summation noise moves by up to lr a step either way), losses at rtol
1e-6. ``--clip_norm`` sums the squared norm from chunks in another order
than the replicated clip: within rtol 1e-5 of DP, bitwise across levels.
Against JAX (another float32 summation order through conv, matmul and
softmax, compounded over 5 adam steps): losses at rtol 1e-4, parameters
under the same adam rule, as ``tests/test_torch_parallel.py`` holds DP.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import flags as tflags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import DataSet, put_device_data
from distributed_tensorflow_tpu_torch.models import DeepCNN, ResNet20
from distributed_tensorflow_tpu_torch.parallel import zero
from distributed_tensorflow_tpu_torch.parallel.data_parallel import (
    dp_comm_rows,
    replicate_state,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import DataMesh
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.utils.pytree import (
    flatten_pytree,
    tree_leaves,
)
from tests.test_torch_parallel import (
    GLOBAL_BATCH,
    LR,
    STEPS,
    _assert_adam_close,
    _cifar_global_batches,
    _flat,
    _global_batches,
    _join_group,
    _spawn,
    free_port,
    write_mnist_idx,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

DS = [1, 2, 3, 4, 8]
BUCKET_MB = 0.5  # the overlapped runs' buckets: the small leaves share one
CLIP = 1.0
# name -> (level, overlap, clip_norm, accum_steps, keep_prob)
CONFIGS = {}
for _fam, (_clip, _accum, _keep) in {"": (0.0, 1, 1.0),
                                     "clip": (CLIP, 1, 1.0),
                                     "accum": (0.0, 2, 1.0),
                                     "drop": (0.0, 1, 0.75)}.items():
    for _name, _level, _overlap in (("dp", 0, False), ("z1", 1, False),
                                    ("z1o", 1, True), ("z3", 3, False),
                                    ("z3o", 3, True)):
        if _fam and _name == "z1o":
            continue  # the plain family holds level 1's buckets
        CONFIGS[f"{_name}{'_' + _fam if _fam else ''}"] = (
            _level, _overlap, _clip, _accum, _keep)
FAMILIES = ("", "_clip", "_accum", "_drop")
DEVICE_STEPS, DEVICE_SPLIT = 4, 96


def _fake_mesh(rank, d):
    return DataMesh(rank=rank, world_size=d, device=torch.device("cpu"),
                    backend="gloo")


# ---------------------------------------------------------------- numpy only


@pytest.mark.parametrize("d", DS)
def test_analytics_equal_the_jax_packages(d):
    """Bucket plans, bucket counts, the memory budget and the comm rows
    of the deep CNN and ResNet-20, at 0.5 and 4 MB buckets, equal the JAX
    package's numbers (the rows' prose notes aside)."""
    import jax

    from distributed_tensorflow_tpu.models import DeepCNN as JDeepCNN
    from distributed_tensorflow_tpu.models import ResNet20 as JResNet20
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
    from distributed_tensorflow_tpu.parallel import zero as jz
    from distributed_tensorflow_tpu.training import train_state as jts

    strip = lambda rows: [{k: v for k, v in r.items() if k != "note"}  # noqa: E731
                          for r in rows]
    for model, jmodel in ((DeepCNN(), JDeepCNN()), (ResNet20(), JResNet20())):
        jleaves = jax.tree.leaves(jz.abstract_params(jmodel))
        assert [tuple(m.shape) for m in zero.abstract_params(model)] == \
            [tuple(m.shape) for m in jleaves]
        for opt, jopt in ((tts.adam(LR), jts.adam(LR)),
                          (tts.momentum(LR), jts.momentum(LR))):
            budget = zero.zero_memory_budget(model, opt, d)
            assert budget == jz.zero_memory_budget(jmodel, jopt, d)
        g = budget["param_bytes"]
        assert strip(dp_comm_rows(g, d)) == strip(jdp.dp_comm_rows(g, d))
        for mb in (0.5, 4.0):
            bucket = int(mb * 2 ** 20)
            assert zero._bucket_plan(zero.abstract_params(model), d,
                                     bucket) == \
                jz._bucket_plan(jleaves, d, bucket)
            assert zero.n_buckets(model, d, mb) == \
                jz.n_buckets(jmodel, d, mb)
            for level in (0, 1, 3):
                for overlap in (False, True):
                    args = (g, g, level, d, overlap, mb)
                    assert strip(zero.zero_comm_rows(*args)) == \
                        strip(jz.zero_comm_rows(*args))
                    assert zero.zero_exposed_comm_bytes(*args) == \
                        jz.zero_exposed_comm_bytes(*args)


@pytest.mark.parametrize("d", DS)
def test_shard_then_fetch_gives_back_the_state_padding_included(
        d, monkeypatch):
    """Level 3: the D ranks' chunks of every leaf are ceil(n/D) long,
    zero-padded at the end (``biases/out`` pads 10 -> 12 at D = 4), and
    the fetch, its all-gather standing in for D ranks, rebuilds the
    standard state and the module's parameters bitwise."""
    model = DeepCNN()
    state = tts.create_train_state(model, tts.adam(LR), seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in tree_leaves(state.opt_state):
            if t.dim():
                t.copy_(torch.randn(t.shape, generator=gen))
    want = {k: np.array(v) for k, v in flatten_pytree(state).items()}
    shards = [zero.shard_state_zero(state, _fake_mesh(r, d), 3)
              for r in range(d)]
    assert all(isinstance(s, zero.ZeroState) for s in shards)
    bout = [s.params["biases"]["out"] for s in shards]
    assert all(c.shape == (-(-10 // d),) for c in bout)
    padded = torch.cat(bout)
    assert padded.numel() == d * -(-10 // d) and not padded[10:].any()
    np.testing.assert_array_equal(padded[:10], want["params/biases/out"])

    by_ptr = {}
    per_rank = [tree_leaves(s) for s in shards]
    for i, leaf in enumerate(per_rank[0]):
        if isinstance(leaf, torch.Tensor):
            by_ptr[leaf.data_ptr()] = [p[i] for p in per_rank]

    def gather(out, chunk, group=None):
        out.copy_(torch.cat(by_ptr[chunk.data_ptr()]))

    monkeypatch.setattr(zero.dist, "all_gather_into_tensor", gather)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    got = flatten_pytree(zero.fetch_state_zero(shards[0], model,
                                               _fake_mesh(0, d), 3))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(model.biases["out"].detach().numpy(),
                                  want["params/biases/out"])


def test_replicate_state_refuses_a_chunked_state():
    state = tts.create_train_state(DeepCNN(), tts.adam(LR), seed=0)
    chunked = zero.shard_state_zero(state, _fake_mesh(0, 2), 1)
    with pytest.raises(ValueError, match="ZeRO layout"):
        replicate_state(_fake_mesh(0, 2), chunked)
    with pytest.raises(ValueError, match="already in the ZeRO layout"):
        zero.shard_state_zero(chunked, _fake_mesh(0, 2), 1)
    with pytest.raises(ValueError, match="must be 1"):
        zero.shard_state_zero(state, _fake_mesh(0, 2), 2)


@pytest.mark.parametrize("argv,match", [
    (["--zero=2", "--mode=sync"], "must be 0"),
    (["--zero=1", "--mode=local"], "requires sync mode"),
    (["--zero=1", "--ps_hosts=127.0.0.1:1"], "ps topology"),
    (["--zero=3", "--job_name=worker"], "ps topology"),
    (["--zero_overlap"], "only applies to --zero"),
    (["--zero=1", "--zero_overlap", "--zero_bucket_mb=0"], r"\(0, 1024\]"),
    (["--zero=1", "--zero_bucket_mb=2"], "only applies with"),
])
def test_zero_flag_checks_raise(argv, match):
    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    try:
        with pytest.raises(ValueError, match=match):
            tflags.FLAGS._parse(argv)
    finally:
        tflags.FLAGS._reset()


def test_zero_needs_sync_mode_in_the_library_too(tmp_path):
    from distributed_tensorflow_tpu_torch.training.loop import train

    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    try:
        tflags.FLAGS._parse(["--device=cpu", "--zero=1",
                             f"--logdir={tmp_path}"])
        with pytest.raises(ValueError, match="requires sync mode"):
            train(tflags.FLAGS, mode="local")
    finally:
        tflags.FLAGS._reset()


# --------------------------------------------------------- gloo trajectories


def _device_split():
    from distributed_tensorflow_tpu_torch.data import synthetic_digits

    x, y = synthetic_digits(DEVICE_SPLIT, seed=3)
    return put_device_data(DataSet(x, y), "cpu")


def _traj_rank(rank, world, port, init_path, out_dir):
    """Every configuration's 5 fed adam steps on this rank, from the JAX
    init (rank 0; the others start elsewhere and take rank 0's through
    ``replicate_state``), then the eager device steps on injected
    indices: DP's against ZeRO's. Writes the standard-layout state each
    one ends with."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
    )
    from distributed_tensorflow_tpu_torch.training.device_step import (
        DeviceTrainStep,
        make_zero_device_train_step,
    )

    _join_group(rank, world, port)
    mesh = make_mesh("cpu")
    init = np.load(init_path)
    model = DeepCNN()
    local = GLOBAL_BATCH // world
    out = {}

    def fresh():
        opt = tts.adam(LR)
        state = tts.create_train_state(model, opt, seed=rank)
        if rank == 0:
            model.load_state_dict({k: torch.from_numpy(init[k])
                                   for k in init})
        return opt, replicate_state(mesh, state)

    for name, (level, overlap, clip, accum, keep) in CONFIGS.items():
        opt, state = fresh()
        if level:
            state = zero.shard_state_zero(state, mesh, level)
            step_fn = zero.make_zero_train_step(
                model, opt, mesh, level, keep_prob=keep,
                grad_transform=(zero.zero_clip_transform(clip, mesh)
                                if clip else None),
                accum_steps=accum, overlap=overlap, bucket_mb=BUCKET_MB)
        else:
            step_fn = make_dp_train_step(
                model, opt, mesh, keep_prob=keep,
                grad_transform=tts.clip_by_global_norm(clip) if clip
                else None, accum_steps=accum)
        losses = []
        for x, y in _global_batches():
            sl = slice(rank * local, (rank + 1) * local)
            state, m = step_fn(state, (torch.from_numpy(x[sl]),
                                       torch.from_numpy(y[sl])))
            losses.append(float(m["loss"]))
        if level:
            state = zero.fetch_state_zero(state, model, mesh, level)
        out[f"{name}|losses"] = np.asarray(losses)
        for k, v in flatten_pytree(state).items():
            out[f"{name}|{k}"] = np.array(v)  # the module moves on

    data = _device_split()
    idx = np.random.default_rng(11 + rank).integers(
        0, DEVICE_SPLIT, (DEVICE_STEPS, local))
    indices = lambda step: torch.from_numpy(idx[step])  # noqa: E731
    for name, level, overlap in (("dev_dp", 0, False), ("dev_z1", 1, False),
                                 ("dev_z3", 3, False), ("dev_z3o", 3, True)):
        opt, state = fresh()
        if level:
            state = zero.shard_state_zero(state, mesh, level)
            step_fn = make_zero_device_train_step(
                model, opt, mesh, level, data, GLOBAL_BATCH, keep_prob=0.75,
                indices=indices, overlap=overlap, bucket_mb=BUCKET_MB)
        else:
            step_fn = DeviceTrainStep(model, opt, data, local,
                                      keep_prob=0.75, mesh=mesh,
                                      indices=indices)
        losses = []
        for s in range(DEVICE_STEPS):
            state, m = step_fn(state, s, 1)
            losses.append(float(m["loss"]))
        if level:
            state = zero.fetch_state_zero(state, model, mesh, level)
        out[f"{name}|losses"] = np.asarray(losses)
        for k, v in flatten_pytree(state).items():
            out[f"{name}|{k}"] = np.array(v)  # the module moves on
    np.savez(os.path.join(out_dir, f"traj{rank}.npz"), **out)
    dist.destroy_process_group()


def _jax_zero(world, level, jstate):
    """The JAX package's ZeRO trajectory on the first ``world`` virtual
    devices: losses and the fetched standard-layout params."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
    from distributed_tensorflow_tpu.parallel import zero as jz
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.training import train_state as jts

    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    state = jz.shard_state_zero(jstate, mesh, level)
    step = jz.make_zero_train_step(JaxDeepCNN(), jts.adam(LR), mesh, level,
                                   keep_prob=1.0, donate=False)
    losses = []
    for b in _global_batches():
        state, m = step(state, jdp.shard_batch(mesh, tuple(map(jnp.asarray,
                                                               b))))
        losses.append(float(m["loss"]))
    host = jz.fetch_state_zero(state, JaxDeepCNN(), level)
    return losses, jax.tree.map(np.asarray, host.params)


def _config(d, name):
    prefix = name + "|"
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _params(flat):
    params = {"weights": {}, "biases": {}}
    for k, v in flat.items():
        if k.startswith("params/"):
            _, group, leaf = k.split("/")
            params[group][leaf] = v
    return params


def _assert_bitwise(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


def _assert_close(a, b, what):
    """Another summation order (gloo at four ranks): losses at rtol 1e-6,
    every state array under the adam rule."""
    assert sorted(a) == sorted(b), what
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6,
                               err_msg=what)
    for k in a:
        if k == "losses":
            continue
        if k not in ("rng", "step", "opt_state/t"):
            d = np.abs(a[k].astype(np.float64) - b[k])
            assert (d > 1e-5).mean() <= 1e-4, f"{what}: {k}"
            assert d.max() <= 2 * STEPS * LR, f"{what}: {k}"
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")


@pytest.mark.parametrize("world", [2, 4])
def test_zero_levels_match_replicated_dp_and_jax(world, tmp_path):
    """ZeRO-1, ZeRO-3 and both overlapped (0.5 MB buckets: the small
    leaves share a bucket, wd1 has its own), plain, clipped at 1.0, with
    2 accumulation steps and with dropout, against replicated DP from
    one JAX init over ``world`` gloo ranks; the fed 5 adam steps of
    ZeRO-3 (world 2: the gather's transpose is the JAX step's
    reduce-scatter) and ZeRO-1 (world 4) against the JAX package's on as
    many virtual devices; the eager ZeRO device steps on injected
    indices against the DP device step. Every rank ends with the same
    state, bit for bit."""
    import jax

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    jstate = jts.create_train_state(JaxDeepCNN(), jts.adam(LR), seed=0)
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    _spawn(_traj_rank, world, free_port(), init_path, str(tmp_path))

    ranks = [dict(np.load(tmp_path / f"traj{r}.npz")) for r in range(world)]
    for r in ranks[1:]:  # the replicas, gathered parameters included
        _assert_bitwise(r, ranks[0], "replicas")
    got = ranks[0]
    dp = {fam: _config(got, "dp" + fam) for fam in FAMILIES}
    for fam in FAMILIES:
        z1, z3 = _config(got, "z1" + fam), _config(got, "z3" + fam)
        _assert_bitwise(z1, z3, f"level 1 vs 3{fam}")
        for name in ("z1", "z1o", "z3", "z3o") if not fam else \
                ("z1", "z3", "z3o"):
            z = _config(got, name + fam)
            if fam == "_clip":
                # chunked squared norms: another order than the full leaves
                np.testing.assert_allclose(z["losses"], dp[fam]["losses"],
                                           rtol=1e-5)
                for k in z:
                    if k.startswith("params/"):
                        np.testing.assert_allclose(
                            z[k], dp[fam][k], rtol=1e-5,
                            atol=1e-5 * np.abs(dp[fam][k]).max(), err_msg=k)
            elif world == 2:
                _assert_bitwise(z, dp[fam], f"{name}{fam} vs dp")
            else:
                _assert_close(z, dp[fam], f"{name}{fam} vs dp")
        for name in ("z1o", "z3o") if not fam else ("z3o",):
            z = _config(got, name + fam)
            if world == 2:
                _assert_bitwise(z, z3, f"{name}{fam} vs serial")
            elif fam != "_clip":
                _assert_close(z, z3, f"{name}{fam} vs serial")
    dev_dp = _config(got, "dev_dp")
    for name in ("dev_z1", "dev_z3", "dev_z3o"):
        if world == 2:
            _assert_bitwise(_config(got, name), dev_dp, name)
        else:
            _assert_close(_config(got, name), dev_dp, name)

    level, name = (3, "z3") if world == 2 else (1, "z1")
    want, jparams = _jax_zero(world, level, jstate)
    z = _config(got, name)
    np.testing.assert_allclose(z["losses"], want, rtol=1e-4)
    _assert_adam_close(_params(z), jparams)


def _resnet_rank(rank, world, port, init_path, out_dir):
    """Float64 ResNet-20: 5 fed adam steps of replicated DP, then of
    ZeRO-1, from the JAX init."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
    )

    _join_group(rank, world, port)
    mesh = make_mesh("cpu")
    init = np.load(init_path)
    model = ResNet20().double()
    local = GLOBAL_BATCH // world
    out = {}
    for level in (0, 1):
        opt = tts.adam(LR)
        state = tts.create_train_state(model, opt, seed=rank)
        if rank == 0:
            model.load_state_dict({k: torch.from_numpy(init[k])
                                   for k in init})
        state = replicate_state(mesh, state)
        if level:
            state = zero.shard_state_zero(state, mesh, level)
            step_fn = zero.make_zero_train_step(model, opt, mesh, level)
        else:
            step_fn = make_dp_train_step(model, opt, mesh)
        losses = []
        for x, y in _cifar_global_batches():
            sl = slice(rank * local, (rank + 1) * local)
            state, m = step_fn(state, (torch.from_numpy(x[sl]),
                                       torch.from_numpy(y[sl])))
            losses.append(float(m["loss"]))
        if level:
            state = zero.fetch_state_zero(state, model, mesh, level)
        out[f"z{level}|losses"] = np.asarray(losses)
        for k, v in flatten_pytree(state).items():
            out[f"z{level}|{k}"] = np.array(v)  # the module moves on
    np.savez(os.path.join(out_dir, f"resnet{rank}.npz"), **out)
    dist.destroy_process_group()


def test_resnet20_zero1_matches_jax_and_its_model_state_matches_dp(
        tmp_path):
    """Two gloo ranks of float64 ResNet-20 (the reasoning of
    ``tests/test_torch_parallel.py``): ZeRO-1 against the JAX package's
    ZeRO-1 at rtol 1e-4, and its batch-norm running stats, averaged over
    the ranks each step, bitwise equal to replicated DP's, as is the rest
    of the state."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.resnet import ResNet as JaxResNet
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
    from distributed_tensorflow_tpu.parallel import zero as jz
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    world = 2
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        jm, jopt = JaxResNet(), jts.adam(LR)
        js = jts.create_train_state(jm, jopt, seed=0)
        js = js._replace(params=f64(js.params),
                         model_state=f64(js.model_state))
        js = js._replace(opt_state=jopt.init(js.params))
        init = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(
            np.asarray, {"params": js.params,
                         "state": js.model_state})).items()}
        mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
        state = jz.shard_state_zero(js, mesh, 1)
        step = jz.make_zero_train_step(jm, jopt, mesh, 1, keep_prob=1.0,
                                       donate=False)
        want = []
        for b in _cifar_global_batches():
            state, m = step(state, jdp.shard_batch(
                mesh, tuple(map(jnp.asarray, b))))
            want.append(float(m["loss"]))
        host = jz.fetch_state_zero(state, jm, 1)
        jflat = {**{f"params/{k}": v for k, v in _flat(host.params)},
                 **{f"model_state/{k}": v
                    for k, v in _flat(host.model_state)}}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    _spawn(_resnet_rank, world, free_port(), init_path, str(tmp_path))

    ranks = [dict(np.load(tmp_path / f"resnet{r}.npz"))
             for r in range(world)]
    _assert_bitwise(ranks[1], ranks[0], "replicas")
    z1, dp = _config(ranks[0], "z1"), _config(ranks[0], "z0")
    _assert_bitwise(z1, dp, "ResNet-20 ZeRO-1 vs DP")
    assert any(k.startswith("model_state/stage2/block2/bn2/") for k in z1)
    np.testing.assert_allclose(z1["losses"], want, rtol=1e-4)
    for k, v in jflat.items():
        assert z1[k].dtype == np.float64
        np.testing.assert_allclose(z1[k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------------ the loop, end to end


def _train(rank, world, port, logdir, data_dir, *extra):
    """``train(FLAGS, mode="sync")`` on this rank; (result, stdout)."""
    from distributed_tensorflow_tpu_torch.training.loop import train

    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    tflags.FLAGS._parse([
        "--device=cpu", "--mode=sync", f"--task_index={rank}",
        "--worker_hosts=" + ",".join([f"127.0.0.1:{port}"] * world),
        f"--logdir={logdir}", f"--data_dir={data_dir}", "--batch_size=16",
        "--optimizer=adam", "--save_model_secs=100000", *extra])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train(tflags.FLAGS, mode="sync")
    return res, buf.getvalue()


def _loop_rank(rank, world, port, data_dir, work):
    """The ZeRO loop's runs on this rank:

    - ``stop``: --zero 3, rank 1 asks for a stop after step 6, the vote
      every 4 steps stops both at 8; the chief's checkpoint cadence is
      due at every step, and only the votes may act on it;
    - ``resume``: a replicated (JAX-written) checkpoint at step 5 resumed
      by --zero 1 and by a replicated run, to step 9;
    - ``device``: --device_data --zero 3 (and replicated) stopped at step
      6, off a chunk boundary, and resumed to 12.

    Records each fetch's step, each run's result and stdout."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.training import loop

    _join_group(rank, world, port)
    fetched = []
    fetch = loop.fetch_state_zero

    def recording_fetch(state, model, mesh, level):
        host = fetch(state, model, mesh, level)
        fetched.append((int(host.step), host))
        return host

    loop.fetch_state_zero = recording_fetch
    tick = loop._HostCoordinator.tick

    def stopping_tick(self, step):
        if rank == 1 and step >= 6:
            self._sv.request_stop()
        return tick(self, step)

    due = tckpt.Checkpointer.cadence_due
    record = {}
    loop._HostCoordinator.tick = stopping_tick
    tckpt.Checkpointer.cadence_due = lambda self: self.is_chief
    try:
        res, out = _train(rank, world, port, os.path.join(work, "stop"),
                          data_dir, "--zero=3", "--training_iter=40",
                          "--display_step=4", "--coord_steps=4")
    finally:
        loop._HostCoordinator.tick = tick
        tckpt.Checkpointer.cadence_due = due
    record["stop"] = {"final_step": res.final_step, "stdout": out,
                      "fetched": [s for s, _ in fetched],
                      "test_metrics": res.test_metrics}
    np.savez(os.path.join(work, f"stop-final{rank}.npz"),
             **flatten_pytree(fetched[-1][1]))

    for name, level in (("resume-z1", 1), ("resume-dp", 0)):
        res, _ = _train(rank, world, port, os.path.join(work, name),
                        data_dir, f"--zero={level}", "--training_iter=9",
                        "--display_step=4", "--test_eval=false")
        record[name] = {"final_step": res.final_step}
    for name, level in (("device-z3", 3), ("device-dp", 0)):
        for stop in (6, 12):
            res, _ = _train(rank, world, port, os.path.join(work, name),
                            data_dir, f"--zero={level}", "--device_data",
                            "--device_chunk=4", "--display_step=4",
                            f"--training_iter={stop}", "--test_eval=false")
        record[name] = {"final_step": res.final_step}
    with open(os.path.join(work, f"loop{rank}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()


def test_zero_loop_fetches_together_saves_standard_layout_and_resumes(
        tmp_path):
    """Two ranks through ``train(FLAGS, mode="sync")``:

    - --zero 3 stops on one step on both ranks, and both fetch at the
      same steps (the start, the votes at 1 and 4, the stop at 8)
      although the chief's cadence is due at every step; the chief's
      checkpoint is the standard layout, equal to the fetched state, and
      the JAX package's ``restore_with_fallback`` reads it bitwise; only
      the chief prints ``test accuracy:``;
    - a JAX-written replicated checkpoint resumes into --zero 1, which
      ends bitwise where the replicated run from it ends;
    - --device_data --zero 3 resumed from step 6, off a chunk boundary,
      ends bitwise where the replicated run resumed the same way ends."""
    import jax

    from distributed_tensorflow_tpu.checkpoint import (
        checkpoint as jckpt,
    )
    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.training import train_state as jts

    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    work = str(tmp_path)
    jstate = jts.create_train_state(JaxDeepCNN(), jts.adam(LR), seed=3)
    jckpt.save_checkpoint(str(tmp_path / "resume-z1"), jstate, 5)
    shutil.copytree(tmp_path / "resume-z1", tmp_path / "resume-dp")
    _spawn(_loop_rank, 2, free_port(), data_dir, work)

    records = [json.load(open(tmp_path / f"loop{r}.json")) for r in (0, 1)]
    stop = [r["stop"] for r in records]
    assert [s["final_step"] for s in stop] == [8, 8]
    # the start; the first vote (step 1), which carries the chief's
    # cadence; the display and the vote at 4; the agreed stop at 8
    assert stop[0]["fetched"] == stop[1]["fetched"] == [0, 1, 4, 8]
    assert stop[0]["stdout"].count("test accuracy: ") == 1
    assert "test accuracy" not in stop[1]["stdout"]
    assert stop[1]["test_metrics"] is None
    logdir = str(tmp_path / "stop")
    assert tckpt.latest_checkpoint(logdir)[1] == 8
    saved = tckpt.load_flat(os.path.join(logdir, "ckpt-8.npz"))
    final = [dict(np.load(tmp_path / f"stop-final{r}.npz")) for r in (0, 1)]
    _assert_bitwise(final[1], final[0], "the ranks' fetched states")
    _assert_bitwise(saved, final[0], "the checkpoint vs the fetched state")
    assert saved["params/weights/wd1"].shape == (3136, 1024)
    assert saved["opt_state/m/biases/out"].shape == (10,)
    template = jts.create_train_state(JaxDeepCNN(), jts.adam(LR), seed=9)
    jrestored, jstep, _ = jckpt.restore_with_fallback(logdir, template)
    assert jstep == 8
    for path, leaf in jax.tree_util.tree_flatten_with_path(jrestored)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), saved[key],
                                      err_msg=key)

    for a, b in (("resume-z1", "resume-dp"), ("device-z3", "device-dp")):
        assert [r[a]["final_step"] for r in records] == \
            [r[b]["final_step"] for r in records] == [9 if "resume" in a
                                                      else 12] * 2
        want_step = 9 if "resume" in a else 12
        got = tckpt.load_flat(os.path.join(work, a, f"ckpt-{want_step}.npz"))
        want = tckpt.load_flat(os.path.join(work, b,
                                            f"ckpt-{want_step}.npz"))
        _assert_bitwise(got, want, f"{a} vs {b}")
        with open(os.path.join(work, a, "metrics.jsonl")) as f:
            restores = [json.loads(line).get("recovery_restore_step")
                        for line in f]
        assert (5 if "resume" in a else 6) in restores


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_zero_device_steps_equal_the_replicated_device_step_on_card(bf16):
    """A one-rank NCCL group: the ZeRO device steps (levels 1 and 3, and 3
    overlapped), replayed from CUDA graphs, against the replicated device
    step's replays on the same draws, bitwise under cuDNN's
    deterministic algorithms (at one rank the collectives are copies)."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import cluster
    from distributed_tensorflow_tpu_torch.data import synthetic_digits
    from distributed_tensorflow_tpu_torch.parallel import make_mesh
    from distributed_tensorflow_tpu_torch.training.device_step import (
        make_device_dp_train_step,
        make_zero_device_train_step,
    )
    from distributed_tensorflow_tpu_torch.utils.pytree import params_to_numpy

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cluster.ClusterSpec({"worker": [f"127.0.0.1:{free_port()}"]})
    cluster.maybe_initialize_distributed(spec, 0, "cuda")
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        mesh = make_mesh("cuda")
        x, y = synthetic_digits(512, seed=3)
        data = put_device_data(DataSet(x, y), "cuda")
        for name, level, overlap in (("dp", 0, False), ("z1", 1, False),
                                     ("z3", 3, False), ("z3o", 3, True)):
            model = DeepCNN(compute_dtype=torch.bfloat16 if bf16 else None,
                            use_pallas=True)
            opt = tts.adam(LR)
            state = tts.create_train_state(model, opt, seed=0,
                                           device="cuda")
            state = state._replace(step=state.step.cuda())
            if level:
                state = zero.shard_state_zero(state, mesh, level)
                step_fn = make_zero_device_train_step(
                    model, opt, mesh, level, data, 128, keep_prob=0.75,
                    overlap=overlap)
            else:
                step_fn = make_device_dp_train_step(model, opt, mesh, data,
                                                    128, keep_prob=0.75)
            losses = []
            for s in range(8):
                state, m = step_fn(state, s, 1)
                losses.append(float(m["loss"]))
            if level:
                state = zero.fetch_state_zero(state, model, mesh, level)
            runs[name] = (losses, flatten_pytree(state),
                          params_to_numpy(model))
    finally:
        torch.backends.cudnn.deterministic = False
        dist.destroy_process_group()
    losses, flat, _ = runs["dp"]
    for name in ("z1", "z3", "z3o"):
        assert runs[name][0] == losses, name
        _assert_bitwise(runs[name][1], flat, name)
