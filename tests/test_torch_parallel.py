"""The port's synchronous data parallelism on ``torch.distributed`` (gloo,
one process per rank on the CPU) against the JAX package's
``make_dp_train_step`` on a slice of the tests' virtual CPU mesh and
against the port's single-process step; the sync loops' stop vote; the
cluster bootstrap.

Tolerances: the ranks' mean of per-slice gradients is the global batch's
gradient summed in another order, and JAX reorders float32 sums through
conv, matmul and softmax besides; compounded over 5 adam steps, losses
agree at rtol 1e-4 and parameters under the adam rule of
``tests/test_torch_train_state.py`` (a weight whose gradient is summation
noise moves by up to lr a step either way). The replicas of one run must
be bitwise equal.

The rank processes are spawned and import this module, so it imports
JAX only inside the tests that run in the parent."""

import json
import multiprocessing
import os
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import synthetic_digits
from distributed_tensorflow_tpu_torch.utils.profiling import (
    Throughput,
    busy_share,
    collective_sync_cadence,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH, STEPS, LR = 16, 5, 1e-3
JOIN_S = 240  # a rank that has not finished by then has hung


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_idx(path, arr: np.ndarray):
    """One IDX file of uint8 ``arr`` (the MNIST on-disk format)."""
    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, arr.ndim]))
        f.write(struct.pack(f">{arr.ndim}i", *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def write_mnist_idx(data_dir, n_train=512, n_test=128):
    """A small MNIST-format split of procedural digits in ``data_dir``: a
    process loads it in milliseconds, where rendering the default 20,000
    synthetic digits takes seconds."""
    os.makedirs(data_dir, exist_ok=True)
    for stem, n, seed in (("train", n_train, 0), ("t10k", n_test, 1)):
        x, y = synthetic_digits(n, seed=seed)
        _write_idx(os.path.join(data_dir, f"{stem}-images-idx3-ubyte"),
                   np.round(x.reshape(n, 28, 28) * 255))
        _write_idx(os.path.join(data_dir, f"{stem}-labels-idx1-ubyte"), y)
    return data_dir


def _spawn(target, world: int, *args):
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes
    and wait for all; every rank must exit 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _join_group(rank, world, port):
    torch.set_num_threads(1)  # several ranks share the host's cores
    spec = cluster.ClusterSpec({"worker": [f"127.0.0.1:{port}"] * world})
    assert cluster.maybe_initialize_distributed(spec, rank, "cpu")


def _global_batches():
    x, y = synthetic_digits(STEPS * GLOBAL_BATCH, seed=5)
    yo = np.eye(10, dtype=np.float32)[y]
    return [(x[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH],
             yo[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH])
            for i in range(STEPS)]


def _dp_rank(rank, world, port, init_path, out_dir):
    """One rank of the fed DP trajectory: rank 0 starts from the JAX init
    (``init_path``), the others from a different init that
    ``replicate_state`` must overwrite."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        replicate_state,
    )
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        flatten_pytree,
    )

    _join_group(rank, world, port)
    mesh = make_mesh("cpu")
    model = DeepCNN()
    opt = tts.adam(LR)
    state = tts.create_train_state(model, opt, seed=rank)
    if rank == 0:
        init = np.load(init_path)
        model.load_state_dict({k: torch.from_numpy(init[k]) for k in init})
    state = replicate_state(mesh, state)
    step_fn = make_dp_train_step(model, opt, mesh, keep_prob=1.0)
    local = GLOBAL_BATCH // world
    losses = []
    for x, y in _global_batches():
        sl = slice(rank * local, (rank + 1) * local)
        state, m = step_fn(state, (torch.from_numpy(x[sl]),
                                   torch.from_numpy(y[sl])))
        losses.append(float(m["loss"]))
    flat = flatten_pytree(state)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             losses=np.asarray(losses), **flat)
    dist.destroy_process_group()


def _jax_dp_losses(world, jstate):
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
    from distributed_tensorflow_tpu.parallel.mesh import MeshSpec, make_mesh
    from distributed_tensorflow_tpu.training import train_state as jts

    mesh = make_mesh(MeshSpec(data=world), devices=jax.devices()[:world])
    state = jdp.replicate_state(mesh, jstate)
    step = jdp.make_dp_train_step(JaxDeepCNN(), jts.adam(LR), mesh,
                                  keep_prob=1.0, donate=False)
    losses = []
    for b in _global_batches():
        state, m = step(state, jdp.shard_batch(mesh, tuple(map(jnp.asarray,
                                                               b))))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


def _port_single_losses(init):
    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_to_numpy

    model, opt = DeepCNN(), tts.adam(LR)
    state = tts.create_train_state(model, opt, seed=0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    step = tts.make_train_step(model, opt, keep_prob=1.0)
    losses = []
    for b in _global_batches():
        state, m = step(state, tuple(map(torch.from_numpy, b)))
        losses.append(float(m["loss"]))
    return losses, params_to_numpy(model)


def _assert_adam_close(got: dict, want: dict):
    from distributed_tensorflow_tpu_torch.utils.pytree import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * STEPS * LR


@pytest.mark.parametrize("world", [2, 4])
def test_dp_trajectory_matches_jax_and_the_single_process_step(world,
                                                               tmp_path):
    import jax

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    jstate = jts.create_train_state(JaxDeepCNN(), jts.adam(LR), seed=0)
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params)).items()}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    _spawn(_dp_rank, world, free_port(), init_path, str(tmp_path))

    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for r in ranks[1:]:  # the replicas, bit for bit
        assert sorted(r) == sorted(ranks[0])
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]["losses"]
    assert int(ranks[0]["step"]) == STEPS
    want_jax, jparams = _jax_dp_losses(world, jstate)
    want_single, sparams = _port_single_losses(init)
    np.testing.assert_allclose(got, want_jax, rtol=1e-4)
    np.testing.assert_allclose(got, want_single, rtol=1e-4)
    params = {"weights": {}, "biases": {}}
    for k, v in ranks[0].items():
        if k.startswith("params/"):
            _, group, name = k.split("/")
            params[group][name] = v
    _assert_adam_close(params, jparams)
    _assert_adam_close(params, sparams)


def _cifar_global_batches():
    from distributed_tensorflow_tpu_torch.data import synthetic_cifar

    x, y = synthetic_cifar(STEPS * GLOBAL_BATCH, seed=5)
    x = x.astype(np.float64)
    yo = np.eye(10)[y]
    return [(x[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH],
             yo[i * GLOBAL_BATCH:(i + 1) * GLOBAL_BATCH])
            for i in range(STEPS)]


def _dp_resnet_rank(rank, world, port, init_path, out_dir):
    """One rank of the fed float64 ResNet-20 DP trajectory, from the JAX
    init in ``init_path`` (rank 0) or a fresh one (the others)."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch.models import ResNet
    from distributed_tensorflow_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        replicate_state,
    )
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        flatten_pytree,
    )

    _join_group(rank, world, port)
    mesh = make_mesh("cpu")
    model = ResNet().double()
    opt = tts.adam(LR)
    state = tts.create_train_state(model, opt, seed=rank)
    if rank == 0:
        init = np.load(init_path)
        model.load_state_dict({k: torch.from_numpy(init[k]) for k in init})
    state = replicate_state(mesh, state)
    step_fn = make_dp_train_step(model, opt, mesh, keep_prob=1.0)
    local = GLOBAL_BATCH // world
    losses = []
    for x, y in _cifar_global_batches():
        sl = slice(rank * local, (rank + 1) * local)
        state, m = step_fn(state, (torch.from_numpy(x[sl]),
                                   torch.from_numpy(y[sl])))
        losses.append(float(m["loss"]))
    np.savez(os.path.join(out_dir, f"resnet{rank}.npz"),
             losses=np.asarray(losses), **flatten_pytree(state))
    dist.destroy_process_group()


def test_resnet20_dp_matches_jax_and_the_replicas_stay_bitwise_equal(
        tmp_path):
    """Two gloo ranks of ResNet-20 (adam, global batch 16) against JAX's
    ``make_dp_train_step`` on two virtual CPU devices, from one JAX init:
    the gradients, the metrics and the batch-norm running stats averaged
    over the ranks in one collective. Both run in float64, at rtol 1e-4:
    in float32 batch norm at 8 examples a rank makes the early stages'
    gradients a small difference of large terms (the reasoning of
    ``tests/test_torch_resnet.py``). The two replicas, state and
    optimizer slots included, must be bitwise equal."""
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.resnet import ResNet as JaxResNet
    from distributed_tensorflow_tpu.parallel import data_parallel as jdp
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
        state = jdp.replicate_state(mesh, js)
        step = jdp.make_dp_train_step(jm, jopt, mesh, keep_prob=1.0,
                                      donate=False)
        want = []
        for b in _cifar_global_batches():
            state, m = step(state, jdp.shard_batch(
                mesh, tuple(map(jnp.asarray, b))))
            want.append(float(m["loss"]))
        jflat = {**{f"params/{k}": v for k, v in _flat(state.params)},
                 **{f"model_state/{k}": v
                    for k, v in _flat(state.model_state)}}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    _spawn(_dp_resnet_rank, world, free_port(), init_path, str(tmp_path))

    ranks = [dict(np.load(tmp_path / f"resnet{r}.npz"))
             for r in range(world)]
    assert sorted(ranks[1]) == sorted(ranks[0])
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    assert any(k.startswith("model_state/stage2/block2/bn2/")
               for k in ranks[0])
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-4)
    for k, v in jflat.items():
        assert ranks[0][k].dtype == np.float64
        np.testing.assert_allclose(ranks[0][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _flat(tree):
    import jax

    return [("/".join(str(getattr(p, "key", p)) for p in path),
             np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _loop_rank(rank, world, port, data_dir, logdir, device_data, stop_at,
               out_dir):
    """One rank of ``train(FLAGS, mode="sync")``; rank 1's supervisor asks
    for a stop at step ``stop_at``, as SIGTERM would. Writes the rank's
    final state and result into ``out_dir``."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import flags
    from distributed_tensorflow_tpu_torch.training import supervisor
    from distributed_tensorflow_tpu_torch.training.loop import train
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    _join_group(rank, world, port)
    seen = {}
    saved = supervisor.Supervisor.maybe_checkpoint

    def maybe_checkpoint(self, state, step):
        if rank == 1 and step == stop_at:
            self.request_stop()
        seen["state"] = state  # the live tensors: the final state at exit
        return saved(self, state, step)

    supervisor.Supervisor.maybe_checkpoint = maybe_checkpoint
    flags.define_reference_flags()
    flags.FLAGS._parse([
        "--device=cpu", "--mode=sync", f"--task_index={rank}",
        "--worker_hosts=" + ",".join([f"127.0.0.1:{port}"] * world),
        f"--logdir={logdir}", f"--data_dir={data_dir}",
        "--training_iter=40", "--batch_size=16", "--display_step=4",
        "--device_chunk=2", "--coord_steps=4", "--optimizer=adam",
        "--save_model_secs=100000", "--test_eval=false"]
        + (["--device_data"] if device_data else []))
    res = train(flags.FLAGS, mode="sync")
    np.savez(os.path.join(out_dir, f"loop{rank}.npz"),
             **flatten_pytree(seen["state"]))
    with open(os.path.join(out_dir, f"loop{rank}.json"), "w") as f:
        json.dump({"final_step": res.final_step, "n_chips": res.n_chips,
                   "display": res.train_metrics}, f)
    dist.destroy_process_group()


@pytest.mark.parametrize("device_data", [False, True])
def test_sync_loop_over_two_ranks_stops_together_and_the_chief_saves(
        tmp_path, device_data):
    """Two ranks train through ``train(FLAGS, mode="sync")``; rank 1 asks
    for a stop after step 6, the vote every 4 steps stops both at step 8,
    and the chief alone writes step 8, equal to both replicas."""
    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    logdir = str(tmp_path / "logs")
    _spawn(_loop_rank, 2, free_port(), data_dir, logdir, device_data, 6,
           str(tmp_path))
    results = [json.load(open(tmp_path / f"loop{r}.json")) for r in (0, 1)]
    assert [r["final_step"] for r in results] == [8, 8]
    assert [r["n_chips"] for r in results] == [2, 2]
    # the display metrics are averaged over the ranks: the same on both
    assert results[0]["display"] == results[1]["display"]
    states = [dict(np.load(tmp_path / f"loop{r}.npz")) for r in (0, 1)]
    assert tckpt.latest_checkpoint(logdir)[1] == 8
    saved = tckpt.load_flat(os.path.join(logdir, "ckpt-8.npz"))
    assert sorted(saved) == sorted(states[0]) == sorted(states[1])
    for k in saved:
        np.testing.assert_array_equal(states[0][k], saved[k], err_msg=k)
        np.testing.assert_array_equal(states[1][k], saved[k], err_msg=k)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        jobs = {json.loads(line)["job"] for line in f}
    assert jobs == {"worker/0"}  # only the chief logs


def _final_eval_rank(rank, world, port, data_dir, logdir, out_dir):
    """One rank of a sync run with the final test eval on; writes what
    ``train`` returned for the test metrics and what the rank printed."""
    import contextlib
    import io

    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import flags
    from distributed_tensorflow_tpu_torch.training.loop import train

    _join_group(rank, world, port)
    flags.define_reference_flags()
    flags.FLAGS._parse([
        "--device=cpu", "--mode=sync", f"--task_index={rank}",
        "--worker_hosts=" + ",".join([f"127.0.0.1:{port}"] * world),
        f"--logdir={logdir}", f"--data_dir={data_dir}",
        "--training_iter=2", "--batch_size=16", "--display_step=100",
        "--save_model_secs=100000"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train(flags.FLAGS, mode="sync")
    with open(os.path.join(out_dir, f"eval{rank}.json"), "w") as f:
        json.dump({"test_metrics": res.test_metrics,
                   "stdout": buf.getvalue()}, f)
    dist.destroy_process_group()


def test_only_the_chief_runs_the_final_test_eval(tmp_path):
    """In a 2-rank sync run the chief evaluates the test split and prints
    one ``test accuracy:`` line; rank 1 evaluates, prints and logs
    nothing and returns ``test_metrics`` None, as the reference's
    non-chief does."""
    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    logdir = str(tmp_path / "logs")
    _spawn(_final_eval_rank, 2, free_port(), data_dir, logdir,
           str(tmp_path))
    chief, other = (json.load(open(tmp_path / f"eval{r}.json"))
                    for r in (0, 1))
    assert chief["stdout"].count("test accuracy: ") == 1
    assert set(chief["test_metrics"]) == {"loss", "accuracy"}
    assert other["test_metrics"] is None
    assert "test accuracy" not in other["stdout"]
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["job"] for r in recs if "test_accuracy" in r] == ["worker/0"]


def test_entry_point_trains_sync_over_two_processes(tmp_path):
    """The reference's launch: one process per worker, the same command
    with its own --task_index."""
    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    logdir = str(tmp_path / "logs")
    hosts = ",".join([f"127.0.0.1:{free_port()}"] * 2)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         "--device", "cpu", "--mode", "sync", "--worker_hosts", hosts,
         "--task_index", str(i), "--training_iter", "4", "--display_step",
         "2", "--batch_size", "16", "--logdir", logdir, "--data_dir",
         data_dir], cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
        assert "Optimization Finished!" in out.splitlines()
    for i, (out, _) in enumerate(outs):
        assert f"job: worker/{i} step:  2 mini_batch loss:  " in out
    assert tckpt.latest_checkpoint(logdir)[1] == 4


def test_sync_mode_needs_the_process_group_the_flags_describe(tmp_path):
    from distributed_tensorflow_tpu_torch import flags
    from distributed_tensorflow_tpu_torch.training.loop import train

    flags.define_reference_flags()
    flags.FLAGS._reset()
    try:
        flags.FLAGS._parse(["--device=cpu", "--mode=sync",
                            "--worker_hosts=127.0.0.1:1",
                            f"--logdir={tmp_path}"])
        with pytest.raises(RuntimeError, match="maybe_initialize"):
            train(flags.FLAGS, mode="sync")
    finally:
        flags.FLAGS._reset()
    spec = cluster.ClusterSpec({"worker": ["127.0.0.1:1"]})
    with pytest.raises(ValueError, match="not one of the 1 workers"):
        cluster.maybe_initialize_distributed(spec, 1, "cpu")
    with pytest.raises(ValueError, match="needs --worker_hosts"):
        cluster.maybe_initialize_distributed(cluster.ClusterSpec(), 0, "cpu")
    assert cluster.backend_for("cuda:1") == "nccl"
    assert cluster.backend_for("cpu") == "gloo"


def test_initialize_with_retry_backs_off_then_raises():
    calls, sleeps = [], []

    def refuse():
        calls.append(1)
        raise ConnectionError("refused")

    with pytest.raises(ConnectionError):
        cluster._initialize_with_retry(refuse, retries=3, backoff_s=2.0,
                                       what="join", sleep=sleeps.append,
                                       cleanup_fn=lambda: calls.append(0))
    assert calls == [1, 0, 1, 0, 1, 0, 1]  # 4 attempts, cleaned up between
    assert sleeps == [2.0, 4.0, 6.0]
    attempts = []

    def second_time():
        attempts.append(1)
        if len(attempts) < 2:
            raise OSError("not yet")

    cluster._initialize_with_retry(second_time, retries=2, backoff_s=0.5,
                                   what="join", sleep=sleeps.append)
    assert len(attempts) == 2 and sleeps[-1] == 0.5
    with pytest.raises(ValueError):  # misconfiguration: no retry
        cluster._initialize_with_retry(
            lambda: (_ for _ in ()).throw(ValueError("bad address")),
            retries=5, backoff_s=1.0, what="join", sleep=sleeps.append)
    assert len(sleeps) == 4


def test_throughput_per_chip_and_the_sync_cadence(monkeypatch):
    from distributed_tensorflow_tpu_torch.utils import profiling

    clock = iter([10.0, 12.0, 12.0])  # reset, then one read per rate
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = Throughput(128, n_chips=4)
    meter.step()
    assert meter.images_per_sec == 64.0
    assert meter.images_per_sec_per_chip == 16.0
    assert collective_sync_cadence("gloo", 2) == 1
    assert collective_sync_cadence("gloo", 1) == 0
    assert collective_sync_cadence("nccl", 4) == 0


def _event(name, device_type, start, end):
    from types import SimpleNamespace

    return SimpleNamespace(name=name, device_type=device_type,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_share_over_the_marked_window():
    """Device time cut to the marked host event, whose device copy is
    not device time; without a mark, the whole trace's span."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kernels = [_event("k", cuda, a, b) for a, b in
               ((50, 150), (200, 300), (250, 350), (550, 700), (800, 950))]
    host = [_event("aten::mm", cpu, 0, 1000)]
    marked = [_event("steps", cpu, 100, 600), _event("steps", cuda, 150, 650)]
    # [100, 150] + [200, 350] + [550, 600] of [100, 600]
    assert busy_share(host + marked + kernels, window="steps") == 0.5
    # 100 + 150 + 150 + 150 of [0, 1000]
    assert busy_share(host + kernels) == 0.55
    assert busy_share(host + marked[:1] + kernels, window="steps") == \
        busy_share(host + marked + kernels, window="steps")
    assert busy_share(host + marked[:1], window="steps") is None


def test_profiled_window_marks_the_steps_on_the_cpu(tmp_path):
    """The loop's profiled window: one host event around the traced work,
    in the events and in the Chrome trace; no device, no busy share."""
    from distributed_tensorflow_tpu_torch.training import loop

    device = torch.device("cpu")
    prof = loop._start_profiler(device)
    a = torch.ones(32, 32)
    for _ in range(3):
        a = a @ a / 32
    assert loop._stop_profiler(prof, device, str(tmp_path)) is None
    events = prof.events()
    steps = [e for e in events if e.name == loop.PROFILED_STEPS]
    assert len(steps) == 1
    mms = [e for e in events if e.name == "aten::mm"]
    assert len(mms) == 3
    assert all(steps[0].time_range.start <= e.time_range.start
               and e.time_range.end <= steps[0].time_range.end for e in mms)
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)["traceEvents"]
    assert [e["cat"] for e in trace if e.get("name") == loop.PROFILED_STEPS] \
        == ["user_annotation"]
