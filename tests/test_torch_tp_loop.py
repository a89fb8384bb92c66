"""``--model_axis`` through the port's training entry on the CPU: one
``mnist_dist`` process per gloo rank, as a user launches it.

A 1x2 grid trains deep_cnn (adam, dropout on) and must equal a one-rank
run loss for loss (each rank keeps its columns of the one-rank run's
dropout mask, and both read the same batches); only task 0 prints the
reference's lines and the test accuracy; the grid writes a sharded set.
Resumes cross the layouts: the grid's sharded set and the one-rank
run's monolithic file are each resumed by a grid and by one rank, and
the two go on to the same losses. The flags the model axis does not compose with exit
2 at the command line, and a model with no split rule is refused with
the JAX package's message. Losses agree at rtol 1e-5 (only the split
matmuls' sums are reordered)."""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(ranks: int, logdir: str, data_dir: str, steps: int):
    """``ranks`` entry-point processes (1 = a local run, 2 = a 1x2 grid)
    training to ``steps``; returns each one's stdout, checked exit 0."""
    hosts = ",".join([f"127.0.0.1:{free_port()}"] * ranks)
    common = ["--device", "cpu", "--training_iter", str(steps),
              "--display_step", "1", "--batch_size", "16", "--optimizer",
              "adam", "--keep_prob", "0.75", "--save_model_secs", "100000",
              "--logdir", logdir, "--data_dir", data_dir]
    if ranks > 1:
        common += ["--mode", "sync", "--model_axis", str(ranks),
                   "--worker_hosts", hosts]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         *common, "--task_index", str(i)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    return [out for out, _ in outs]


def _losses(logdir: str) -> dict:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["mini_batch_loss"] for r in recs
            if "mini_batch_loss" in r}


def test_grid_trains_like_one_rank_and_resumes_across_layouts(tmp_path):
    from tests.test_torch_parallel import write_mnist_idx

    data = write_mnist_idx(str(tmp_path / "mnist"), n_train=256,
                           n_test=64)
    grid, one = str(tmp_path / "grid"), str(tmp_path / "one")
    outs = _launch(2, grid, data, 6)
    one_out = _launch(1, one, data, 6)[0]
    # the reference's stdout comes from task 0 only
    assert "job: worker/0 step:  0 mini_batch loss:  " in outs[0]
    assert "job: worker/1" not in outs[1]
    assert outs[0].count("test accuracy: ") == 1
    assert "test accuracy" not in outs[1]
    assert "Optimization Finished!" in outs[1].splitlines()
    names = sorted(os.listdir(grid))
    shards = [n for n in names if ".shard" in n]
    assert len(shards) == 2 and all(n.startswith("ckpt-6.shard") for n in
                                    shards)
    got, want = _losses(grid), _losses(one)
    assert sorted(got) == sorted(want) == list(range(6))
    np.testing.assert_allclose([got[s] for s in range(6)],
                               [want[s] for s in range(6)], rtol=1e-5)
    # the grid's test accuracy is the one-rank run's
    acc = [float(line.split()[2]) for out in (outs[0], one_out)
           for line in out.splitlines() if line.startswith("test accuracy")]
    assert abs(acc[0] - acc[1]) <= 1 / 64

    # cross resumes, each to step 10: the grid's sharded set resumed by a
    # grid and by one rank, the one-rank monolithic file resumed by both
    for src in (grid, one):
        runs = {}
        for ranks in (2, 1):
            d = str(tmp_path / f"{os.path.basename(src)}-by-{ranks}")
            shutil.copytree(src, d)
            _launch(ranks, d, data, 10)
            runs[ranks] = _losses(d)
            with open(os.path.join(d, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            assert [r["recovery_restore_step"] for r in recs
                    if "recovery_restore_step" in r][-1] == 6.0
            assert tckpt.latest_checkpoint(d)[1] == 10
            assert any(n.startswith("ckpt-10.shard") for n in os.listdir(d)
                       ) == (ranks == 2)
        np.testing.assert_allclose([runs[2][s] for s in range(6, 10)],
                                   [runs[1][s] for s in range(6, 10)],
                                   rtol=1e-5)


@pytest.fixture
def port_flags():
    flags.define_reference_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


@pytest.mark.parametrize("argv,msg", [
    (["--mode", "local"], "requires sync mode"),
    ([], "requires sync mode"),
    (["--mode", "sync", "--zero", "1"], "--zero=1 with --model_axis"),
    (["--mode", "sync", "--device_data"], "--device_data with"),
    (["--mode", "sync", "--model", "lm", "--dataset", "lm",
      "--moe_experts", "2"], "--moe_experts with"),
    (["--job_name", "worker", "--ps_hosts", "127.0.0.1:1"],
     "the ps topology"),
], ids=["local", "auto-one-worker", "zero", "device_data", "moe", "ps"])
def test_model_axis_refusals_exit_2(port_flags, capsys, argv, msg):
    from distributed_tensorflow_tpu_torch import mnist_dist

    with pytest.raises(SystemExit) as e:
        flags.run(mnist_dist.main, argv=[
            "--device", "cpu", "--model_axis", "2", "--worker_hosts",
            "127.0.0.1:1", *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_model_without_a_split_rule_is_refused_with_jax_message(
        port_flags, tmp_path):
    """--model mlp under a model axis: the JAX loop's refusal, word for
    word; and a grid the group cannot fill."""
    from types import SimpleNamespace

    from distributed_tensorflow_tpu import flags as jflags
    from distributed_tensorflow_tpu.training.loop import train as jtrain
    from distributed_tensorflow_tpu_torch.models import MLP
    from distributed_tensorflow_tpu_torch.parallel import MeshSpec
    from distributed_tensorflow_tpu_torch.training import loop
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from tests.test_torch_parallel import write_mnist_idx

    data = write_mnist_idx(str(tmp_path / "mnist"), n_train=32, n_test=16)
    jflags.define_reference_flags()
    jflags.FLAGS._reset()
    try:
        jflags.FLAGS._parse([f"--logdir={tmp_path}/j", f"--data_dir={data}",
                             "--model=mlp", "--model_axis=2"])
        with pytest.raises(ValueError) as want:
            jtrain(jflags.FLAGS, mode="sync")
    finally:
        jflags.FLAGS._reset()
    state = tts.create_train_state(MLP(), tts.sgd(0.1))
    with pytest.raises(ValueError) as got:
        loop._check_tp(SimpleNamespace(model="mlp", batch_size=128), state,
                       SimpleNamespace(model=2, data=1), 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1 "
                                         "devices"):
        MeshSpec(model=2).resolve(1)
