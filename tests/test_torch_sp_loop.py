"""``--seq_parallel`` through the port's training entry on the CPU: one
``mnist_dist`` process per gloo rank, as a user launches it.

A 1x2 grid trains the LM (V 16, S 32) and the row-sequence classifier
(on a small MNIST-format split) with dropout off, each beside a one-rank
dense run of the same flags: the losses agree at rtol 1e-5 (the ring
folds the key blocks in another order than the dense softmax); only
task 0 prints the reference's lines and the test accuracy, which is the
JAX package's ``evaluate`` of the saved parameters on the same split
within 1e-4. The checkpoint is the one-process format: JAX's
``restore_with_fallback`` reads it, and a dense one-rank run resumes it.
Every refusal of the JAX package exits 2 at the command line with its
message, and a rank without a card exits non-zero."""

import json
import os
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
STEPS, RESUME = 6, 8
FAMILIES = {
    "lm": ["--model", "lm", "--dataset", "lm", "--seq_len", "32",
           "--vocab_size", "16", "--d_model", "32", "--num_heads", "2",
           "--num_blocks", "2", "--learning_rate", "0.003"],
    "transformer": ["--model", "transformer", "--d_model", "32",
                    "--num_heads", "2", "--num_blocks", "2"],
}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(ranks: int, family: str, logdir: str, data_dir: str,
           steps: int):
    """``ranks`` entry-point processes (1 = a local dense run, 2 = a 1x2
    SP grid) of ``family``, started."""
    hosts = ",".join([f"127.0.0.1:{free_port()}"] * ranks)
    common = ["--device", "cpu", *FAMILIES[family], "--training_iter",
              str(steps), "--display_step", "1", "--batch_size", "8",
              "--optimizer", "adam", "--keep_prob", "1.0",
              "--save_model_secs", "100000", "--logdir", logdir,
              "--data_dir", data_dir]
    if ranks > 1:
        common += ["--mode", "sync", "--seq_parallel", "--model_axis",
                   str(ranks), "--worker_hosts", hosts]
    return [subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         *common, "--task_index", str(i)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(ranks)]


def _finish(procs) -> list[str]:
    """Each process's stdout, checked exit 0."""
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


def _records(logdir: str, key: str) -> dict:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in recs if key in r}


def _test_accuracy(out: str) -> float:
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("test accuracy:")]
    return float(line.split()[2])


def _jax_restore_and_evaluate(family: str, logdir: str, data_dir: str):
    """The step JAX's ``restore_with_fallback`` reads from ``logdir``
    and its ``evaluate`` of those parameters on the JAX package's own
    split of the same seed."""
    from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
    from distributed_tensorflow_tpu.data import read_data_sets
    from distributed_tensorflow_tpu.models import get_model
    from distributed_tensorflow_tpu.training import train_state as jts

    if family == "lm":
        ds = read_data_sets(data_dir, dataset="lm", seed=0, seq_len=32,
                            vocab_size=16)
        model = get_model("lm", vocab_size=16, seq_len=32, d_model=32,
                          num_heads=2, num_blocks=2)
        batch = (1 << 18) // 32
    else:
        ds = read_data_sets(data_dir, one_hot=True, seed=0)
        model = get_model("transformer", d_model=32, num_heads=2,
                          num_blocks=2)
        batch = 1000
    template = jts.create_train_state(model, jts.adam(1e-3), seed=0)
    state, step, _ = jckpt.restore_with_fallback(logdir, template)
    return step, jts.evaluate(model, state.params, ds.test,
                              batch_size=batch)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_grid_trains_like_one_rank_and_its_checkpoint_crosses(tmp_path,
                                                              family):
    from tests.test_torch_parallel import write_mnist_idx

    data = write_mnist_idx(str(tmp_path / "mnist"), n_train=128, n_test=64)
    grid, one = str(tmp_path / "grid"), str(tmp_path / "one")
    procs = _start(2, family, grid, data, STEPS)
    procs += _start(1, family, one, data, STEPS)
    outs = _finish(procs)
    # the reference's stdout comes from task 0 only
    assert "job: worker/0 step:  0 mini_batch loss:  " in outs[0]
    assert "job: worker/" not in outs[1]
    assert outs[0].count("test accuracy: ") == 1
    assert "test accuracy" not in outs[1]
    assert "Optimization Finished!" in outs[1].splitlines()
    got, want = (_records(d, "mini_batch_loss") for d in (grid, one))
    assert sorted(got) == sorted(want) == list(range(STEPS))
    np.testing.assert_allclose([got[s] for s in range(STEPS)],
                               [want[s] for s in range(STEPS)], rtol=1e-5)
    # the one-process format, which JAX restores and evaluates to the
    # printed test accuracy
    assert sorted(n for n in os.listdir(grid) if n.endswith(".npz")) == [
        f"ckpt-{STEPS}.npz"]
    step, jm = _jax_restore_and_evaluate(family, grid, data)
    assert step == STEPS
    assert abs(_test_accuracy(outs[0]) - jm["accuracy"]) <= 1e-4
    assert abs(_test_accuracy(outs[0]) - _test_accuracy(outs[2])) <= 1e-4
    # a dense one-rank run resumes the grid's checkpoint
    _finish(_start(1, family, grid, data, RESUME))
    assert _records(grid, "recovery_restore_step")[STEPS] == STEPS
    assert tckpt.latest_checkpoint(grid)[1] == RESUME


@pytest.fixture
def port_flags():
    flags.define_reference_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


TWO = "127.0.0.1:1,127.0.0.1:1"
LM = ["--model", "lm", "--dataset", "lm", "--seq_len", "32"]


@pytest.mark.parametrize("argv,msg", [
    (["--sp_span_hosts"], "--sp_span_hosts only applies with "
                          "--seq_parallel"),
    (["--seq_parallel", *LM, "--zero", "1"],
     "--zero=1 with --seq_parallel is not supported"),
    (["--seq_parallel", "--model", "deep_cnn"],
     "--seq_parallel requires --model transformer or lm"),
    (["--seq_parallel", *LM, "--attn_block", "8"],
     "--attn_block (local blockwise attention) and --seq_parallel"),
    (["--seq_parallel", *LM, "--moe_experts", "2"],
     "--moe_experts with --seq_parallel is not supported"),
    (["--seq_parallel", "--model", "transformer", "--augment"],
     "--augment is not supported with --seq_parallel"),
    (["--seq_parallel", *LM, "--device_data"],
     "--device_data with --seq_parallel is not yet ported"),
    (["--seq_parallel", *LM, "--model_axis", "1"],
     "--model_axis=1 shards nothing"),
    (["--seq_parallel", "--model", "transformer", "--model_axis", "3",
      "--worker_hosts", "127.0.0.1:1,127.0.0.1:1,127.0.0.1:1"],
     "sequence length 28 must divide into --model_axis=3 token blocks"),
    (["--seq_parallel", *LM, "--mode", "local"],
     "--seq_parallel requires sync mode"),
    (["--seq_parallel", *LM, "--worker_hosts",
      "127.0.0.1:1,localhost:1"], "puts devices from multiple hosts on "
                                  "one token-axis row"),
    (["--seq_parallel", *LM, "--batch_size", "7", "--worker_hosts",
      ",".join(["127.0.0.1:1"] * 4)], "--batch_size=7 must be divisible "
                                      "by the 2-way data axis"),
], ids=["span-alone", "zero", "model", "attn_block", "moe", "augment",
        "device_data", "model_axis-1", "indivisible", "local", "two-hosts",
        "batch"])
def test_refusals_exit_2_with_the_jax_message(port_flags, capsys, argv,
                                              msg):
    from distributed_tensorflow_tpu_torch import mnist_dist

    with pytest.raises(SystemExit) as e:
        flags.run(mnist_dist.main, argv=[
            "--device", "cpu", "--mode", "sync", "--model_axis", "2",
            "--worker_hosts", TWO, *argv])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_refusals_are_the_jax_loop_messages_and_guard_the_library(
        port_flags, tmp_path):
    """The messages are the JAX loop's, word for word, and ``train``
    refuses them too (a library caller whose flags were never
    validated); --sp_span_hosts lets a row span two hosts."""
    from distributed_tensorflow_tpu import flags as jflags
    from distributed_tensorflow_tpu.training.loop import train as jtrain
    from distributed_tensorflow_tpu_torch.training.loop import train

    jflags.define_reference_flags()
    for extra in (["--model=deep_cnn", "--model_axis=2"],
                  ["--model=transformer", "--model_axis=1"],
                  ["--model=transformer", "--model_axis=8"],
                  ["--model=transformer", "--model_axis=2", "--augment"]):
        argv = [f"--logdir={tmp_path}/logs", f"--data_dir={tmp_path}/none",
                "--training_iter=4", "--batch_size=32", "--seq_parallel",
                *extra]
        jflags.FLAGS._reset()
        try:
            jflags.FLAGS._parse(argv)
            with pytest.raises(ValueError) as want:
                jtrain(jflags.FLAGS, mode="sync")
        finally:
            jflags.FLAGS._reset()
        port_flags._reset()
        port_flags._parse(["--device=cpu", "--mode=sync",
                           f"--worker_hosts={TWO}"]
                          + [a for a in argv if a != "--seq_parallel"])
        port_flags.seq_parallel = True  # past the parse-time check
        with pytest.raises(ValueError) as got:
            train(port_flags, mode="sync")
        assert str(got.value) == str(want.value)
    port_flags._reset()
    port_flags._parse(["--device=cpu", "--mode=sync", "--seq_parallel",
                       *LM, "--model_axis=2", "--sp_span_hosts",
                       "--worker_hosts=127.0.0.1:1,localhost:1"])
    assert port_flags.sp_span_hosts


def test_an_sp_rank_without_a_card_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         *FAMILIES["lm"], "--mode", "sync", "--seq_parallel", "--model_axis",
         "2", "--worker_hosts", TWO, "--task_index", "0", "--logdir",
         str(tmp_path / "logs")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode not in (0, 2)
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "Optimization Finished!" not in proc.stdout
