"""The port's training slice as a whole against the JAX package's: both
``train`` loops from one JAX-written step-0 checkpoint, and the port's
entry point as a user runs it (CPU)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import flags as jflags
from distributed_tensorflow_tpu import native
from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.data import datasets as jdata
from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.models.resnet import ResNet20 as JaxResNet20
from distributed_tensorflow_tpu.training import adam as jadam
from distributed_tensorflow_tpu.training import create_train_state
from distributed_tensorflow_tpu.training.loop import train as jtrain
from distributed_tensorflow_tpu_torch import cluster
from distributed_tensorflow_tpu_torch import flags as tflags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.training.loop import train as ttrain

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


@pytest.fixture
def small_splits(monkeypatch):
    """Both packages' synthetic splits cut to 1200/300 examples."""
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "SYNTHETIC_TRAIN", 1200)
        monkeypatch.setattr(mod, "SYNTHETIC_TEST", 300)


@pytest.fixture
def port_flags():
    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    yield tflags.FLAGS
    tflags.FLAGS._reset()


def _argv(logdir, tmp_path, *extra):
    return [f"--logdir={logdir}", f"--data_dir={tmp_path}/no-data",
            f"--training_iter={STEPS}", "--batch_size=16",
            "--display_step=2", "--optimizer=adam", "--keep_prob=1",
            "--save_model_secs=100000", *extra]


def _display_losses(logdir):
    out = {}
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "mini_batch_loss" in rec:
                out[rec["step"]] = rec["mini_batch_loss"]
    return out


def _numpy_shuffle(monkeypatch):
    """Both packages on the JAX package's numpy epoch shuffle: its
    fallback when the native library is missing, put in the port's
    permutation's place, so the two loops draw the same batches."""
    monkeypatch.setattr(native, "permutation", lambda n, seed: None)
    monkeypatch.setattr(
        tdata, "permutation",
        lambda n, seed: np.random.default_rng(seed).permutation(n))


def test_train_matches_jax_from_one_checkpoint(tmp_path, small_splits,
                                               port_flags, capsys,
                                               monkeypatch):
    if not native.available():
        # the port copies the native shuffle only
        _numpy_shuffle(monkeypatch)
    _train_both_and_compare(tmp_path, port_flags, capsys)


def test_train_matches_jax_on_the_numpy_shuffle(tmp_path, small_splits,
                                                port_flags, capsys,
                                                monkeypatch):
    """The same comparison as where the JAX package's native library
    does not load, wherever it does."""
    _numpy_shuffle(monkeypatch)
    _train_both_and_compare(tmp_path, port_flags, capsys)


def _train_both_and_compare(tmp_path, port_flags, capsys):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    init = create_train_state(JaxDeepCNN(), jadam(1e-3), seed=0)
    for d in (jdir, tdir):
        jckpt.save_checkpoint(d, init, 0)

    jflags.define_reference_flags()
    jflags.FLAGS._reset()
    try:
        jflags.FLAGS._parse(_argv(jdir, tmp_path, "--mfu=false",
                                  "--async_checkpoint=false"))
        # mode passed explicitly: the 8 CPU devices of the tests would
        # upgrade --mode auto to sync
        jres = jtrain(jflags.FLAGS, mode="local")
    finally:
        jflags.FLAGS._reset()
    port_flags._parse(_argv(tdir, tmp_path, "--device=cpu"))
    tres = ttrain(port_flags)
    out = capsys.readouterr().out
    assert "job: worker/0 step:  0 mini_batch loss: " in out

    assert tres.final_step == jres.final_step == STEPS
    with open(os.path.join(tdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # the run's steady state, logged when the loop ends
    last = [r for r in recs if "step_device_s" in r][-1]
    assert last["step"] == STEPS and last["images_per_sec"] > 0
    assert {"step_host_wait_s", "step_dispatch_s"} <= set(last)
    jl, tl = _display_losses(jdir), _display_losses(tdir)
    assert sorted(tl) == sorted(jl) == [0, 2, 4]
    # reordered float32 sums compounded over adam steps: rtol 1e-4
    for step in jl:
        np.testing.assert_allclose(tl[step], jl[step], rtol=1e-4)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(tres.test_metrics[k],
                                   jres.test_metrics[k], rtol=1e-4, atol=1e-6)
    want = jckpt.load_flat(os.path.join(jdir, f"ckpt-{STEPS}.npz"))
    got = tckpt.load_flat(os.path.join(tdir, f"ckpt-{STEPS}.npz"))
    # the dropout key: JAX splits it every step, the port derives each
    # step's seed from it and the step and keeps it
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["rng"], np.asarray(init.rng))
    for k in want:
        if k == "rng":
            continue
        assert got[k].dtype == want[k].dtype, k
        if k.startswith("params/"):
            # adam: a weight whose gradient is summation noise moves by up
            # to lr a step either way (tests/test_torch_train_state.py)
            d = np.abs(got[k] - want[k])
            assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 2 * STEPS * 1e-3, k
        elif k != "opt_state/t" and k != "step":
            # the moments average gradients, sums whose terms cancel: their
            # error follows the array's scale, not each entry's
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                       atol=1e-4 * np.abs(want[k]).max())
        else:
            np.testing.assert_array_equal(got[k], want[k])


def test_resnet20_train_matches_jax_from_one_checkpoint(
        tmp_path, small_splits, port_flags, capsys, monkeypatch):
    """``--model resnet20 --dataset cifar10`` through both ``train``
    loops from one JAX step-0 checkpoint (6 adam steps, batch 16, no
    augmentation: the two packages draw crops from different generators).
    Display losses at rtol 1e-4; the test eval (which normalizes by the
    running stats) and the saved batch-norm state as stated below. The parameters are not compared entry by entry in
    float32: batch norm at batch 16 makes the early stages' gradients a
    small difference of large terms, and adam turns a sign flip there
    into a learning rate (``tests/test_torch_resnet.py`` holds the same
    trajectory in float64)."""
    _numpy_shuffle(monkeypatch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    init = create_train_state(JaxResNet20(), jadam(1e-3), seed=0)
    for d in (jdir, tdir):
        jckpt.save_checkpoint(d, init, 0)
    args = ("--model=resnet20", "--dataset=cifar10")
    jflags.define_reference_flags()
    jflags.FLAGS._reset()
    try:
        jflags.FLAGS._parse(_argv(jdir, tmp_path, *args, "--mfu=false",
                                  "--async_checkpoint=false"))
        jres = jtrain(jflags.FLAGS, mode="local")
    finally:
        jflags.FLAGS._reset()
    port_flags._parse(_argv(tdir, tmp_path, *args, "--device=cpu"))
    tres = ttrain(port_flags)
    assert "job: worker/0 step:  0 mini_batch loss: " in capsys.readouterr().out
    jl, tl = _display_losses(jdir), _display_losses(tdir)
    assert sorted(tl) == sorted(jl) == [0, 2, 4]
    for step in jl:
        np.testing.assert_allclose(tl[step], jl[step], rtol=1e-4)
    # the test eval reads the parameters those steps left, apart by up to
    # a learning rate in a few entries: its loss at rtol 1e-3, and at
    # most one of the 300 test predictions differs
    np.testing.assert_allclose(tres.test_metrics["loss"],
                               jres.test_metrics["loss"], rtol=1e-3)
    assert abs(tres.test_metrics["accuracy"]
               - jres.test_metrics["accuracy"]) <= 1 / 300 + 1e-6
    want = jckpt.load_flat(os.path.join(jdir, f"ckpt-{STEPS}.npz"))
    got = tckpt.load_flat(os.path.join(tdir, f"ckpt-{STEPS}.npz"))
    assert sorted(got) == sorted(want)
    stats = [k for k in want if k.startswith("model_state/")]
    assert len(stats) == 2 * 21
    for k in want:
        assert got[k].dtype == want[k].dtype, k
    for k in stats:
        # moments of activations of those parameters: 1e-2 of the scale
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-2 * np.abs(want[k]).max(),
                                   err_msg=k)
    np.testing.assert_array_equal(got["step"], want["step"])


def test_build_model_for_builds_the_ported_models(port_flags):
    from distributed_tensorflow_tpu_torch.models import MLP, ResNet
    from distributed_tensorflow_tpu_torch.training.loop import (
        augment_for,
        build_model_for,
    )

    cifar = {"image_size": 32, "channels": 3, "num_classes": 10}
    port_flags._parse(["--model=mlp", "--hidden_units=33"])
    m = build_model_for(port_flags, cifar)
    assert isinstance(m, MLP) and m.weights["h1"].shape == (3072, 33)
    assert augment_for(port_flags, cifar) is None
    for name, n in (("resnet20", 3), ("resnet32", 5), ("resnet", 3)):
        port_flags._reset()
        port_flags._parse([f"--model={name}", "--bf16", "--augment"])
        m = build_model_for(port_flags, cifar)
        assert isinstance(m, ResNet) and m.n == n
        assert m.compute_dtype is not None and m.stateful
        assert augment_for(port_flags, cifar) is not None
    for bad in (["--model=resnet20", "--pallas"],
                ["--dataset=lm", "--augment"], ["--augment_pad=-1"]):
        port_flags._reset()
        with pytest.raises(ValueError):
            port_flags._parse(bad)


def test_models_that_are_not_ported_raise(port_flags):
    from distributed_tensorflow_tpu_torch.models import (
        MiniTransformer,
        get_model,
    )
    from distributed_tensorflow_tpu_torch.training.loop import build_model_for

    # the transformer families and the LM's MoE blocks are ported now;
    # their sequence- and expert-parallel forms are not, and token data
    # still needs --model lm
    cifar = {"image_size": 32, "channels": 3, "num_classes": 10}
    port_flags._parse(["--model=transformer"])
    assert isinstance(build_model_for(port_flags, cifar), MiniTransformer)
    port_flags._reset()
    port_flags._parse([])
    with pytest.raises(ValueError, match="Use --model lm"):
        build_model_for(port_flags, {"kind": "lm"})
    assert get_model("lm", moe_experts=4).blocks[0].moe["w1"].shape[0] == 4
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get_model("transformer", seq_axis="model")
    port_flags._reset()
    port_flags._parse(["--model=lm", "--dataset=lm", "--moe_experts=4",
                       "--expert_parallel"])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model_for(port_flags, {"kind": "lm", "seq_len": 8,
                                     "vocab_size": 16})


def test_final_save_after_a_failed_eval_holds_one_step(
        tmp_path, small_splits, port_flags, monkeypatch):
    """A periodic eval that raises after step 3 ends the run; the final
    save must hold step 3's parameters, optimizer state and step together,
    as a run that stopped at step 3 saves them."""
    from distributed_tensorflow_tpu_torch.training import loop

    def failing_eval(*args, **kwargs):
        raise RuntimeError("eval failed")

    clean, failed = str(tmp_path / "clean"), str(tmp_path / "failed")
    port_flags._parse(_argv(clean, tmp_path, "--device=cpu",
                            "--training_iter=3", "--test_eval=false"))
    ttrain(port_flags)
    port_flags._reset()
    port_flags._parse(_argv(failed, tmp_path, "--device=cpu",
                            "--eval_step=3"))
    monkeypatch.setattr(loop, "evaluate", failing_eval)
    with pytest.raises(RuntimeError, match="eval failed"):
        ttrain(port_flags)
    assert tckpt.latest_checkpoint(failed)[1] == 3
    want = tckpt.load_flat(os.path.join(clean, "ckpt-3.npz"))
    got = tckpt.load_flat(os.path.join(failed, "ckpt-3.npz"))
    assert sorted(got) == sorted(want)
    assert int(got["step"]) == int(got["opt_state/t"]) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_flags_and_validators(port_flags):
    port_flags._parse([])
    assert (port_flags.batch_size, port_flags.training_iter,
            port_flags.learning_rate, port_flags.display_step,
            port_flags.optimizer, port_flags.keep_prob,
            port_flags.device) == (128, 10000, 0.001, 100, "sgd", 0.75, "cuda")
    for bad in (["--keep_prob=0"], ["--optimizer=rmsprop"],
                ["--training_iter=0"], ["--mode=mesh"], ["--job_name=chief"]):
        port_flags._reset()
        with pytest.raises(ValueError):
            port_flags._parse(bad)


def test_modes_that_are_not_ported_raise(port_flags):
    """Every mode is ported now: --ps_hosts resolves to ps mode, whose
    roles run in ``parallel.ps_emulation`` (``tests/test_torch_ps_
    emulation.py`` trains it), and ``train`` itself runs local and sync
    only; two workers resolve to sync."""
    port_flags._parse(["--ps_hosts=a:1", "--worker_hosts=b:1"])
    spec = cluster.ClusterSpec.from_flags(port_flags)
    assert cluster.resolve_mode(port_flags) == "ps"
    assert spec.task_address("ps", 0) == "a:1"
    with pytest.raises(ValueError, match="out of range"):
        spec.task_address("ps", 1)
    assert not hasattr(cluster, "require_ported")
    with pytest.raises(ValueError, match="ps_emulation"):
        ttrain(port_flags, mode="ps")
    port_flags._reset()
    port_flags._parse(["--worker_hosts=a:1,b:2"])
    assert cluster.resolve_mode(port_flags) == "sync"


def _run_entry(args, env=None, timeout=240):
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=env)


def test_entry_point_trains_on_the_cpu(tmp_path):
    proc = _run_entry(["--device", "cpu", "--training_iter", "3",
                       "--logdir", str(tmp_path / "logs"),
                       "--data_dir", str(tmp_path / "no-data")])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(line.startswith("job: worker/0 step:  0 mini_batch loss:  ")
               and " training accuracy:  " in line for line in lines)
    assert "Optimization Finished!" in lines
    assert any(line.startswith("test accuracy:  ") for line in lines)
    assert tckpt.latest_checkpoint(str(tmp_path / "logs"))[1] == 3


def test_eval_only_restores_params_and_measures_the_test_split(
        tmp_path, small_splits, port_flags, capsys):
    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.loop import evaluate_only

    model = DeepCNN()
    state = tts.create_train_state(model, tts.momentum(1e-3), seed=5)
    tckpt.save_checkpoint(str(tmp_path / "logs"), state, 12)
    port_flags._parse(["--device=cpu", "--eval_only",
                       f"--logdir={tmp_path}/logs",
                       f"--data_dir={tmp_path}/no-data"])
    got = evaluate_only(port_flags)
    want = tts.evaluate(model,
                        tdata.read_data_sets(str(tmp_path / "none")).test)
    assert got == want
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["step"] == 12 and last["test_accuracy"] == want["accuracy"]


def test_entry_point_without_a_card_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run_entry(["--training_iter", "3",
                       "--logdir", str(tmp_path / "logs")], env=env)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert "Optimization Finished!" not in proc.stdout


def test_entry_point_rejects_flags_of_paths_not_ported(tmp_path):
    proc = _run_entry(["--device", "cpu", "--seq_parallel",
                       "--logdir", str(tmp_path / "logs")])
    assert proc.returncode == 2
    assert "unknown flag" in proc.stderr and "--seq_parallel" in proc.stderr


def test_entry_point_trains_resnet20_on_cifar10_with_augment(tmp_path):
    """The slice's command line, on CIFAR-10 pickles written small."""
    from tests.test_torch_data import _write_cifar_pickles

    _write_cifar_pickles(str(tmp_path / "cifar"), n_train=16, n_test=20)
    proc = _run_entry(["--model", "resnet20", "--dataset", "cifar10",
                       "--augment", "--device", "cpu", "--training_iter",
                       "3", "--batch_size", "16", "--display_step", "2",
                       "--logdir", str(tmp_path / "logs"), "--data_dir",
                       str(tmp_path / "cifar")])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(line.startswith("job: worker/0 step:  2 mini_batch loss:  ")
               for line in lines)
    assert "Optimization Finished!" in lines
    assert any(line.startswith("test accuracy:  ") for line in lines)
    saved = tckpt.load_flat(os.path.join(str(tmp_path / "logs"),
                                         "ckpt-3.npz"))
    assert "model_state/stem/bn/mean" in saved
    assert np.abs(saved["model_state/stem/bn/mean"]).max() > 0
