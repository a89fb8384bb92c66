"""The port's inspect CLI and ``--eval_only`` against the JAX package's on
the same checkpoints: the same output lines and exit codes on both
formats, and a stateful model (ResNet-20) evaluated from its stored
batch-norm stats to JAX's accuracy and loss (rtol 1e-4: the same
float32 forward in another summation order)."""

import io
import os

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import flags as jflags
from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.checkpoint import inspect as jinspect
from distributed_tensorflow_tpu.data import datasets as jdata
from distributed_tensorflow_tpu.models.resnet import ResNet20 as JaxResNet20
from distributed_tensorflow_tpu.training import adam as jadam
from distributed_tensorflow_tpu.training import create_train_state
from distributed_tensorflow_tpu.training.loop import (
    evaluate_only as jevaluate_only,
)
from distributed_tensorflow_tpu_torch import flags as tflags
from distributed_tensorflow_tpu_torch.checkpoint import inspect as tinspect
from distributed_tensorflow_tpu_torch.data import datasets as tdata
from distributed_tensorflow_tpu_torch.training.loop import (
    evaluate_only as tevaluate_only,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)


def _logdir(tmp_path, layout):
    """A logdir of one layout: a full TrainState (monolithic), the ps
    mode's params-only state with a bf16 leaf (monolithic), or a sharded
    set beside an older monolithic step."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN

    d = str(tmp_path / layout)
    state = create_train_state(JaxDeepCNN(), jadam(1e-3), seed=0)
    if layout == "trainstate":
        jckpt.save_checkpoint(d, state, 7)
    elif layout == "params_only":
        jckpt.save_checkpoint(d, {"params": state.params, "step": 9,
                                  "half": jax.numpy.ones(
                                      (2, 3), jax.numpy.bfloat16)}, 9)
    else:
        jckpt.save_checkpoint(d, {"params": state.params, "step": 3}, 3)
        mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))
        wd1 = jax.device_put(state.params["weights"]["wd1"],
                             NamedSharding(mesh, P("data", None)))
        jckpt.save_checkpoint_sharded(d, {"params": {**state.params,
                                                     "weights": {
            **state.params["weights"], "wd1": wd1}}, "step": 11}, 11)
    return d


def _both(fn_name, *args):
    outs = []
    for mod in (jinspect, tinspect):
        buf = io.StringIO()
        rc = getattr(mod, fn_name)(*args, out=buf)
        outs.append((rc, buf.getvalue()))
    return outs


@pytest.mark.parametrize("layout", ["trainstate", "params_only", "sharded"])
def test_inspect_prints_what_jax_prints(tmp_path, layout, capsys):
    d = _logdir(tmp_path, layout)
    path = jckpt.latest_checkpoint(d)[0]
    for key in (None, "params/weights/wd1", "half", "no/such"):
        if key == "half" and layout != "params_only":
            continue
        (jrc, jout), (trc, tout) = _both("describe", path, key)
        jerr = capsys.readouterr().err
        assert (trc, tout) == (jrc, jout)
        assert jerr.count("error: no array") == 2 * (key == "no/such")
    assert "total elements (excl. step): " in tout
    (jrc, jout), (trc, tout) = _both("verify_logdir", d)
    assert (trc, tout) == (jrc, jout) and trc == 0
    assert tinspect.main(["--logdir", d]) == 0
    assert tinspect.main(["--verify", "--logdir", d]) == 0


@pytest.mark.parametrize("damage", ["corrupt_newest", "corrupt_older",
                                    "orphan_shard", "empty"])
def test_inspect_verify_exit_codes_equal_jax(tmp_path, damage):
    d = _logdir(tmp_path, "sharded")
    newest, _ = jckpt.latest_checkpoint(d)
    if damage == "corrupt_newest":
        target = newest
    elif damage == "corrupt_older":
        target = os.path.join(d, "ckpt-3.npz")
    if damage.startswith("corrupt"):
        raw = bytearray(open(target, "rb").read())
        raw[len(raw) // 3] ^= 0xFF
        open(target, "wb").write(bytes(raw))
    elif damage == "orphan_shard":
        open(os.path.join(d, "ckpt-12.shard1-of-2.npz"), "wb").close()
        open(os.path.join(d, "x.corrupt"), "wb").close()
    else:
        d = str(tmp_path / "none")
        os.makedirs(d)
    (jrc, jout), (trc, tout) = _both("verify_logdir", d)
    assert (trc, tout) == (jrc, jout)
    assert trc == (0 if damage in ("corrupt_older", "orphan_shard") else 1)


@pytest.fixture
def small_cifar(monkeypatch):
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "SYNTHETIC_TRAIN", 200)
        monkeypatch.setattr(mod, "SYNTHETIC_TEST", 120)


def _eval_flags(flags_mod, logdir, tmp_path, *extra):
    flags_mod.define_reference_flags()
    flags_mod.FLAGS._reset()
    flags_mod.FLAGS._parse([
        "--eval_only", "--model=resnet20", "--dataset=cifar10",
        f"--logdir={logdir}", f"--data_dir={tmp_path}/no-data", *extra])
    return flags_mod.FLAGS


def test_eval_only_of_a_resnet_restores_model_state(tmp_path, small_cifar):
    """A JAX-written ResNet-20 checkpoint whose batch-norm stats moved
    evaluates through the port's --eval_only to JAX's accuracy and loss;
    the same params without ``model_state`` are refused with the
    reference's ValueError in both packages."""
    from distributed_tensorflow_tpu.training import make_train_step

    jm = JaxResNet20()
    state = create_train_state(jm, jadam(1e-3), seed=3)
    step = make_train_step(jm, jadam(1e-3), donate=False)
    r = np.random.default_rng(3)
    for _ in range(3):
        x = r.random((16, 32, 32, 3), dtype=np.float32)
        state, _ = step(state, (x, r.integers(0, 10, 16).astype(np.int32)))
    assert float(np.abs(np.asarray(
        state.model_state["stem"]["bn"]["mean"])).max()) > 0
    full, bare = str(tmp_path / "full"), str(tmp_path / "bare")
    jckpt.save_checkpoint(full, state, 3)
    jckpt.save_checkpoint(bare, {"params": state.params, "step": 3}, 3)
    try:
        want = jevaluate_only(_eval_flags(jflags, full, tmp_path))
        with pytest.raises(ValueError, match="has no model_state"):
            jevaluate_only(_eval_flags(jflags, bare, tmp_path))
    finally:
        jflags.FLAGS._reset()
    try:
        got = tevaluate_only(_eval_flags(tflags, full, tmp_path,
                                         "--device=cpu"))
        with pytest.raises(ValueError, match="has no model_state"):
            tevaluate_only(_eval_flags(tflags, bare, tmp_path,
                                       "--device=cpu"))
    finally:
        tflags.FLAGS._reset()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], rtol=1e-4)
