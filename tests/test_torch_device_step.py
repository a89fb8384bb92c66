"""The port's device-resident step and loop against its host-fed step and
the JAX package's step, on the same numpy-seeded inputs (CPU); the CUDA
graph replay against eager device steps on the card (``cuda``).

On the CPU the device step runs eagerly. Fed an index stream, it must
take the host-fed step's arithmetic on the same uint8 batches: bitwise
equal, since the two run the same torch ops on the same inputs. Against
JAX, reordered float32 sums through conv, matmul and softmax compounded
over adam steps: losses at rtol 1e-4, parameters under the adam rule of
``tests/test_torch_train_state.py``."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import flags as tflags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.data import (
    DataSet,
    datasets as tdata,
    put_device_data,
    synthetic_cifar,
    synthetic_digits,
)
from distributed_tensorflow_tpu_torch.models import DeepCNN, ResNet
from distributed_tensorflow_tpu_torch.ops.augment import make_augment
from distributed_tensorflow_tpu_torch.training import train_state as tts
from distributed_tensorflow_tpu_torch.training.device_step import (
    DeviceTrainStep,
    make_device_train_step,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    params_to_numpy,
    state_to_numpy,
    tree_leaves,
)
from tests.test_torch_parallel import free_port, write_mnist_idx

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EXAMPLES, BATCH, STEPS = 96, 16, 5


def _split(n=N_EXAMPLES, seed=3):
    x, y = synthetic_digits(n, seed=seed)
    return DataSet(x, y)


def _index_stream(steps=STEPS, batch=BATCH, n=N_EXAMPLES, seed=11):
    return np.random.default_rng(seed).integers(0, n, (steps, batch))


def _fresh(model_seed=0, opt=None):
    model = DeepCNN()
    opt = opt or tts.adam(1e-3)
    return model, opt, tts.create_train_state(model, opt, seed=model_seed)


@pytest.mark.parametrize("keep_prob", [1.0, 0.75])
def test_device_step_on_injected_indices_equals_host_step(keep_prob):
    """The same batches, drawn by index on the device or fed from the
    host as uint8 (``--raw_input``'s format), give the same trajectory
    bit for bit, dropout included: both steps seed it from (key, step)."""
    split = _split()
    idx = _index_stream()
    raw = split._raw_u8()
    ids = split.labels_int.astype(np.int32)

    model, opt, state = _fresh()
    host_step = tts.make_train_step(model, opt, keep_prob=keep_prob)
    host_losses = []
    for i in idx:
        state, m = host_step(state, (torch.from_numpy(raw[i]),
                                     torch.from_numpy(ids[i])))
        host_losses.append(float(m["loss"]))
    host_params = params_to_numpy(model)

    model, opt, state = _fresh()
    data = put_device_data(split, "cpu")
    dev_step = make_device_train_step(
        model, opt, data, BATCH, keep_prob=keep_prob,
        indices=lambda s: torch.from_numpy(idx[s]))
    dev_losses = []
    for s in range(STEPS):
        state, m = dev_step(state, s, 1)
        dev_losses.append(float(m["loss"]))
    assert dev_losses == host_losses
    assert int(state.step) == STEPS
    for a, b in zip(tree_leaves(params_to_numpy(model)),
                    tree_leaves(host_params)):
        np.testing.assert_array_equal(a, b)


def _cifar_split(n=N_EXAMPLES, seed=3):
    x, y = synthetic_cifar(n, seed=seed)
    return DataSet(x, y)


CIFAR_AUGMENT = make_augment({"image_size": 32, "channels": 3})


def test_resnet_device_step_with_augment_equals_host_step():
    """ResNet-20 with --augment: the device step on injected indices and
    the host-fed step on the same uint8 batches draw the same crops and
    flips from (key, step) and move the batch-norm stats alike, bit for
    bit."""
    split = _cifar_split()
    idx = _index_stream(steps=3)
    raw, ids = split._raw_u8(), split.labels_int.astype(np.int32)
    runs = []
    for device in (False, True):
        model, opt = ResNet(), tts.adam(1e-3)
        state = tts.create_train_state(model, opt, seed=0)
        losses = []
        if device:
            step_fn = make_device_train_step(
                model, opt, put_device_data(split, "cpu"), BATCH,
                indices=lambda s: torch.from_numpy(idx[s]),
                augment_fn=CIFAR_AUGMENT)
            for s in range(3):
                state, m = step_fn(state, s, 1)
                losses.append(float(m["loss"]))
        else:
            step_fn = tts.make_train_step(model, opt,
                                          augment_fn=CIFAR_AUGMENT)
            for i in idx:
                state, m = step_fn(state, (torch.from_numpy(raw[i]),
                                           torch.from_numpy(ids[i])))
                losses.append(float(m["loss"]))
        runs.append((losses, params_to_numpy(model), state_to_numpy(model)))
    (lh, ph, sh), (ld, pd, sd) = runs
    assert ld == lh
    for a, b in zip(tree_leaves(pd) + tree_leaves(sd),
                    tree_leaves(ph) + tree_leaves(sh)):
        np.testing.assert_array_equal(a, b)
    assert float(np.abs(sd["stem"]["bn"]["mean"]).max()) > 0


def test_augment_draws_repeat_for_one_key_step_and_rank():
    def draws(rank, step):
        model, opt = ResNet(), tts.sgd(0.0)
        state = tts.create_train_state(model, opt, seed=0)
        mesh = types.SimpleNamespace(rank=rank, world_size=4)
        step_fn = DeviceTrainStep(model, opt,
                                  put_device_data(_cifar_split(), "cpu"),
                                  BATCH, mesh=mesh, augment_fn=CIFAR_AUGMENT)
        step_fn.sample(state, step)  # seeds every stream of the step
        return torch.randint(0, 2 ** 31, (8,), generator=step_fn.augmenter)

    first = draws(0, 5)
    assert torch.equal(first, draws(0, 5))
    assert not torch.equal(first, draws(1, 5))
    assert not torch.equal(first, draws(0, 6))


def test_device_step_matches_jax_on_the_same_uint8_batches():
    import jax
    import jax.numpy as jnp

    from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
    from distributed_tensorflow_tpu.training import train_state as jts
    from distributed_tensorflow_tpu_torch.utils.pytree import params_from_jax

    split = _split()
    idx = _index_stream()
    raw, ids = split._raw_u8(), split.labels_int.astype(np.int32)
    jm, jopt = JaxDeepCNN(), jts.adam(1e-3)
    js = jts.create_train_state(jm, jopt, seed=0)
    jstep = jts.make_train_step(jm, jopt, keep_prob=1.0, donate=False)

    model, opt, state = _fresh()
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                       js.params)))
    dev_step = make_device_train_step(
        model, opt, put_device_data(split, "cpu"), BATCH,
        indices=lambda s: torch.from_numpy(idx[s]))
    for s in range(STEPS):
        js, jm_ = jstep(js, (jnp.asarray(raw[idx[s]]),
                             jnp.asarray(ids[idx[s]])))
        state, m = dev_step(state, s, 1)
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-4)
        assert float(m["accuracy"]) == float(jm_["accuracy"])
    for a, b in zip(tree_leaves(params_to_numpy(model)),
                    tree_leaves(jax.tree.map(np.asarray, js.params))):
        d = np.abs(a - b)
        assert (d > 1e-5).mean() <= 1e-4 and d.max() <= 10 * 1e-3


def test_a_chunk_advances_the_step_by_its_length():
    model, opt, state = _fresh(opt=tts.sgd(0.01))
    step_fn = make_device_train_step(model, opt,
                                     put_device_data(_split(), "cpu"), BATCH)
    state, m = step_fn(state, 0, 3)
    assert int(state.step) == 3 and state.opt_state == ()
    state, m = step_fn(state, 3, 2)
    assert int(state.step) == 5 and set(m) == {"loss", "accuracy"}
    with pytest.raises(ValueError, match="state it started with"):
        step_fn(state._replace(), 5, 1)


def _draw(rank, step, key_seed=0):
    model, opt, state = _fresh(model_seed=key_seed, opt=tts.sgd(0.0))
    mesh = types.SimpleNamespace(rank=rank, world_size=4)
    step_fn = DeviceTrainStep(model, opt, put_device_data(_split(), "cpu"),
                              BATCH, keep_prob=0.5, mesh=mesh)
    return step_fn.sample(state, step)


def test_draws_are_a_function_of_key_step_and_rank():
    first = _draw(rank=0, step=7)
    assert first.shape == (BATCH,) and first.dtype == torch.int64
    assert 0 <= int(first.min()) and int(first.max()) < N_EXAMPLES
    assert torch.equal(first, _draw(rank=0, step=7))
    assert not torch.equal(first, _draw(rank=1, step=7))
    assert not torch.equal(first, _draw(rank=0, step=8))
    assert not torch.equal(first, _draw(rank=0, step=7, key_seed=1))
    key = np.array([0, 5], np.uint32)
    seeds = {tts.dropout_seed(key, 7, r) for r in range(4)}
    assert len(seeds) == 4 and tts.dropout_seed(key, 7) in seeds


def test_a_cuda_graph_needs_a_card_and_eager_steps_take_injected_indices():
    model, opt, state = _fresh()
    data = put_device_data(_split(), "cpu")
    with pytest.raises(ValueError, match="cuda device"):
        DeviceTrainStep(model, opt, data, BATCH, graph=True)
    step_fn = DeviceTrainStep(model, opt, data, BATCH)
    assert step_fn.graph is False
    with pytest.raises(ValueError, match="needs it on"):
        step_fn(state._replace(step=torch.zeros((), dtype=torch.int32,
                                                device="meta")), 0)


@pytest.fixture
def small_splits(monkeypatch):
    monkeypatch.setattr(tdata, "SYNTHETIC_TRAIN", 600)
    monkeypatch.setattr(tdata, "SYNTHETIC_TEST", 200)


@pytest.fixture
def port_flags():
    tflags.define_reference_flags()
    tflags.FLAGS._reset()
    yield tflags.FLAGS
    tflags.FLAGS._reset()


def _device_train(port_flags, logdir, data_dir, steps, capsys, *extra):
    from distributed_tensorflow_tpu_torch.training.loop import train

    port_flags._reset()
    port_flags._parse([
        "--device=cpu", f"--logdir={logdir}", f"--data_dir={data_dir}",
        f"--training_iter={steps}", "--batch_size=16", "--display_step=10",
        "--device_chunk=5", "--optimizer=adam", "--keep_prob=0.75",
        "--save_model_secs=100000", "--test_eval=false", "--device_data",
        *extra])
    res = train(port_flags)
    return res, capsys.readouterr().out


def test_device_data_resumes_off_a_chunk_boundary(tmp_path, small_splits,
                                                  port_flags, capsys):
    """A run stopped at step 7 (chunks 5 and 2) resumes with a 3-step
    chunk to the display step 10, then 5-step chunks; its draws are a
    function of (key, step), so it ends where an uninterrupted run ends,
    bit for bit."""
    data_dir = str(tmp_path / "no-data")
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    res, out = _device_train(port_flags, whole, data_dir, 20, capsys)
    assert res.final_step == 20 and "step:  10 mini_batch" in out
    res, _ = _device_train(port_flags, parts, data_dir, 7, capsys)
    assert res.final_step == 7 and tckpt.latest_checkpoint(parts)[1] == 7
    res, out = _device_train(port_flags, parts, data_dir, 20, capsys)
    assert res.final_step == 20
    assert "restored checkpoint step=7" in out
    assert "step:  10 mini_batch" in out
    with open(os.path.join(parts, "metrics.jsonl")) as f:
        shown = [json.loads(line)["step"] for line in f
                 if "mini_batch_loss" in line]
    assert shown == [0, 10]  # the first run's step 0, the resumed run's 10
    want = tckpt.load_flat(os.path.join(whole, "ckpt-20.npz"))
    got = tckpt.load_flat(os.path.join(parts, "ckpt-20.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resnet_device_data_with_augment_resumes_bitwise(
        tmp_path, small_splits, port_flags, capsys):
    """ResNet-20 on CIFAR-10 with --augment: a run stopped at step 7 and
    resumed to 12 ends where an uninterrupted run ends, bit for bit, the
    batch-norm state included: the crops and flips, like the batches,
    are a function of (key, step), and the restore brings the running
    stats back into the module's buffers."""
    args = ("--model=resnet20", "--dataset=cifar10", "--augment")
    data_dir = str(tmp_path / "no-data")
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    res, _ = _device_train(port_flags, whole, data_dir, 12, capsys, *args)
    assert res.final_step == 12
    res, _ = _device_train(port_flags, parts, data_dir, 7, capsys, *args)
    assert res.final_step == 7
    res, out = _device_train(port_flags, parts, data_dir, 12, capsys, *args)
    assert res.final_step == 12 and "restored checkpoint step=7" in out
    want = tckpt.load_flat(os.path.join(whole, "ckpt-12.npz"))
    got = tckpt.load_flat(os.path.join(parts, "ckpt-12.npz"))
    assert sorted(got) == sorted(want)
    assert "model_state/stage2/block0/proj_bn/var" in want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_entry_point_trains_sync_device_resident_on_the_cpu(tmp_path):
    data_dir = write_mnist_idx(str(tmp_path / "mnist"))
    logdir = str(tmp_path / "logs")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.mnist_dist",
         "--device", "cpu", "--mode", "sync", "--worker_hosts",
         f"127.0.0.1:{free_port()}", "--device_data", "--training_iter",
         "6", "--display_step", "3", "--device_chunk", "3",
         "--batch_size", "16", "--logdir", logdir, "--data_dir", data_dir],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    for step in (0, 3):
        assert any(line.startswith(f"job: worker/0 step:  {step} "
                                   f"mini_batch loss:  ")
                   and " training accuracy:  " in line for line in lines)
    assert "Optimization Finished!" in lines
    assert any(line.startswith("test accuracy:  ") for line in lines)
    assert tckpt.latest_checkpoint(logdir)[1] == 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_graph_replays_equal_eager_device_steps_on_card(cuda_device, bf16):
    """The CUDA graph of a step, replayed, takes the eager step's draws
    (sampling and dropout) and arithmetic: with cuDNN's deterministic
    algorithms the two trajectories are bitwise equal."""
    from distributed_tensorflow_tpu_torch.ops import fused_dense

    data = put_device_data(_split(), cuda_device)
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for graph in (True, False):
            model = DeepCNN(compute_dtype=torch.bfloat16 if bf16 else None,
                            use_pallas=True)
            opt = tts.adam(1e-3)
            state = tts.create_train_state(model, opt, seed=0,
                                           device=cuda_device)
            state = state._replace(step=state.step.to(cuda_device))
            step_fn = make_device_train_step(model, opt, data, BATCH,
                                             keep_prob=0.75, graph=graph)
            before = fused_dense.LAUNCHES
            losses = []
            for s in range(STEPS):
                state, m = step_fn(state, s, 1)
                losses.append(float(m["loss"]))
            # graph: 2 eager warm-up steps, then one launch per replay
            assert fused_dense.LAUNCHES - before == STEPS + 2 * graph
            runs.append((losses, params_to_numpy(model), int(state.step)))
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg, sg), (le, pe, se) = runs
    assert lg == le and sg == se == STEPS
    for a, b in zip(tree_leaves(pg), tree_leaves(pe)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_resnet_graph_replays_equal_eager_steps_on_card(cuda_device, bf16):
    """ResNet-20 with --augment: the captured graph holds the crop, the
    flip and the batch-norm updates; its replays equal eager device steps
    bit for bit (cuDNN's deterministic algorithms), the stats included."""
    data = put_device_data(_cifar_split(), cuda_device)
    runs = []
    torch.backends.cudnn.deterministic = True
    try:
        for graph in (True, False):
            model = ResNet(compute_dtype=torch.bfloat16 if bf16 else None)
            opt = tts.adam(1e-3)
            state = tts.create_train_state(model, opt, seed=0,
                                           device=cuda_device)
            state = state._replace(step=state.step.to(cuda_device))
            step_fn = make_device_train_step(model, opt, data, BATCH,
                                             graph=graph,
                                             augment_fn=CIFAR_AUGMENT)
            losses = []
            for s in range(STEPS):
                state, m = step_fn(state, s, 1)
                losses.append(float(m["loss"]))
            runs.append((losses, params_to_numpy(model),
                         state_to_numpy(model)))
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg, sg), (le, pe, se) = runs
    assert lg == le
    for a, b in zip(tree_leaves(pg) + tree_leaves(sg),
                    tree_leaves(pe) + tree_leaves(se)):
        np.testing.assert_array_equal(a, b)
