"""The port's checkpoint format against the JAX package's: same CRC-32C,
files that restore bitwise in either direction, the same quarantine-and-
fall-back ladder."""

import os

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt
from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.training import create_train_state, sgd
from distributed_tensorflow_tpu.utils import events as jevents
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.models import DeepCNN
from distributed_tensorflow_tpu_torch.utils import events as tevents
from distributed_tensorflow_tpu_torch.utils.pytree import params_to_numpy

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)


@pytest.mark.parametrize("n", [0, 9, 1023, 4096, 70001])
def test_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert tevents.crc32c(data) == jevents.crc32c(data)
    assert tevents.crc32c(data.tobytes()) == tevents._crc32c(data.tobytes())


def _port_params(seed=0):
    return params_to_numpy(DeepCNN().init(torch.Generator().manual_seed(seed)))


def test_jax_checkpoint_restores_bitwise_in_port(tmp_path):
    state = create_train_state(JaxDeepCNN(), sgd(0.1), seed=0)
    jckpt.save_checkpoint(str(tmp_path), state, 7)
    out = tckpt.restore_params_with_fallback(str(tmp_path), _port_params())
    params, step, report = out
    assert step == 7 and report.fallback_depth == 0
    want = jax.tree.map(np.asarray, state.params)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    params = _port_params(seed=1)
    tckpt.save_checkpoint(str(tmp_path), {"params": params,
                                          "step": np.int32(11)}, 11)
    template = JaxDeepCNN().init(jax.random.key(0))
    got, step, _ = jckpt.restore_params_with_fallback(str(tmp_path),
                                                      template)
    assert step == 11
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_tensor_leaves_roundtrip_through_the_tag(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    tckpt.save_checkpoint(str(tmp_path), {"params": {"w": t}}, 1)
    assert "__bf16__params/w" in tckpt.load_flat(str(tmp_path / "ckpt-1.npz"))
    got, _, _ = tckpt.restore_params_with_fallback(
        str(tmp_path), {"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    # and the JAX package reads the same file
    jgot, _, _ = jckpt.restore_params_with_fallback(
        str(tmp_path), {"w": jax.numpy.zeros((3, 5), jax.numpy.bfloat16)})
    np.testing.assert_array_equal(np.asarray(jgot["w"], np.float32),
                                  t.float().numpy())


def test_corrupt_newest_is_quarantined_and_ladder_falls_back(tmp_path):
    d = str(tmp_path)
    tckpt.save_checkpoint(d, {"params": _port_params(0)}, 10)
    tckpt.save_checkpoint(d, {"params": _port_params(1)}, 20)
    newest = os.path.join(d, "ckpt-20.npz")
    raw = bytearray(open(newest, "rb").read())
    raw[len(raw) // 2] ^= 0xFF  # one flipped byte inside an array
    open(newest, "wb").write(bytes(raw))
    params, step, report = tckpt.restore_params_with_fallback(
        d, _port_params())
    assert step == 10 and report.fallback_depth == 1
    assert any(p.endswith(".corrupt") for p in report.quarantined)
    assert tckpt.latest_checkpoint(d)[1] == 10
    np.testing.assert_array_equal(params["weights"]["wd1"],
                                  _port_params(0)["weights"]["wd1"])


def test_gc_keeps_newest_and_template_mismatch_is_loud(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        tckpt.save_checkpoint(d, {"params": {"w": np.full(2, s, np.float32)}},
                              s, max_to_keep=2)
    assert sorted(n for n in os.listdir(d) if n.endswith(".npz")) == [
        "ckpt-2.npz", "ckpt-3.npz"]
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_params_with_fallback(d, {"w": np.zeros(3, np.float32)})


def test_sharded_checkpoint_raises_not_yet_ported(tmp_path):
    """The sharded format is read now: a lone shard of an incomplete set
    (1 of 2 files) is not restorable, so there is nothing to restore, and
    a complete monolithic step beside it restores."""
    (tmp_path / "ckpt-5.shard0-of-2.npz").write_bytes(b"")
    assert tckpt.latest_checkpoint(str(tmp_path)) is None
    assert tckpt.restore_params_with_fallback(str(tmp_path),
                                              _port_params()) is None
    tckpt.save_checkpoint(str(tmp_path), {"params": _port_params(2)}, 3)
    params, step, _ = tckpt.restore_params_with_fallback(str(tmp_path),
                                                         _port_params())
    assert step == 3
    np.testing.assert_array_equal(params["weights"]["wd1"],
                                  _port_params(2)["weights"]["wd1"])


def _jax_sharded_state(seed):
    """A JAX TrainState whose params are sharded over the tests' 8-device
    CPU mesh (wd1 by rows, wc2 by output channels), the rest replicated,
    and a bf16 leaf beside them."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from distributed_tensorflow_tpu.training import adam as jadam

    state = create_train_state(JaxDeepCNN(), jadam(1e-3), seed=seed)
    mesh = Mesh(np.asarray(jax.devices()).reshape(8), ("data",))
    specs = {"wd1": P("data", None), "wc2": P(None, None, None, "data")}
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jax.device_put(a, NamedSharding(
            mesh, specs.get(getattr(path[-1], "key", ""), P()))),
        state.params)
    return {"params": params, "step": np.int32(seed),
            "half": jax.numpy.arange(6, dtype=jax.numpy.bfloat16)}


def test_jax_sharded_set_reads_bitwise_and_a_damaged_one_is_quarantined(
        tmp_path):
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat

    d = str(tmp_path)
    old, new = _jax_sharded_state(1), _jax_sharded_state(2)
    jckpt.save_checkpoint(d, old, 10)  # an older monolithic step
    path = jckpt.save_checkpoint_sharded(d, new, 20)
    assert ".shard0-of-1." in path
    want = jflat(new, tag_bf16=True)
    got = tckpt.load_flat(path)
    assert sorted(got) == sorted(want) == sorted(jckpt.load_flat(path))
    assert "__bf16__half" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tckpt.latest_checkpoint(d) == (path, 20)
    assert tckpt.checkpoint_keys(path) == set(want)
    params, step, rep = tckpt.restore_params_with_fallback(d, _port_params())
    assert step == 20 and rep.fallback_depth == 0
    np.testing.assert_array_equal(params["weights"]["wd1"],
                                  want["params/weights/wd1"])
    # a flipped byte in the shard: quarantined, the ladder walks back
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 3] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    params, step, rep = tckpt.restore_params_with_fallback(d, _port_params())
    assert step == 10 and rep.fallback_depth == 1
    assert [os.path.basename(p) for p in rep.quarantined] == [
        os.path.basename(path) + ".corrupt"]
    np.testing.assert_array_equal(params["weights"]["wd1"],
                                  np.asarray(old["params"]["weights"]["wd1"]))


def _trained_port_state(seed=3):
    """A port adam TrainState after one update, so every slot is nonzero."""
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    model = DeepCNN()
    opt = tts.adam(1e-3)
    state = tts.create_train_state(model, opt, seed=seed)
    x = torch.from_numpy(
        np.random.default_rng(seed).random((4, 784), dtype=np.float32))
    y = torch.tensor([1, 2, 3, 4])
    state, _ = tts.make_train_step(model, opt)(state, (x, y))
    return state


def test_port_train_state_restores_bitwise_in_jax(tmp_path):
    from distributed_tensorflow_tpu.training import adam as jadam
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    state = _trained_port_state()
    tckpt.save_checkpoint(str(tmp_path), state, 1)
    template = create_train_state(JaxDeepCNN(), jadam(1e-3), seed=0)
    got, step, _ = jckpt.restore_with_fallback(str(tmp_path), template)
    assert step == 1
    want = flatten_pytree(state)
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat

    have = jflat(got)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k])


def test_jax_train_state_restores_bitwise_in_port(tmp_path):
    from distributed_tensorflow_tpu.training import adam as jadam
    from distributed_tensorflow_tpu.training import make_train_step
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    jm = JaxDeepCNN()
    jstate = create_train_state(jm, jadam(1e-3), seed=4)
    x = np.random.default_rng(4).random((4, 784), dtype=np.float32)
    jstate, _ = make_train_step(jm, jadam(1e-3), donate=False)(
        jstate, (x, np.array([1, 2, 3, 4], np.int32)))
    jckpt.save_checkpoint(str(tmp_path), jstate, 1)
    model = DeepCNN()
    live = tts.create_train_state(model, tts.adam(1e-3), seed=0)
    wd1 = live.params["weights"]["wd1"]
    state, step = Supervisor(True, str(tmp_path)).init_or_restore(live)
    assert step == 1
    # restored in place: the module holds the restored parameters
    assert state.params["weights"]["wd1"] is wd1
    want, have = jflat(jstate), flatten_pytree(state)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k])


def test_supervisor_adopts_a_params_only_checkpoint(tmp_path):
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

    params = _port_params(seed=6)
    tckpt.save_checkpoint(str(tmp_path), {"params": params,
                                          "step": np.int32(40)}, 40)
    live = tts.create_train_state(DeepCNN(), tts.adam(1e-3), seed=0)
    state, step = Supervisor(True, str(tmp_path)).init_or_restore(live)
    assert step == 40 and int(state.step) == 40
    np.testing.assert_array_equal(
        state.params["weights"]["wd1"].detach().numpy(),
        params["weights"]["wd1"])
    assert int(state.opt_state["t"]) == 0  # the optimizer starts fresh


def test_switched_optimizer_is_a_loud_restore(tmp_path):
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

    tckpt.save_checkpoint(str(tmp_path), _trained_port_state(), 1)
    live = tts.create_train_state(DeepCNN(), tts.momentum(1e-3), seed=0)
    with pytest.raises(KeyError, match="same optimizer"):
        Supervisor(True, str(tmp_path)).init_or_restore(live)


def test_checkpointer_cadence_and_chief_only(tmp_path, monkeypatch):
    state = {"params": {"w": np.ones(2, np.float32)}}
    clock = [1000.0]
    monkeypatch.setattr(tckpt.time, "time", lambda: clock[0])
    ck = tckpt.Checkpointer(str(tmp_path), save_model_secs=60, max_to_keep=2)
    assert ck.maybe_save(state, 1) is None  # not due yet
    clock[0] += 60
    assert ck.maybe_save(state, 2).endswith("ckpt-2.npz")
    assert ck.maybe_save(state, 3) is None  # the cadence restarted
    assert ck.save(state, 4).endswith("ckpt-4.npz")
    clock[0] += 120
    ck.maybe_save(state, 5)
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".npz")) == [
        "ckpt-4.npz", "ckpt-5.npz"]  # max_to_keep
    other = tckpt.Checkpointer(str(tmp_path / "w1"), is_chief=False,
                               save_model_secs=1)
    clock[0] += 10
    assert other.maybe_save(state, 6) is None and other.save(state, 6) is None
    assert not os.path.exists(tmp_path / "w1")
    off = tckpt.Checkpointer(str(tmp_path / "off"), save_model_secs=0)
    clock[0] += 1e6
    assert off.maybe_save(state, 7) is None  # 0 turns the cadence off


def test_managed_saves_on_exit_and_on_sigterm(tmp_path):
    import signal

    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor

    live = tts.create_train_state(DeepCNN(), tts.sgd(1e-3), seed=0)
    sv = Supervisor(True, str(tmp_path), save_model_secs=0)
    before = signal.getsignal(signal.SIGTERM)
    with sv.managed(live) as box:
        assert box.step == 0
        os.kill(os.getpid(), signal.SIGTERM)  # the handler requests a stop
        assert sv.should_stop()
        box.update(box.state, 9)
    assert tckpt.latest_checkpoint(str(tmp_path))[1] == 9
    assert signal.getsignal(signal.SIGTERM) is before  # handler removed
    sv2 = Supervisor(True, str(tmp_path / "err"), save_model_secs=0)
    with pytest.raises(RuntimeError, match="boom"):
        with sv2.managed(live) as box:
            box.update(box.state, 3)
            raise RuntimeError("boom")
    assert tckpt.latest_checkpoint(str(tmp_path / "err"))[1] == 3


def _trained_port_resnet_state():
    """A port ResNet-20 adam TrainState after one update on CIFAR-shaped
    inputs: parameters, slots and batch-norm stats all moved."""
    from distributed_tensorflow_tpu_torch.models import ResNet
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    model = ResNet()
    opt = tts.adam(1e-3)
    state = tts.create_train_state(model, opt, seed=5)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (4, 32, 32, 3), dtype=np.float32))
    state, _ = tts.make_train_step(model, opt)(state, (x, torch.arange(4)))
    return state


def test_resnet_train_state_crosses_bitwise_both_ways(tmp_path):
    """The port's ResNet TrainState (``model_state/...`` keys beside the
    params and slots) restores bitwise in the JAX package's
    ``restore_with_fallback``, and JAX's in the port's supervisor, into
    the module's own buffers; the two key sets are equal."""
    from distributed_tensorflow_tpu.models.resnet import ResNet as JaxResNet
    from distributed_tensorflow_tpu.training import adam as jadam
    from distributed_tensorflow_tpu.training import make_train_step
    from distributed_tensorflow_tpu.utils.pytree import flatten_pytree as jflat
    from distributed_tensorflow_tpu_torch.models import ResNet
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
    from distributed_tensorflow_tpu_torch.utils.pytree import flatten_pytree

    state = _trained_port_resnet_state()
    tckpt.save_checkpoint(str(tmp_path / "port"), state, 1)
    template = create_train_state(JaxResNet(), jadam(1e-3), seed=0)
    got, step, _ = jckpt.restore_with_fallback(str(tmp_path / "port"),
                                               template)
    want, have = flatten_pytree(state), jflat(got)
    assert step == 1 and sorted(have) == sorted(want)
    assert "model_state/stage1/block0/proj_bn/var" in want
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k])

    jm = JaxResNet()
    jstate = create_train_state(jm, jadam(1e-3), seed=6)
    x = np.random.default_rng(6).random((4, 32, 32, 3), dtype=np.float32)
    jstate, _ = make_train_step(jm, jadam(1e-3), donate=False)(
        jstate, (x, np.array([1, 2, 3, 4], np.int32)))
    jckpt.save_checkpoint(str(tmp_path / "jax"), jstate, 1)
    model = ResNet()
    live = tts.create_train_state(model, tts.adam(1e-3), seed=0)
    restored, step = Supervisor(True, str(tmp_path / "jax")).init_or_restore(
        live)
    assert step == 1
    assert restored.model_state["stem"]["bn"]["mean"] is model.stem.bn.mean
    want, have = jflat(jstate), flatten_pytree(restored)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(have[k], want[k])


def test_background_writer_writes_what_a_synchronous_save_writes(
        tmp_path, monkeypatch):
    """A cadenced background save lands the same arrays a synchronous
    save writes; its snapshot is taken on the calling thread, so a CPU
    tensor changed in place after ``maybe_save`` does not reach the file;
    a failed write raises on the next call; the forced save is
    synchronous and ends the index at its step."""
    import threading

    clock = [1000.0]
    monkeypatch.setattr(tckpt.time, "time", lambda: clock[0])
    w = torch.arange(6, dtype=torch.float32)
    state = {"params": {"w": w, "h": torch.ones(2, dtype=torch.bfloat16)},
             "step": np.int32(1)}
    tckpt.save_checkpoint(str(tmp_path / "sync"), state, 1)
    gate = threading.Event()
    real = tckpt._write_flat
    monkeypatch.setattr(tckpt, "_write_flat",
                        lambda *a: (gate.wait(30), real(*a))[1])
    ck = tckpt.Checkpointer(str(tmp_path / "bg"), save_model_secs=5,
                            background=True)
    clock[0] += 5
    assert ck.maybe_save(state, 1) is None
    w.add_(100.0)  # the next step's in-place update
    assert not os.path.exists(tmp_path / "bg" / "ckpt-1.npz")
    gate.set()
    ck.wait()
    want = tckpt.load_flat(str(tmp_path / "sync" / "ckpt-1.npz"))
    got = tckpt.load_flat(str(tmp_path / "bg" / "ckpt-1.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def fail(*a):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write_flat", fail)
    clock[0] += 5
    ck.maybe_save(state, 2)
    ck._drain()
    clock[0] += 5
    with pytest.raises(RuntimeError, match="disk full"):
        ck.maybe_save(state, 3)
    monkeypatch.setattr(tckpt, "_write_flat", real)
    clock[0] += 5
    ck.maybe_save(state, 4)
    assert ck.save(state, 5).endswith("ckpt-5.npz")  # drained, then written
    assert tckpt.latest_checkpoint(str(tmp_path / "bg"))[1] == 5
    assert sorted(tckpt._mono_steps(str(tmp_path / "bg"))) == [1, 4, 5]
    ck.close()
    assert ck._thread is None
    with pytest.raises(RuntimeError, match="closed"):
        clock[0] += 5
        ck.maybe_save(state, 6)
