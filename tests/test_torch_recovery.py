"""The training side's fault points and the restore's re-scan, held to
the JAX package's own timelines (``tests/test_faults.py``: the restore
injection, the ``ckpt_write`` crash in a subprocess, the ``init``
retry; ``tests/test_checkpoint.py``: a set that vanishes under the
reader), on the CPU.

Each timeline runs on both packages where it can: the same spec fires
at the same site with the same effect. The training entry arms
``--fault_spec`` (``train`` and ``evaluate_only``) and refuses the
points whose path is not ported."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.utils import faults as jfaults
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import checkpoint as tckpt
from distributed_tensorflow_tpu_torch.utils import faults

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _state(step=0, fill=0.0):
    return {"params": {"w": np.full(512, fill, np.float32),
                       "b": np.full(16, fill, np.float32)},
            "step": np.int64(step)}


def _template():
    return _state()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restore_injection_one_liner_drives_the_ladder(tmp_path, pkg):
    """``--fault_spec restore:mode=torn_file`` is the whole reproduction
    of a torn newest checkpoint: the ladder quarantines it and lands one
    step down, in both packages."""
    if pkg == "jax":
        from distributed_tensorflow_tpu.checkpoint import checkpoint as ckpt

        mod = jfaults
    else:
        ckpt, mod = tckpt, faults
    d = str(tmp_path)
    ckpt.save_checkpoint(d, _state(10, 1.0), 10)
    ckpt.save_checkpoint(d, _state(20, 2.0), 20)
    mod.configure("restore:mode=torn_file:times=1")
    _, step, report = ckpt.restore_with_fallback(d, _template())
    assert step == 10 and report.fallback_depth == 1
    assert len(report.quarantined) == 1


def test_ckpt_write_crash_mode_hard_exits_subprocess(tmp_path):
    """ckpt_write:mode=crash is a hard os._exit(17): no final save, no
    atexit — but the file ALREADY landed (the point fires after the
    atomic rename), so a restart restores it through the scan even though
    the index write never happened."""
    code = (
        "import numpy as np\n"
        "from distributed_tensorflow_tpu_torch.utils import faults\n"
        "from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import "
        "save_checkpoint\n"
        "faults.configure('ckpt_write:at_step=7:mode=crash')\n"
        f"d = {str(tmp_path)!r}\n"
        "save_checkpoint(d, {'w': np.arange(4.0, dtype=np.float32)}, 3)\n"
        "save_checkpoint(d, {'w': np.arange(4.0, dtype=np.float32)}, 7)\n"
        "print('NOT REACHED')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env={**os.environ, "OMP_NUM_THREADS": "1"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == faults.FAULT_EXIT_CODE, r.stdout + r.stderr
    assert "NOT REACHED" not in r.stdout
    assert os.path.exists(tmp_path / "ckpt-7.npz")
    with open(tmp_path / "checkpoint") as f:
        assert '"latest_step": 3' in f.read()  # the crash beat the index
    found = tckpt.latest_checkpoint(str(tmp_path))
    assert found is not None and found[1] == 7
    out = tckpt.restore_with_fallback(str(tmp_path),
                                      {"w": np.zeros(4, np.float32)})
    assert out is not None and out[1] == 7


@pytest.mark.parametrize("point", ["ckpt_index", "ckpt_gc"])
def test_index_and_gc_points_fire_inside_the_write(tmp_path, point):
    """``ckpt_index`` fires before the index is replaced and ``ckpt_gc``
    at the GC's entry, each after the file landed, as in the JAX
    package."""
    from distributed_tensorflow_tpu.checkpoint import checkpoint as jckpt

    for pkg, ckpt, mod in (("port", tckpt, faults), ("jax", jckpt, jfaults)):
        d = str(tmp_path / pkg)
        mod.configure(f"{point}:mode=error")
        with pytest.raises(mod.InjectedFault, match=point):
            ckpt.save_checkpoint(d, _state(5), 5)
        assert os.path.exists(os.path.join(d, "ckpt-5.npz"))
        assert os.path.exists(os.path.join(d, "checkpoint")) == (
            point == "ckpt_gc")


def test_init_retry_rides_through_injected_refusals():
    from distributed_tensorflow_tpu_torch.cluster import (
        _initialize_with_retry,
    )

    faults.configure("init:mode=refuse:times=2")
    calls = {"n": 0}
    sleeps = []

    def init_fn():
        calls["n"] += 1

    _initialize_with_retry(init_fn, retries=3, backoff_s=0.5,
                           what="test init", sleep=sleeps.append)
    assert calls["n"] == 1  # two injected refusals, then the real join
    assert sleeps == [0.5, 1.0]  # linear backoff


def test_init_retry_exhausts_loudly():
    from distributed_tensorflow_tpu_torch.cluster import (
        _initialize_with_retry,
    )

    faults.configure("init:mode=refuse:times=0")  # unlimited refusals
    with pytest.raises(faults.InjectedFault):
        _initialize_with_retry(lambda: None, retries=2, backoff_s=0.1,
                               what="test init", sleep=lambda s: None)


def test_init_retry_runs_cleanup_between_attempts():
    from distributed_tensorflow_tpu_torch.cluster import (
        _initialize_with_retry,
    )

    faults.configure("init:mode=refuse:times=1")
    cleaned = {"n": 0}
    _initialize_with_retry(lambda: None, retries=2, backoff_s=0.0,
                           what="test init", sleep=lambda s: None,
                           cleanup_fn=lambda: cleaned.update(
                               n=cleaned["n"] + 1))
    assert cleaned["n"] == 1


def test_prefetch_fault_reaches_the_consumer_as_itself():
    from distributed_tensorflow_tpu_torch.data import prefetch_to_device

    faults.configure("prefetch:at_count=2:mode=error")
    it = prefetch_to_device(iter([(np.zeros(2),)] * 5), size=2,
                            device="cpu")
    got = [next(it), next(it)]
    assert len(got) == 2
    with pytest.raises(faults.InjectedFault, match="prefetch"):
        next(it)


def test_exit_agreement_injection_fails_the_agreement():
    from distributed_tensorflow_tpu_torch.utils.pytree import (
        agree_clean_exit,
    )

    faults.configure("exit_agreement:mode=error")
    verdict, token = agree_clean_exit(True, timeout_s=30.0,
                                      return_token=True)
    assert verdict is None and token is None
    faults.configure(None)
    verdict, token = agree_clean_exit(True, timeout_s=30.0,
                                      return_token=True)
    assert verdict is True and len(token) == 8
    assert agree_clean_exit(False, timeout_s=30.0) is False


def test_collective_fetch_injection_reports_failed_final_save(tmp_path,
                                                              capsys):
    """collective_fetch:mode=error — the exit save fails LOUDLY but the
    managed() exit still completes (the best-effort final save)."""
    from distributed_tensorflow_tpu_torch.models import DeepCNN
    from distributed_tensorflow_tpu_torch.training import train_state as tts
    from distributed_tensorflow_tpu_torch.training.supervisor import (
        Supervisor,
    )

    state = tts.create_train_state(DeepCNN(), tts.sgd(0.01), seed=0)
    faults.configure("collective_fetch:mode=error")
    sv = Supervisor(is_chief=True, logdir=str(tmp_path),
                    save_model_secs=10_000)
    with sv.managed(state) as box:
        box.update(state, 3)
    assert "final checkpoint failed" in capsys.readouterr().out
    assert tckpt.latest_checkpoint(str(tmp_path)) is None


def test_restore_rescans_when_the_newest_set_vanishes_before_the_key_scan(
        tmp_path, monkeypatch, capsys):
    """The newest checkpoint is a params-only (ps-layout) sharded set, so
    the restore falls to the key scan of ``_latest_is_params_only``; a
    racing peer's GC deletes the set between ``latest_checkpoint`` and
    that scan. The Supervisor re-scans and lands on the next set."""
    from distributed_tensorflow_tpu_torch.models import MLP
    from distributed_tensorflow_tpu_torch.training import supervisor
    from distributed_tensorflow_tpu_torch.training import train_state as tts

    d = str(tmp_path)
    model = MLP()
    state = tts.create_train_state(model, tts.adam(1e-3), seed=0)
    tckpt.save_checkpoint(d, state, 3)
    tckpt.save_checkpoint_sharded(d, {"params": state.params,
                                      "step": np.int64(7)}, 7)
    assert tckpt.latest_checkpoint(d)[1] == 7
    real = supervisor.latest_checkpoint
    raced = {"n": 0}

    def racing_latest(directory):
        found = real(directory)
        if found is not None and found[1] == 7 and not raced["n"]:
            raced["n"] += 1
            for name in os.listdir(directory):
                if name.startswith("ckpt-7."):
                    os.unlink(os.path.join(directory, name))
        return found

    monkeypatch.setattr(supervisor, "latest_checkpoint", racing_latest)
    sv = supervisor.Supervisor(is_chief=True, logdir=d,
                               save_model_secs=10_000)
    restored, step = sv.init_or_restore(
        tts.create_train_state(MLP(), tts.adam(1e-3), seed=1))
    assert raced["n"] == 1 and step == 3
    assert "checkpoint vanished mid-restore" in capsys.readouterr().out
    for a, b in zip(tts.tree_leaves(restored.params),
                    tts.tree_leaves(state.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture
def port_flags():
    flags.define_reference_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


def test_train_arms_the_fault_spec(port_flags, tmp_path):
    """``train`` configures ``--fault_spec``: a prefetch fault at the
    second batch stops the run with the injected error."""
    from distributed_tensorflow_tpu_torch.training.loop import train
    from tests.test_torch_parallel import write_mnist_idx

    data = write_mnist_idx(str(tmp_path / "mnist"), n_train=64, n_test=16)
    port_flags._parse(["--device", "cpu", "--training_iter", "4",
                       "--batch_size", "8", "--logdir", str(tmp_path / "l"),
                       "--data_dir", data, "--fault_spec",
                       "prefetch:at_count=2:mode=error"])
    with pytest.raises(faults.InjectedFault, match="prefetch"):
        train(port_flags)


@pytest.mark.parametrize("argv,msg", [
    (["--fault_spec", "preempt:at_step=3:mode=notice"], "'preempt'"),
    (["--watchdog_s", "5"], "--watchdog_s > 0"),
], ids=["preempt", "watchdog"])
def test_training_entry_refuses_paths_not_ported(port_flags, capsys, argv,
                                                 msg):
    """A spec naming ``preempt`` and ``--watchdog_s > 0`` exit 2 at the
    training entry with a message that their path is not ported, and
    ``train`` refuses them too."""
    from distributed_tensorflow_tpu_torch import mnist_dist
    from distributed_tensorflow_tpu_torch.training.loop import train

    with pytest.raises(SystemExit) as e:
        flags.run(mnist_dist.main, argv=["--device", "cpu", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert msg in err and "not yet ported" in err
    with pytest.raises(ValueError, match="not yet ported"):
        train(port_flags)
