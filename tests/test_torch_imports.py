"""Import hygiene of the port: every module of
``distributed_tensorflow_tpu_torch``, ``chip_smoke.py``,
``port_kernel_study.py`` and ``profile_window_probe.py`` import in a
fresh interpreter without pulling in ``jax`` or the JAX package, and the
smoke script refuses to run without a card."""

import os
import pkgutil
import subprocess
import sys

import distributed_tensorflow_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "distributed_tensorflow_tpu"
             or m.startswith("distributed_tensorflow_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _port_modules():
    pkg = distributed_tensorflow_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_and_chip_smoke_import_no_jax():
    names = _port_modules()
    assert "distributed_tensorflow_tpu_torch.serving.__main__" in names
    assert "distributed_tensorflow_tpu_torch.ops.fused_dense" in names
    assert "distributed_tensorflow_tpu_torch.mnist_dist" in names
    assert "distributed_tensorflow_tpu_torch.training.loop" in names
    for new in ("parallel.mesh", "parallel.data_parallel",
                "data.device_data", "training.device_step",
                "models.resnet", "models.mlp", "ops.augment",
                "parallel.ps_emulation", "checkpoint.inspect",
                "parallel.zero", "data.lm", "ops.attention",
                "models.transformer", "serving.decode", "ops.moe",
                "utils.telemetry", "utils.faults", "serving.reqtrace",
                "serving.kvpage", "serving.continuous",
                "parallel.tensor_parallel", "checkpoint.checkpoint",
                "training.supervisor", "utils.pytree", "data.pipeline",
                "cluster", "flags", "models.cnn", "training.train_state",
                "parallel.sequence_parallel"):
        assert f"distributed_tensorflow_tpu_torch.{new}" in names
    proc = subprocess.run([sys.executable, "-c", _PROBE, *names,
                           "chip_smoke", "port_kernel_study",
                           "profile_window_probe"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_chip_smoke_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
