"""The port's serving slice end to end on the CPU: the JAX package writes
a deep_cnn checkpoint, the port's ``build_serving_stack`` with ``--pallas
--device cpu`` serves it over HTTP, and the answers equal the JAX
``InferenceEngine.predict`` on the same checkpoint."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.checkpoint import save_checkpoint
from distributed_tensorflow_tpu.models.cnn import DeepCNN as JaxDeepCNN
from distributed_tensorflow_tpu.serving import InferenceEngine as JaxEngine
from distributed_tensorflow_tpu.training import create_train_state, sgd
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.data import synthetic_digits
from distributed_tensorflow_tpu_torch.models import DeepCNN
from distributed_tensorflow_tpu_torch.ops import fused_dense
from distributed_tensorflow_tpu_torch.serving import (
    DynamicBatcher,
    InferenceEngine,
    InferenceServer,
    RejectedError,
    predict_group_key,
)
from distributed_tensorflow_tpu_torch.serving.__main__ import (
    build_serving_stack,
)

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch-serve"))
    state = create_train_state(JaxDeepCNN(), sgd(0.1), seed=0)
    save_checkpoint(d, state, 10)
    return d


@pytest.fixture
def fresh_flags():
    flags.define_flags()
    flags.FLAGS._reset()
    yield flags.FLAGS
    flags.FLAGS._reset()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_http_predict_matches_jax_engine(jax_ckpt, fresh_flags):
    fresh_flags._parse(["--logdir", jax_ckpt, "--pallas", "--device", "cpu",
                        "--serve_reload_secs", "0", "--serve_max_batch", "4",
                        "--serve_metrics_every", "1"])
    engine, client, watcher, metrics = build_serving_stack(fresh_flags)
    assert watcher is None and engine.step == 10
    assert engine.current()[0].use_pallas
    srv = InferenceServer(engine, client, port=0).start_background()
    x, _ = synthetic_digits(6, seed=11)
    outs = [None] * len(x)
    try:
        def one(i):
            outs[i] = _post(srv.address + "/v1/predict",
                            {"inputs": x[i].tolist(),
                             "request_id": f"r{i}"})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(x))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        health = json.loads(urllib.request.urlopen(
            srv.address + "/healthz", timeout=10).read())
        stats = json.loads(urllib.request.urlopen(
            srv.address + "/stats", timeout=10).read())
        m = json.loads(urllib.request.urlopen(
            srv.address + "/metrics", timeout=10).read())
    finally:
        srv.close()
        client.predict_batcher.close()
        metrics.logger.close()
    assert health["ok"] and health["step"] == 10
    assert stats["predict_batcher"]["completed"] == len(x)
    assert m["predict"]["backpressure"]["closed"] is False
    assert [o["request_id"] for o in outs] == [f"r{i}" for i in range(len(x))]
    got = np.stack([o["outputs"] for o in outs])
    want = JaxEngine(JaxDeepCNN(use_pallas=True), jax_ckpt,
                     max_batch=4).predict(x)
    # reordered float32 sums on one side: rtol 1e-4, atol 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # CPU tensors: the kernel's plain version, no launch
    assert fused_dense.LAUNCHES == 0


def test_engine_pads_to_pow2_bucket(jax_ckpt):
    eng = InferenceEngine(DeepCNN(), jax_ckpt, device="cpu", max_batch=8)
    assert [eng._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    x, _ = synthetic_digits(3, seed=12)
    batch = eng.predict(x)  # padded to 4 inside, 3 rows out
    assert batch.shape == (3, 10)
    solo = np.concatenate([eng.predict(x[i:i + 1]) for i in range(3)])
    np.testing.assert_allclose(batch, solo, rtol=1e-5, atol=1e-5)


def test_default_device_raises_without_a_card(jax_ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(DeepCNN(), jax_ckpt)


def test_entry_point_exits_nonzero_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.serving",
         "--logdir", str(tmp_path), "--pallas", "--serve_port", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_predict_group_key_and_full_queue_rejection():
    assert predict_group_key(np.zeros(784), {}) == (784,)
    assert predict_group_key(np.zeros(784), {}) != \
        predict_group_key(np.zeros(10), {})
    gate = threading.Event()

    def runner(payloads, opts):
        gate.wait(10)
        return list(payloads)

    b = DynamicBatcher(runner, max_batch=1, max_delay_ms=0, queue_depth=2,
                       default_timeout_ms=30_000)
    try:
        first = b.submit(np.zeros(2))
        # the worker holds `first`; two more fill the queue
        t_end = time.monotonic() + 10
        while b.stats.as_dict()["batches"] < 1 and time.monotonic() < t_end:
            time.sleep(0.01)
        assert b.stats.as_dict()["batches"] == 1
        queued = [b.submit(np.zeros(2)) for _ in range(2)]
        with pytest.raises(RejectedError, match="queue full"):
            b.submit(np.zeros(2))
        assert b.stats.as_dict()["rejected_full"] == 1
    finally:
        gate.set()
        b.close()
    assert first.result(10) is not None
    assert all(q.result(10) is not None for q in queued)


def test_flag_validators_reject_at_parse(fresh_flags):
    with pytest.raises(ValueError, match="deep_cnn"):
        fresh_flags._parse(["--pallas", "--model", "mlp"])
    fresh_flags._reset()
    with pytest.raises(ValueError, match="power of two"):
        fresh_flags._parse(["--serve_max_batch", "6"])
    fresh_flags._reset()
    fresh_flags._parse([])
    assert fresh_flags.device == "cuda" and fresh_flags.serve_max_batch == 8


def test_serving_a_stateful_model_is_not_yet_ported(tmp_path):
    from distributed_tensorflow_tpu_torch.models import ResNet
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    with pytest.raises(NotImplementedError, match="not yet ported"):
        InferenceEngine(ResNet(), str(tmp_path), device="cpu")
