"""The port's request plane (``serving/reqtrace.py``) and its hooks in the
batcher, engine and server, against the JAX package's, on the CPU.

- request ids are minted or echoed, in process and over HTTP, on every
  answer (success, 429, 400);
- every exit of ``DynamicBatcher`` gets its disposition and a phase
  timeline that sums to the wall time (but a batch failed before it ran,
  as in the JAX plane); the expired request's story is
  whole in the span file, read by the JAX package's ``tools/req_report``;
- on one recorded sequence of request timelines, on one fake clock, the
  port's ``tail_report``, ``slo_report`` and audit ring equal the JAX
  plane's exactly;
- ``/healthz`` turns 503 on a fast SLO burn; ``/admin/reload`` picks up a
  newer checkpoint; ``--telemetry=false`` keeps ids but records nothing;
- the request-plane flag validators give the JAX package's messages.

The served model is a TransformerLM, V 32, S 16, d 16, 2 heads, 1 block."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import flags as jflags
from distributed_tensorflow_tpu.serving import reqtrace as jreq
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.checkpoint import save_checkpoint
from distributed_tensorflow_tpu_torch.models import TransformerLM
from distributed_tensorflow_tpu_torch.serving import (
    DynamicBatcher,
    InferenceEngine,
    InferenceServer,
    InProcessClient,
    RejectedError,
    generate_group_key,
    make_generate_runner,
    make_predict_runner,
    predict_group_key,
    reqtrace,
)
from distributed_tensorflow_tpu_torch.serving.__main__ import (
    build_serving_stack,
)
from distributed_tensorflow_tpu_torch.utils import faults, telemetry
from distributed_tensorflow_tpu_torch.utils.pytree import params_to_numpy

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

V, S, D, H, NB = 32, 16, 16, 2, 1


@pytest.fixture(autouse=True)
def _clean():
    """The plane, the faults and the tracer are process-global."""
    faults.reset()
    prev = reqtrace.get_plane()
    yield
    faults.reset()
    reqtrace._PLANE = prev
    telemetry.configure(logdir=None, enabled=True)


@pytest.fixture
def plane():
    return reqtrace.configure(enabled=True, slo_p99_ms=60_000.0)


def _model(seed=0):
    return TransformerLM(vocab_size=V, seq_len=S, d_model=D, num_heads=H,
                         num_blocks=NB).init(torch.Generator().manual_seed(
                             seed))


def _write(logdir, step, seed=0):
    save_checkpoint(str(logdir), {"params": params_to_numpy(_model(seed)),
                                  "step": np.int32(step)}, step)


def _engine(logdir):
    _write(logdir, 10)
    return InferenceEngine(_model(), str(logdir), device="cpu", max_batch=4)


def _predict_batcher(eng, **kw):
    cfg = dict(max_batch=4, max_delay_ms=1.0, queue_depth=64,
               group_key=predict_group_key, name="predict")
    cfg.update(kw)
    return DynamicBatcher(make_predict_runner(eng), **cfg)


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# ------------------------------------------------------ ids and phases


def test_ids_echo_in_process_and_over_http(tmp_path, plane):
    eng = _engine(tmp_path)
    pb = _predict_batcher(eng)
    gb = DynamicBatcher(make_generate_runner(eng), max_batch=4,
                        max_delay_ms=1, queue_depth=8,
                        group_key=generate_group_key, name="generate")
    client = InProcessClient(pb, gb)
    _out, meta = client.predict_ex(np.zeros(S, np.int32))
    assert meta["request_id"].startswith("req-")
    assert meta["disposition"] == "ok" and meta["served_step"] == 10
    _out, meta = client.predict_ex(np.zeros(S, np.int32),
                                   request_id="req-client-0042")
    assert meta["request_id"] == "req-client-0042"
    assert plane.audit[-1]["request_id"] == "req-client-0042"
    srv = InferenceServer(eng, client, port=0).start_background()
    try:
        code, out = _post(srv.address + "/v1/predict",
                          {"inputs": [0] * S, "request_id": "req-http-7"})
        assert code == 200 and out["request_id"] == "req-http-7"
        assert set(out["phases_ms"]) >= {"admit", "queue_wait",
                                         "batch_assembly", "prefill",
                                         "respond"}
        code, out = _post(srv.address + "/v1/generate",
                          {"prompt": list(range(8)), "max_new_tokens": 4})
        assert code == 200 and out["request_id"].startswith("req-")
        assert out["phases_ms"]["decode"] >= 0 and out["bucket"] == 8
        assert plane.audit[-1]["decode_ticks"] == 4
        code, out = _post(srv.address + "/v1/generate",
                          {"prompt": [1, 99], "request_id": "req-bad-1"})
        assert code == 400 and out["request_id"] == "req-bad-1"
        gb.close(drain=False)
        code, out = _post(srv.address + "/v1/generate",
                          {"prompt": [1, 2, 3], "request_id": "req-rej-1"})
        assert code == 429 and out["request_id"] == "req-rej-1"
        assert plane.audit[-1]["disposition"] == "rejected_closed"
    finally:
        srv.close()
        pb.close(drain=False)


def test_every_exit_gets_its_disposition(tmp_path, plane):
    gate = threading.Event()

    def slow(payloads, opts_list):
        gate.wait(10)
        return payloads

    b = DynamicBatcher(slow, max_batch=1, max_delay_ms=0, queue_depth=2,
                       default_timeout_ms=60_000, name="predict")
    futs = [b.submit(np.zeros(1))]
    time.sleep(0.05)
    futs += [b.submit(np.zeros(1)),
             b.submit(np.zeros(1), timeout_ms=30)]
    with pytest.raises(RejectedError) as ei:
        b.submit(np.zeros(1))
    assert ei.value.request_id.startswith("req-")
    assert plane.audit[-1]["disposition"] == "rejected_full"
    assert plane.audit[-1]["request_id"] == ei.value.request_id
    with pytest.raises(RejectedError, match="deadline"):
        futs[2].result(5)
    assert futs[2].meta["disposition"] == "expired"
    gate.set()
    for f in futs[:2]:
        f.result(5)
        assert f.meta["disposition"] == "ok"
    faults.configure("serve_admit:mode=error:times=1")
    with pytest.raises(RejectedError, match="admission fault"):
        b.submit(np.zeros(1))
    assert plane.audit[-1]["disposition"] == "rejected_fault"
    faults.configure("serve_batch:mode=error:times=1")
    bad = b.submit(np.zeros(1))
    with pytest.raises(faults.InjectedFault):
        bad.result(5)
    assert bad.meta["disposition"] == "failed"
    assert "InjectedFault" in bad.meta["reason"]
    b.close()
    with pytest.raises(RejectedError):
        b.submit(np.zeros(1))
    assert plane.audit[-1]["disposition"] == "rejected_closed"
    assert b.stats.as_dict()["rejected_fault"] == 1
    assert {s["disposition"] for s in plane.audit} == set(
        reqtrace.DISPOSITIONS)
    # a batch that fails at the serve_batch point has been taken but never
    # ran: the plane (the JAX package's as well) leaves the time after the
    # take unattributed, so its phases stop short of the wall time
    for s in plane.audit:
        total = sum(s["phases_ms"].values())
        if s["disposition"] == "failed":
            assert set(s["phases_ms"]) == {"admit", "queue_wait"}
            assert total <= s["total_ms"] + 0.05
        else:
            assert total == pytest.approx(s["total_ms"], abs=0.05)


def test_expired_story_is_whole_in_the_span_file(tmp_path, plane):
    logdir = str(tmp_path / "logs")
    telemetry.configure(logdir=logdir, host="serve-0", enabled=True)
    gate = threading.Event()

    def slow(payloads, opts_list):
        gate.wait(10)
        return payloads

    b = DynamicBatcher(slow, max_batch=1, max_delay_ms=0, queue_depth=8,
                       name="predict")
    first = b.submit(np.zeros(1), timeout_ms=60_000)
    time.sleep(0.05)
    doomed = b.submit(np.zeros(1), timeout_ms=30)
    with pytest.raises(RejectedError, match="deadline"):
        doomed.result(5)
    gate.set()
    first.result(5)
    b.close()
    telemetry.get_tracer().flush()
    path = os.path.join(logdir, "spans-serve-0.jsonl")
    recs = [json.loads(ln) for ln in open(path)]
    mine = [r for r in recs if r.get("request_id") == doomed.request_id]
    done = [r for r in mine if r["name"] == "req:done"]
    assert done and done[0]["disposition"] == "expired"
    waits = [r for r in mine if r["name"] == "req:queue_wait"]
    assert waits and waits[0]["dur_s"] * 1e3 >= 25
    assert any(r["name"] == "serve_batch" for r in recs)
    # the JAX package's offline report reads the port's span file
    from tools import req_report

    reqs = req_report.collect_requests(req_report.load_records(path))
    assert reqs[doomed.request_id]["disposition"] == "expired"
    assert not req_report.incomplete_requests(reqs)


# ------------------------------------------- the reports against JAX


class _Clock:
    """One fake clock for both planes: ``monotonic``, ``time`` and
    ``perf_counter`` read the same advancing value."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    time = perf_counter = monotonic


def _record(mod, clock):
    """A fixed sequence of timelines on either package's plane: ok
    requests over two routes and buckets, a slow tail, every rejection
    and a duplicate finish of a retried id."""
    plane = mod.RequestPlane(ring=16, exemplars=3, slo_p99_ms=50.0,
                             slo_target_pct=99.0)
    rng = np.random.default_rng(4)
    for i in range(40):
        route = "generate" if i % 3 else "predict"
        tr = plane.begin(f"req-{i}", route, np.zeros(1 + i % 9))
        clock.now += 0.001
        tr.admitted()
        clock.now += float(rng.uniform(0.0, 0.03)) + (0.2 if i == 17 else 0)
        if i % 11 == 5:
            plane.finish(tr, "expired", reason="deadline")
            continue
        tr.taken()
        clock.now += 0.002
        tr.run_start()
        tr.note("prefill", 0.004)
        tr.note("decode", float(rng.uniform(0.001, 0.02)), ticks=4)
        clock.now += 0.03
        tr.run_end()
        clock.now += 0.0005
        plane.finish(tr, "ok")
    for disp in ("rejected_full", "rejected_closed", "rejected_fault",
                 "failed"):
        tr = plane.begin(f"req-{disp}", "predict", np.zeros(4))
        clock.now += 0.002
        plane.finish(tr, disp, reason=disp)
    tr = plane.begin("req-3", "generate", np.zeros(4))  # a retry of req-3
    clock.now += 0.001
    plane.finish(tr, "failed", reason="retry")
    return plane


def test_tail_and_slo_reports_equal_jax(monkeypatch):
    clock = _Clock()
    for mod in (reqtrace, jreq):
        monkeypatch.setattr(mod, "time", clock)
    start = clock.now
    got = _record(reqtrace, clock)
    clock.now = start
    want = _record(jreq, clock)
    assert got.tail_report() == want.tail_report()
    assert got.slo_report() == want.slo_report()
    assert got.audit_snapshot() == want.audit_snapshot()
    assert got.slo_deduped == want.slo_deduped == 1
    tail = got.tail_report()
    totals = [e["total_ms"] for e in tail["exemplars"]]
    assert len(totals) == 3 and totals == sorted(totals, reverse=True)
    assert tail["requests_total"] == 45
    assert reqtrace.pow2_ceil(5) == 8 and reqtrace.shape_bucket([1] * 9) == 16


def test_fast_burn_turns_healthz_503(tmp_path):
    plane = reqtrace.configure(enabled=True, slo_p99_ms=0.0001)
    eng = _engine(tmp_path)
    b = _predict_batcher(eng)
    client = InProcessClient(predict_batcher=b)
    srv = InferenceServer(eng, client, port=0).start_background()
    try:
        for _ in range(12):  # >= MIN_WINDOW_COUNT, all non-compliant
            client.predict_ex(np.zeros(S, np.int32))
        rep = plane.slo_report()
        assert rep["compliant_pct"] == 0.0 and rep["fast_burn_breach"]
        code, body = _get(srv.address + "/healthz")
        assert code == 503
        assert body["ok"] is False and body["slo_fast_burn"] is True
        code, m = _get(srv.address + "/metrics")
        assert code == 200 and m["slo"]["fast_burn_breach"] is True
        assert m["tail"]["exemplars"] and m["hbm"] is None
        assert m["tail"]["routes"]["predict"]["16"]["total"]["count"] == 12
    finally:
        srv.close()
        b.close(drain=False)


def test_admin_reload_picks_up_a_newer_checkpoint(tmp_path, plane):
    logdir = str(tmp_path / "logs")
    telemetry.configure(logdir=logdir, host="serve-0", enabled=True)
    eng = _engine(tmp_path)
    b = _predict_batcher(eng)
    srv = InferenceServer(eng, InProcessClient(b), port=0).start_background()
    x = [3] * S
    try:
        _code, before = _post(srv.address + "/v1/predict", {"inputs": x})
        code, out = _post(srv.address + "/admin/reload", {})
        assert code == 200 and out == {"reloaded": False, "report": None,
                                       "params_step": 10}
        _write(tmp_path, 20, seed=1)
        code, out = _post(srv.address + "/admin/reload", {})
        assert code == 200 and out["reloaded"] and out["params_step"] == 20
        assert out["report"]["swapped"] and out["report"]["step"] == 20
        _code, after = _post(srv.address + "/v1/predict", {"inputs": x})
        assert after["served_step"] == 20 and before["served_step"] == 10
        assert after["outputs"] != before["outputs"]
        # a torn newest set: the ladder walks back, serving goes on
        _write(tmp_path, 30, seed=2)
        faults.configure("serve_reload:mode=torn_file")
        code, out = _post(srv.address + "/admin/reload", {})
        assert code == 200 and not out["report"]["swapped"]
        assert out["params_step"] == 20
    finally:
        srv.close()
        b.close()
    telemetry.get_tracer().flush()
    names = [json.loads(ln)["name"] for ln in
             open(os.path.join(logdir, "spans-serve-0.jsonl"))]
    assert names.count("serve_reload") == 2
    assert "fault:serve_reload" in names


def test_telemetry_off_keeps_ids_but_records_nothing(tmp_path):
    flags.define_flags()
    flags.FLAGS._reset()
    try:
        _write(tmp_path, 10)
        flags.FLAGS._parse(["--device", "cpu", "--logdir", str(tmp_path),
                            "--model", "lm", "--dataset", "lm", "--seq_len",
                            str(S), "--vocab_size", str(V), "--d_model",
                            str(D), "--num_heads", str(H), "--num_blocks",
                            str(NB), "--serve_reload_secs", "0",
                            "--telemetry=false"])
        engine, client, _, metrics = build_serving_stack(flags.FLAGS)
        try:
            assert reqtrace.get_plane() is None
            _out, meta = client.predict_ex(np.zeros(S, np.int32))
            assert meta["request_id"].startswith("req-")
            assert "phases_ms" not in meta
            assert not telemetry.get_tracer().enabled
        finally:
            client.predict_batcher.close()
            client.generate_batcher.close()
            metrics.logger.close()
        assert not any(n.startswith("spans-") for n in os.listdir(tmp_path))
    finally:
        flags.FLAGS._reset()


def test_serving_metrics_cadence_emits_slo_scalars(tmp_path):
    from distributed_tensorflow_tpu_torch.serving import ServingMetrics
    from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger

    reqtrace.configure(enabled=True, slo_p99_ms=60_000.0)
    eng = _engine(tmp_path)
    logdir = str(tmp_path / "logs")
    logger = MetricsLogger(logdir, job_name="serve",
                           filename="serve_metrics.jsonl")
    metrics = ServingMetrics(logger, eng, emit_every=1)
    b = _predict_batcher(eng, on_batch=metrics.on_batch)
    client = InProcessClient(predict_batcher=b)
    for _ in range(3):
        client.predict_ex(np.zeros(S, np.int32))
    b.close()
    logger.close()
    lines = [json.loads(ln) for ln in
             open(os.path.join(logdir, "serve_metrics.jsonl"))]
    assert {"serve_slo_compliant_pct", "serve_slo_budget_remaining_pct",
            "serve_slo_burn_rate_fast"} <= set(lines[-1])
    assert lines[-1]["serve_slo_compliant_pct"] == 100.0


@pytest.mark.parametrize("argv", [
    ["--slo_p99_ms=-1"],
    ["--slo_target_pct=40"],
    ["--slo_target_pct=100.5"],
    ["--slo_target_pct=95"],
    ["--reqtrace_ring=4"],
    ["--reqtrace_exemplars=0"],
    ["--telemetry=false", "--slo_p99_ms=100"],
    ["--telemetry=false", "--reqtrace_ring=1024"],
    ["--telemetry=false", "--reqtrace_exemplars=9"],
])
def test_reqtrace_flag_validators_refuse_with_jax_messages(argv):
    flags.define_flags()
    jflags.define_reference_flags()
    flags.FLAGS._reset()
    jflags.FLAGS._reset()
    messages = []
    try:
        for fl in (flags.FLAGS, jflags.FLAGS):
            with pytest.raises(ValueError) as ei:
                fl._parse(argv)
            messages.append(str(ei.value))
    finally:
        flags.FLAGS._reset()
        jflags.FLAGS._reset()
    assert messages[0] == messages[1]


def test_configure_from_flags_follows_telemetry():
    flags.define_flags()
    flags.FLAGS._reset()
    try:
        flags.FLAGS._parse(["--slo_p99_ms=100", "--slo_target_pct=95",
                            "--reqtrace_ring=64"])
        plane = reqtrace.configure_from_flags(flags.FLAGS)
        assert plane.slo.p99_ms == 100.0 and plane.slo.target_pct == 95.0
        assert plane.audit.maxlen == 64
        flags.FLAGS._reset()
        flags.FLAGS._parse(["--telemetry=false"])  # the defaults stay legal
        assert reqtrace.configure_from_flags(flags.FLAGS) is None
    finally:
        flags.FLAGS._reset()
