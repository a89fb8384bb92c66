"""The port's fault injection (``utils/faults.py``) and telemetry spine
(``utils/telemetry.py``) against the JAX package's, on the CPU.

``parse_fault_spec`` must give the JAX package's rules for the same valid
specs and its error messages, word for word, for the same mistakes; a
sequence of ``fault_point`` hits must fire the same rules the same number
of times. The span tracer's JSONL sink must hold the JAX tracer's records
for the same calls (names, attributes, depths, instants; the clock fields
exist and are positive), and ``chrome_trace`` must turn one record set
into the JAX package's Chrome trace exactly. The watchdog and the flight
recorder are driven through their reports."""

import dataclasses
import io
import json
import os
import time

import pytest
import torch

from distributed_tensorflow_tpu.utils import faults as jfaults
from distributed_tensorflow_tpu.utils import telemetry as jtel
from distributed_tensorflow_tpu_torch import flags
from distributed_tensorflow_tpu_torch.utils import faults, telemetry

# one intra-op thread: the suite runs several test (and rank) processes
# on the host's cores, where OpenMP's spinning threads oversubscribe it
torch.set_num_threads(1)

VALID = [
    "serve_batch:mode=error",
    "serve_admit:at_count=3:mode=error,serve_reload:mode=torn_file",
    "ckpt_write:at_step=40:mode=crash,restore:mode=torn_file,"
    "init:mode=refuse:times=2",
    "serve_batch:mode=delay:delay=0.25:after=2:times=0",
    "preempt:at_step=60:mode=notice:notice_s=30:host=3",
    "preempt:mode=immediate:host=2:rejoin_steps=40",
    " , serve_admit ,",
]
INVALID = [
    "bogus:mode=crash",
    "restore:mode=explode",
    "restore:frequency=2",
    "restore:at_step=x",
    "restore:mode",
    "serve_batch:delay=soon",
    "preempt:mode=torn_file",
    "preempt:notice_s=-1",
    "preempt:rejoin_steps=-2",
    "preempt:host=-1",
    "serve_batch:mode=notice",
    "serve_batch:host=1",
]


@pytest.fixture(autouse=True)
def _clean():
    """Faults and the two tracers are process-global: start and end
    disarmed, with no sink."""
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()
    for tel in (telemetry, jtel):
        tel.configure(logdir=None, enabled=True)
        tel.get_tracer().clear()


def _rule_fields(rules):
    return [dataclasses.asdict(r) for r in rules]


@pytest.mark.parametrize("spec", VALID)
def test_parse_fault_spec_matches_jax(spec):
    assert _rule_fields(faults.parse_fault_spec(spec)) == \
        _rule_fields(jfaults.parse_fault_spec(spec))


@pytest.mark.parametrize("spec", INVALID)
def test_parse_fault_spec_refuses_with_jax_messages(spec):
    with pytest.raises(faults.FaultSpecError) as got:
        faults.parse_fault_spec(spec)
    with pytest.raises(jfaults.FaultSpecError) as want:
        jfaults.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def test_registry_modes_and_descriptions_cover_jax():
    assert set(faults.INJECTION_POINTS) == set(jfaults.INJECTION_POINTS)
    assert faults.MODES == jfaults.MODES
    assert faults.FAULT_EXIT_CODE == jfaults.FAULT_EXIT_CODE
    text = faults.describe_points()
    for name in faults.INJECTION_POINTS:
        assert name in text


def _hits(mod, spec, calls):
    """Fire ``calls`` [(point, ctx)] against ``spec``; returns which calls
    raised, plus each rule's (hits, fired)."""
    mod.configure(spec)
    raised = []
    for i, (point, ctx) in enumerate(calls):
        try:
            mod.fault_point(point, **ctx)
        except mod.InjectedFault:
            raised.append(i)
    return raised, [(r.hits, r.fired) for r in mod._RULES]


def test_fault_point_fires_like_jax():
    spec = ("serve_batch:mode=error:after=1:times=2,"
            "serve_admit:at_count=3:mode=error")
    calls = ([("serve_batch", {"count": i, "size": 2}) for i in range(1, 6)]
             + [("serve_admit", {"count": i}) for i in range(1, 6)]
             + [("serve_reload", {"path": "x", "step": 1})])
    got = _hits(faults, spec, calls)
    assert got == _hits(jfaults, spec, calls)
    assert got[0] == [1, 2, 7]
    assert faults.active() and faults.armed_points() == {"serve_batch",
                                                          "serve_admit"}
    faults.configure(None)
    faults.fault_point("serve_batch", count=1)  # disarmed: a no-op


def test_env_var_arms_and_file_modes_corrupt(tmp_path, monkeypatch):
    monkeypatch.setenv("DTT_FAULT_SPEC", "serve_admit:mode=error")
    faults.reset()
    with pytest.raises(faults.InjectedFault, match="serve_admit"):
        faults.fault_point("serve_admit", count=1)
    monkeypatch.delenv("DTT_FAULT_SPEC")
    for mode, want in (("torn_file", 50), ("zero_file", 0),
                       ("bitflip", 100)):
        path = tmp_path / f"{mode}.bin"
        path.write_bytes(b"\x00" * 100)
        faults.configure(f"serve_reload:mode={mode}")
        faults.fault_point("serve_reload", path=str(path), step=3)
        data = path.read_bytes()
        assert len(data) == want
        if mode == "bitflip":
            assert data[50] == 1 and data.count(0) == 99
    faults.configure("serve_batch:mode=torn_file")
    with pytest.raises(faults.InjectedFault, match="needs a file"):
        faults.fault_point("serve_batch", count=1)


def test_flag_validator_refuses_a_bad_spec_at_parse():
    flags.define_flags()
    flags.FLAGS._reset()
    try:
        with pytest.raises(ValueError, match="--fault_spec: unknown "
                                             "injection point"):
            flags.FLAGS._parse(["--fault_spec", "nope:mode=error"])
        flags.FLAGS._reset()
        flags.FLAGS._parse(["--fault_spec", "serve_batch:mode=error"])
        assert [r.point for r in faults.configure_from_flags(flags.FLAGS)] \
            == ["serve_batch"]
    finally:
        flags.FLAGS._reset()


def _drive(tel):
    """The same span calls on either package's spine."""
    with tel.trace_span("outer", count=1):
        with tel.trace_span("inner", size=2):
            pass
        tel.get_tracer().record_instant("fault:serve_batch", mode="error",
                                        count=1)
    tel.record_span("req:decode", ts=1000.0, dur_s=0.25,
                    request_id="req-x", ticks=4)
    try:
        with tel.trace_span("fails"):
            raise KeyError("boom")
    except KeyError:
        pass


def _sink(tel, logdir):
    tel.configure(logdir=str(logdir), host="serve-0", enabled=True)
    _drive(tel)
    tel.get_tracer().flush()
    with open(os.path.join(str(logdir), "spans-serve-0.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_span_sink_records_match_jax(tmp_path):
    got = _sink(telemetry, tmp_path / "port")
    want = _sink(jtel, tmp_path / "jax")
    assert [r["name"] for r in got] == ["inner", "fault:serve_batch",
                                        "outer", "req:decode", "fails"]
    clock = ("ts", "dur_s", "tid")
    for g, w in zip(got, want, strict=True):
        assert {k: v for k, v in g.items() if k not in clock} == \
            {k: v for k, v in w.items() if k not in clock}
        assert g["ts"] > 0 and g["dur_s"] >= 0
    assert got[3]["ts"] == 1000.0 and got[3]["dur_s"] == 0.25
    assert got[4]["error"] == "KeyError"


def test_chrome_trace_equals_jax(tmp_path):
    records = _sink(telemetry, tmp_path)
    assert telemetry.chrome_trace(records) == jtel.chrome_trace(records)
    events = telemetry.chrome_trace(records)["traceEvents"]
    assert [e["ph"] for e in events] == ["X", "i", "X", "X", "X"]
    assert events[3]["dur"] == 0.25e6 and events[3]["args"]["ticks"] == 4


def test_disabled_tracer_records_nothing(tmp_path):
    telemetry.configure(logdir=str(tmp_path), enabled=False)
    telemetry.get_tracer().clear()
    _drive(telemetry)
    telemetry.get_tracer().flush()
    assert telemetry.last_spans() == []
    assert not os.path.exists(tmp_path / "spans-worker-0.jsonl")


def test_watchdog_reports_a_stall_and_the_flight_recorder_dumps(tmp_path):
    telemetry.configure(logdir=str(tmp_path), host="serve-0")
    out = io.StringIO()
    wd = telemetry.set_watchdog(telemetry.Watchdog(0.05, out=out))
    try:
        with telemetry.trace_span("before"):
            pass
        with telemetry.armed("serve_batch", count=7):
            time.sleep(0.4)
        with telemetry.armed("serve_batch", count=8):
            pass  # finishes in time: no report
        time.sleep(0.1)
    finally:
        telemetry.set_watchdog(None)
    assert wd.fired == 1
    report = out.getvalue()
    assert "WATCHDOG: 'serve_batch'" in report and "'count': 7" in report
    assert "before" in report
    path = tmp_path / "flightrec-serve-0.jsonl"
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["kind"] == "meta"
    assert lines[0]["reason"] == "watchdog:serve_batch"
    assert any(r.get("note") == "watchdog fired: serve_batch" for r in lines)
    # an injected error fault is an instant span and a fresh postmortem
    faults.configure("serve_admit:mode=error")
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("serve_admit", count=1)
    meta = json.loads(path.read_text().splitlines()[0])
    assert meta["reason"] == "fault:serve_admit:error"
    assert telemetry.last_spans(1)[0]["name"] == "fault:serve_admit"
    assert telemetry.armed("idle") is telemetry._NOOP


def test_configure_from_flags_names_the_serving_files(tmp_path):
    flags.define_flags()
    flags.FLAGS._reset()
    try:
        flags.FLAGS._parse(["--logdir", str(tmp_path), "--watchdog_s", "5",
                            "--flightrec_events", "8"])
        telemetry.configure_from_flags(flags.FLAGS, job_name="serve")
        assert telemetry.get_watchdog().timeout_s == 5.0
        assert telemetry.flight_recorder().path == str(
            tmp_path / "flightrec-serve-0.jsonl")
        with telemetry.trace_span("x"):
            pass
        telemetry.get_tracer().flush()
        assert (tmp_path / "spans-serve-0.jsonl").exists()
        for argv, msg in ((["--watchdog_s", "-1"], "watchdog_s"),
                          (["--watchdog_abort"], "watchdog_abort"),
                          (["--telemetry=false", "--watchdog_s", "2"],
                           "telemetry"),
                          (["--flightrec_events", "0"], "flightrec_events")):
            flags.FLAGS._reset()
            with pytest.raises(ValueError, match=msg):
                flags.FLAGS._parse(argv)
    finally:
        flags.FLAGS._reset()
        telemetry.set_watchdog(None)
