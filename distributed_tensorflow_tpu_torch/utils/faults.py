"""Deterministic fault injection: named points where a layer that
promises recovery can be made to fail on purpose.

The counterpart of ``distributed_tensorflow_tpu/utils/faults.py``, with
the same point names, spec grammar, modes and error messages, stdlib
only. A ``--fault_spec`` (or the ``DTT_FAULT_SPEC`` environment variable,
which reaches subprocesses the flag cannot) arms rules against the
points:

    --fault_spec serve_batch:mode=error
    --fault_spec serve_admit:at_count=3:mode=error
    --fault_spec "serve_reload:mode=torn_file,serve_batch:mode=delay"

Grammar: comma-separated rules; each rule is ``point[:key=value]...``.
Keys: ``mode`` (what happens, default ``error``), ``at_step``/``at_count``
(fire only when the site reports that step/count), ``after`` (skip the
first N matching hits), ``times`` (fire at most N times; 0 = unlimited;
default 1), ``delay`` (seconds, for ``mode=delay``).

Modes:
  crash      os._exit(FAULT_EXIT_CODE): no atexit, no finally.
  error      raise InjectedFault at the site (``refuse`` is an alias).
  torn_file  truncate the file the site names (ctx ``path``) to half.
  zero_file  truncate that file to zero bytes.
  bitflip    flip one bit mid-file.
  delay      sleep ``delay`` seconds (default 1.0).

The port calls the serving points (``serve_admit``, ``serve_batch``,
``serve_reload``), the checkpoint and input points (``ckpt_write``,
``ckpt_index``, ``ckpt_gc``, ``restore``, ``prefetch``, ``init``) and the
coordinated save's (``collective_fetch``, ``cancel_gate``,
``exit_agreement``). The registry keeps every point of the JAX package,
so one spec parses the same in both; ``preempt`` is called once
``training/elastic.py`` is ported, and the training entry refuses it.
With no spec configured ``fault_point`` is a no-op (one list
check).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

# the registry of every injection point threaded through the tree — the
# one discoverable list (``python tools/trace_ops.py --faults`` prints it).
# A spec naming anything else is rejected at parse time.
INJECTION_POINTS: dict[str, str] = {
    "ckpt_write": "after a checkpoint file lands on disk (monolithic npz "
                  "or one shard), BEFORE the index write and GC "
                  "[ctx: path, step]",
    "ckpt_index": "before the checkpoint index file is atomically "
                  "replaced [ctx: step]",
    "ckpt_gc": "at entry of checkpoint garbage collection [ctx: -]",
    "restore": "before a checkpoint file is read back (both formats) "
               "[ctx: path, step]",
    "exit_agreement": "inside the bounded exit-agreement allgather "
                      "(runs on its run_bounded thread) [ctx: clean]",
    "collective_fetch": "in Supervisor._coordinated_save before the "
                        "state fetch / sharded save [ctx: step]",
    "cancel_gate": "between the exit fetch and the cancel-gated write "
                   "[ctx: step]",
    "init": "before the distributed runtime initializes in "
            "cluster.maybe_initialize_distributed [ctx: attempt]",
    "prefetch": "in prefetch_to_device's staging thread, once per batch "
                "[ctx: count]",
    "serve_admit": "in serving.DynamicBatcher.submit after the admission "
                   "checks pass, before the request enqueues "
                   "[ctx: count]",
    "serve_batch": "in the serving batcher worker after a microbatch is "
                   "assembled, before the engine runs it "
                   "[ctx: count, size]",
    "serve_reload": "in serving.InferenceEngine.reload_if_newer before "
                    "the fallback-ladder restore of a newer checkpoint "
                    "(file modes corrupt that newest set) "
                    "[ctx: path, step]",
    "router_dispatch": "in serving.router before one dispatch attempt "
                       "is sent to the chosen replica (error/refuse "
                       "models a connect-fail the retry path must "
                       "absorb) [ctx: replica, count]",
    "router_health": "in the router's health poller before one "
                     "replica's /healthz+/metrics poll (error models "
                     "an unreachable replica — the breaker's poll-side "
                     "feed) [ctx: replica, count]",
    "router_hedge": "in the router's hedge timer after the latency "
                    "budget expires, before the duplicate dispatch "
                    "launches [ctx: request_id, count]",
    "preempt": "in the elasticity supervisor's boundary poll "
               "(training/elastic.py) — models a spot/preemptible "
               "capacity loss. mode=notice: advance warning, the run "
               "drains to the next checkpoint boundary before the host "
               "departs; mode=immediate: the capacity is gone NOW and "
               "the in-flight step is lost (restore falls back to the "
               "last checkpoint or the sentinel's emergency snapshot). "
               "Keys: host=H (which world member departs; default the "
               "highest-indexed), notice_s=S (the modeled grace "
               "window, recorded in the membership_change span), "
               "rejoin_steps=N (the departed host re-joins N steps "
               "after the resize — the kill-and-re-add chaos shape) "
               "[ctx: step]",
}

MODES = ("crash", "error", "refuse", "torn_file", "zero_file", "bitflip",
         "delay", "notice", "immediate")
_FILE_MODES = ("torn_file", "zero_file", "bitflip")
# preemption modes only make sense on the preempt point (and vice versa:
# a file mode on preempt would ask for a path the poll site cannot name)
_PREEMPT_MODES = ("notice", "immediate")
_PREEMPT_KEYS = ("notice_s", "host", "rejoin_steps")

FAULT_EXIT_CODE = 17  # the injected hard-crash exit status


class InjectedFault(RuntimeError):
    """The error raised by mode=error/refuse — never raised by real code,
    so tests and harnesses can assert the failure was the injected one."""


class Preempted(InjectedFault):
    """Raised by the ``preempt`` point's notice/immediate modes: the
    modeled spot-preemption signal. ONLY the elasticity supervisor's
    boundary poll calls that point, and it catches this exception and
    turns it into a planned membership change (training/elastic.py) —
    an unhandled Preempted means no supervisor was armed, which is
    itself the honest un-elastic behavior (the run dies like a real
    unhandled preemption)."""

    def __init__(self, desc: str, host: int | None = None,
                 notice_s: float = 0.0, immediate: bool = False,
                 rejoin_steps: int = 0, at_step: int | None = None):
        super().__init__(desc)
        self.host = host
        self.notice_s = notice_s
        self.immediate = immediate
        self.rejoin_steps = rejoin_steps
        # the originating rule's identity (host, at_step) lets the
        # elasticity supervisor execute each configured departure at
        # most once per RUN — loop re-entries re-arm the rules, so the
        # fired counter alone cannot carry that guarantee
        self.at_step = at_step


class FaultSpecError(ValueError):
    """A --fault_spec string that doesn't parse (unknown point/mode/key)."""


@dataclass
class FaultRule:
    point: str
    mode: str = "error"
    at_step: int | None = None
    at_count: int | None = None
    after: int = 0
    times: int = 1  # 0 = unlimited
    delay: float = 1.0
    # preempt-point payload (parse rejects these keys elsewhere)
    host: int | None = None
    notice_s: float = 0.0
    rejoin_steps: int = 0
    # mutable runtime counters
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)


_INT_KEYS = ("at_step", "at_count", "after", "times", "host",
             "rejoin_steps")


def parse_fault_spec(spec: str) -> list[FaultRule]:
    """``spec`` -> rules; raises FaultSpecError with the grammar on any
    mistake (this also backs the parse-time flag validator, so a typo
    surfaces at the command line, not mid-run)."""
    rules: list[FaultRule] = []
    for part in (p.strip() for p in (spec or "").split(",")):
        if not part:
            continue
        tokens = part.split(":")
        point = tokens[0].strip()
        if point not in INJECTION_POINTS:
            raise FaultSpecError(
                f"unknown injection point {point!r}; registered points: "
                f"{', '.join(sorted(INJECTION_POINTS))} (see "
                f"tools/trace_ops.py --faults)")
        rule = FaultRule(point=point)
        for tok in tokens[1:]:
            if "=" not in tok:
                raise FaultSpecError(
                    f"bad token {tok!r} in rule {part!r}: expected "
                    f"key=value (grammar: point[:key=value]...)")
            key, val = (s.strip() for s in tok.split("=", 1))
            if key == "mode":
                if val not in MODES:
                    raise FaultSpecError(
                        f"unknown mode {val!r} in rule {part!r}; modes: "
                        f"{', '.join(MODES)}")
                rule.mode = val
            elif key in _INT_KEYS:
                try:
                    setattr(rule, key, int(val))
                except ValueError:
                    raise FaultSpecError(
                        f"{key}={val!r} in rule {part!r}: expected an "
                        f"integer") from None
            elif key in ("delay", "notice_s"):
                try:
                    setattr(rule, key, float(val))
                except ValueError:
                    raise FaultSpecError(
                        f"{key}={val!r} in rule {part!r}: expected "
                        f"seconds") from None
            else:
                raise FaultSpecError(
                    f"unknown key {key!r} in rule {part!r}; keys: mode, "
                    f"{', '.join(_INT_KEYS)}, delay, notice_s")
        _check_preempt_rule(rule, part)
        rules.append(rule)
    return rules


def _check_preempt_rule(rule: FaultRule, part: str) -> None:
    """Cross-field consistency for the preempt point: the preemption
    modes/keys belong to it and to nothing else, and a file mode on it
    would ask for a path the poll site can never name."""
    if rule.point == "preempt":
        if rule.mode in _FILE_MODES:
            raise FaultSpecError(
                f"mode={rule.mode} in rule {part!r}: the preempt poll "
                f"site names no file; preempt modes are "
                f"{', '.join(_PREEMPT_MODES)} (or error/crash/delay)")
        if rule.notice_s < 0:
            raise FaultSpecError(
                f"notice_s={rule.notice_s} in rule {part!r}: the "
                f"preemption grace window must be >= 0 seconds")
        if rule.rejoin_steps < 0:
            raise FaultSpecError(
                f"rejoin_steps={rule.rejoin_steps} in rule {part!r} "
                f"must be >= 0 (0 = the host never re-joins)")
        if rule.host is not None and rule.host < 0:
            raise FaultSpecError(
                f"host={rule.host} in rule {part!r} must be >= 0 (a "
                f"world-member index)")
        return
    if rule.mode in _PREEMPT_MODES:
        raise FaultSpecError(
            f"mode={rule.mode} in rule {part!r} only applies to the "
            f"preempt point (it is the spot-preemption signal)")
    for key in _PREEMPT_KEYS:
        default = FaultRule(point=rule.point)
        if getattr(rule, key) != getattr(default, key):
            raise FaultSpecError(
                f"key {key!r} in rule {part!r} only applies to the "
                f"preempt point (it parameterizes the membership "
                f"change)")


_LOCK = threading.Lock()
_RULES: list[FaultRule] = []
_ENV_CHECKED = False


def configure(spec: str | None) -> list[FaultRule]:
    """Arm (or with None/'' disarm) the injection rules for this process."""
    global _RULES, _ENV_CHECKED
    with _LOCK:
        _RULES = parse_fault_spec(spec) if spec else []
        _ENV_CHECKED = True  # an explicit configure overrides the env var
    return _RULES


def configure_from_flags(FLAGS) -> list[FaultRule]:
    """The one flag->feature mapping for ``--fault_spec``; an empty flag
    falls back to the DTT_FAULT_SPEC env var (the way a test harness arms
    a subprocess it doesn't own the argv of)."""
    spec = getattr(FLAGS, "fault_spec", "") or os.environ.get(
        "DTT_FAULT_SPEC", "")
    return configure(spec)


def reset() -> None:
    """Disarm everything and forget the env check (test isolation)."""
    global _RULES, _ENV_CHECKED
    with _LOCK:
        _RULES = []
        _ENV_CHECKED = False


def active() -> bool:
    return bool(_RULES)


def _ensure_env_rules() -> None:
    """Lazily arm rules from DTT_FAULT_SPEC if no explicit configure ran
    (the one-time env check fault_point performs, factored out so
    ``armed_points`` sees env-armed rules too)."""
    global _ENV_CHECKED
    if _RULES or _ENV_CHECKED:
        return
    with _LOCK:
        if not _ENV_CHECKED:
            _ENV_CHECKED = True
            spec = os.environ.get("DTT_FAULT_SPEC", "")
            if spec:
                _RULES[:] = parse_fault_spec(spec)


def armed_points() -> set:
    """The set of injection-point names with a configured rule (env-var
    rules included) — how the elasticity supervisor auto-arms when a
    ``preempt`` rule exists without an explicit ``--elastic``."""
    _ensure_env_rules()
    return {r.point for r in _RULES}


def _corrupt_file(path: str, mode: str) -> None:
    size = os.path.getsize(path)
    if mode == "zero_file":
        with open(path, "r+b") as f:
            f.truncate(0)
    elif mode == "torn_file":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif mode == "bitflip":
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([(b[0] if b else 0) ^ 0x01]))


def fault_point(name: str, **ctx) -> None:
    """The injection site call. No-op unless a configured rule matches
    ``name`` and the ctx filters; then performs the rule's mode (which may
    not return: crash exits the process, error/refuse raises)."""
    if not _RULES:
        _ensure_env_rules()
        if not _RULES:
            return
    for rule in _RULES:
        if rule.point != name:
            continue
        if rule.at_step is not None and ctx.get("step") != rule.at_step:
            continue
        if rule.at_count is not None and ctx.get("count") != rule.at_count:
            continue
        with _LOCK:
            rule.hits += 1
            if rule.hits <= rule.after:
                continue
            if rule.times and rule.fired >= rule.times:
                continue
            rule.fired += 1
        _fire(rule, name, ctx)


def _fire(rule: FaultRule, name: str, ctx: dict) -> None:
    desc = f"injected fault at {name} (mode={rule.mode}, ctx={ctx})"
    try:
        # flight-recorder hook BEFORE the mode's effect: mode=crash is
        # os._exit — no atexit, no excepthook — so this is the one
        # chance to leave a postmortem
        from distributed_tensorflow_tpu_torch.utils import telemetry

        telemetry.record_fault(name, rule.mode, ctx)
    except Exception:  # noqa: BLE001 — telemetry never alters fault semantics
        pass
    if rule.mode == "crash":
        print(f"{desc}: hard-exiting {FAULT_EXIT_CODE}", flush=True)
        os._exit(FAULT_EXIT_CODE)
    if rule.mode in _PREEMPT_MODES:
        raise Preempted(desc, host=rule.host, notice_s=rule.notice_s,
                        immediate=(rule.mode == "immediate"),
                        rejoin_steps=rule.rejoin_steps,
                        at_step=rule.at_step)
    if rule.mode in ("error", "refuse"):
        raise InjectedFault(desc)
    if rule.mode == "delay":
        print(f"{desc}: sleeping {rule.delay}s", flush=True)
        time.sleep(rule.delay)
        return
    if rule.mode in _FILE_MODES:
        path = ctx.get("path")
        if not path:
            raise InjectedFault(
                f"{desc}: mode {rule.mode!r} needs a file but injection "
                f"point {name!r} reports no path")
        _corrupt_file(path, rule.mode)
        print(f"{desc}: corrupted {path}", flush=True)
        return
    raise AssertionError(f"unhandled fault mode {rule.mode!r}")


def describe_points() -> str:
    """Human-readable registry (tools/trace_ops.py --faults)."""
    lines = ["registered fault-injection points "
             "(--fault_spec point[:key=value]...[,rule...]):", ""]
    width = max(len(n) for n in INJECTION_POINTS)
    for pname in sorted(INJECTION_POINTS):
        lines.append(f"  {pname:<{width}}  {INJECTION_POINTS[pname]}")
    lines += [
        "",
        f"modes: {', '.join(MODES)} (notice/immediate: preempt only)",
        "keys:  mode, at_step, at_count, after, times (0=unlimited), "
        "delay, host, notice_s, rejoin_steps (last three: preempt only)",
        "examples:",
        "  --fault_spec ckpt_write:at_step=40:mode=crash",
        "  --fault_spec restore:mode=torn_file",
        "  --fault_spec init:mode=refuse:times=2",
        "  --fault_spec preempt:at_step=60:mode=notice:notice_s=30:host=3",
        "  --fault_spec preempt:mode=immediate:host=2:rejoin_steps=40",
        "  DTT_FAULT_SPEC=prefetch:at_count=3:mode=error  (env var form "
        "for subprocesses)",
    ]
    return "\n".join(lines)
