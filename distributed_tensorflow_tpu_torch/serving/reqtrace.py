"""The request plane: per-request tracing, tail-latency attribution and
SLO accounting for serving.

The counterpart of ``distributed_tensorflow_tpu/serving/reqtrace.py``,
over the port's ``utils/telemetry.py`` and ``utils/metrics``'
``StreamingHistogram`` (stdlib only, no torch):

- **Request ids.** Every request owns a ``request_id`` minted at
  admission (or supplied by the client and echoed back on the wire).
- **Phase timelines.** A request's life decomposes into ``admit``,
  ``queue_wait`` (admitted to taken by the worker), ``batch_assembly``
  (taken to model execution, plus the execution glue the engine did not
  claim), ``prefill``, ``decode`` (with a tick per token) and
  ``respond``. The phases of a finished request sum to its wall time by
  construction.
- **Dispositions.** Every request ends with exactly one of ``ok``,
  ``rejected_full``, ``rejected_closed``, ``rejected_fault``,
  ``expired`` or ``failed``, with the reason.
- **Emission.** At finish each phase lands as a backdated ``req:<phase>``
  span plus a ``req:done`` instant in the telemetry spine (the server's
  ``spans-serve-N.jsonl``), and the summary joins a bounded audit ring.
- **Tail attribution.** Per (route, shape bucket) histograms per phase,
  and the worst live exemplars by total latency: the ``tail`` block of
  ``/metrics``.
- **SLO accounting.** ``--slo_p99_ms`` and ``--slo_target_pct`` drive an
  error-budget ledger with fast and slow burn-rate windows: the ``slo``
  block of ``/metrics``, and ``/healthz`` 503 on a fast-burn breach.

``--telemetry=false`` leaves the plane unconfigured: ids still mint and
echo, but nothing is recorded.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

from distributed_tensorflow_tpu_torch.utils import telemetry
from distributed_tensorflow_tpu_torch.utils.metrics import StreamingHistogram

PHASES = ("admit", "queue_wait", "batch_assembly", "prefill", "decode",
          "respond")
DISPOSITIONS = ("ok", "rejected_full", "rejected_closed",
                "rejected_fault", "expired", "failed")

RING_DEFAULT = 512
EXEMPLARS_DEFAULT = 5

_SALT = os.urandom(3).hex()
_COUNTER = itertools.count(1)


def new_request_id() -> str:
    """Mint a process-unique request id (``req-<salt>-<n>``): a random
    per-process salt plus a counter — collision-free across replicas
    without coordination, readable in a log line."""
    return f"req-{_SALT}-{next(_COUNTER):06x}"


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= ``n`` (n >= 1) — THE rounding rule for
    batch/shape buckets; ``batcher.pow2_bucket`` wraps it with the
    batch cap, so tail-attribution bucket keys and the engine's batch
    padding can never round differently."""
    b = 1
    while b < n:
        b <<= 1
    return b


def shape_bucket(payload) -> int:
    """The tail-attribution shape key: the power-of-two bucket of the
    payload's leading dimension (a generate request's prompt length,
    a predict request's example length) — the same rounding the
    engine's batch padding uses, so "slow at bucket 64" names a padded
    shape, not a raw size."""
    try:
        n = len(payload)
    except TypeError:
        return 0
    return pow2_ceil(n) if n >= 1 else 1


class RequestTrace:
    """One request's in-flight timeline: monotonic marks set by the
    batcher as the request moves through its life, phase durations noted
    by the engine/decoder mid-execution. Cheap by construction — a
    handful of perf_counter reads per request; all derived accounting
    happens once, at finish."""

    __slots__ = ("plane", "request_id", "route", "bucket", "wall0", "t0",
                 "t_admitted", "t_taken", "t_run0", "t_run1", "noted",
                 "decode_ticks", "summary", "slot", "iter_admit",
                 "iter_retire", "served_step")

    def __init__(self, plane, request_id: str, route: str, bucket: int):
        self.plane = plane
        self.request_id = request_id
        self.route = route
        self.bucket = bucket
        self.wall0 = time.time()
        self.t0 = time.monotonic()
        self.t_admitted = None
        self.t_taken = None
        self.t_run0 = None
        self.t_run1 = None
        self.noted: dict = {}
        self.decode_ticks = 0
        self.summary = None
        # continuous batching: which batch slot served the
        # request and at which scheduler iterations it entered/left —
        # None under the whole-batch scheduler
        self.slot = None
        self.iter_admit = None
        self.iter_retire = None
        # the checkpoint step of the parameters that served this
        # request (a hot reload never mixes steps within one batch)
        self.served_step = None

    def admitted(self) -> None:
        self.t_admitted = time.monotonic()

    def taken(self) -> None:
        self.t_taken = time.monotonic()

    def run_start(self) -> None:
        self.t_run0 = time.monotonic()

    def run_end(self) -> None:
        self.t_run1 = time.monotonic()

    def note(self, phase: str, dur_s: float, ticks: int | None = None) \
            -> None:
        """Attribute ``dur_s`` of the current batch execution to
        ``phase`` (prefill/decode — engine-side measurement). Additive:
        a retried prefill accumulates."""
        self.noted[phase] = self.noted.get(phase, 0.0) + float(dur_s)
        if ticks:
            self.decode_ticks += int(ticks)

    def _phases(self, now: float) -> dict:
        """Phase durations (seconds). Exhaustive by construction: every
        monotonic interval of the request's life lands in exactly one
        phase, so the sum equals the wall time."""
        p: dict = {}
        admitted = self.t_admitted
        p["admit"] = (admitted if admitted is not None else now) - self.t0
        if admitted is None:
            return p
        if self.t_taken is not None:
            p["queue_wait"] = self.t_taken - admitted
        elif self.t_run0 is None:
            # never taken (expired in queue / rejected at close): the
            # whole wait is queue time
            p["queue_wait"] = now - admitted
            return p
        run0, run1 = self.t_run0, self.t_run1
        if run0 is None:
            return p
        assembly = run0 - self.t_taken
        exec_end = run1 if run1 is not None else now
        noted_sum = 0.0
        for phase in ("prefill", "decode"):
            if phase in self.noted:
                p[phase] = self.noted[phase]
                noted_sum += self.noted[phase]
        # the execute residual the engine didn't claim (np.stack /
        # unstack glue, runner overhead) is assembly-and-response glue;
        # folding it here keeps sum(phases) == wall exactly
        p["batch_assembly"] = assembly + max(
            (exec_end - run0) - noted_sum, 0.0)
        if run1 is not None:
            p["respond"] = now - run1
        return p


class SLOLedger:
    """Error-budget accounting over a latency SLO: a request is
    COMPLIANT when it completed ok within ``p99_ms``; ``target_pct`` of
    requests are promised compliant, and the remainder is the error
    budget. Burn rate = (observed non-compliance rate) / (budgeted
    rate), measured over a fast and a slow window (the SRE
    multiwindow-multi-burn-rate pattern: the fast window catches an
    outage in minutes, the slow window a simmering regression).
    ``fast_burn_breach`` — the /healthz 503 condition — requires both
    the threshold and a minimum window population, so one slow request
    on an idle replica cannot drain it."""

    FAST_WINDOW_S = 60.0
    SLOW_WINDOW_S = 600.0
    FAST_BURN_THRESHOLD = 14.0  # the SRE-book page-now multiple
    MIN_WINDOW_COUNT = 10

    def __init__(self, p99_ms: float, target_pct: float = 99.0):
        if p99_ms <= 0:
            raise ValueError(f"slo p99_ms must be > 0, got {p99_ms}")
        if not (50.0 < target_pct <= 100.0):
            raise ValueError(f"slo target_pct must be in (50, 100], "
                             f"got {target_pct}")
        self.p99_ms = float(p99_ms)
        self.target_pct = float(target_pct)
        self._allowed = max(1.0 - self.target_pct / 100.0, 1e-9)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=65536)  # (mono_t, compliant)
        self.total = 0
        self.bad = 0

    def observe(self, latency_ms: float, ok: bool) -> bool:
        compliant = bool(ok) and float(latency_ms) <= self.p99_ms
        with self._lock:
            self._events.append((time.monotonic(), compliant))
            self.total += 1
            if not compliant:
                self.bad += 1
        return compliant

    def _window_counts(self, now: float, window_s: float) -> tuple:
        total = bad = 0
        for t, good in reversed(self._events):
            if t < now - window_s:
                break
            total += 1
            if not good:
                bad += 1
        return total, bad

    def _burn(self, total: int, bad: int) -> float:
        if not total:
            return 0.0
        return (bad / total) / self._allowed

    def report(self) -> dict:
        now = time.monotonic()
        with self._lock:
            total, bad = self.total, self.bad
            ft, fb = self._window_counts(now, self.FAST_WINDOW_S)
            st, sb = self._window_counts(now, self.SLOW_WINDOW_S)
        compliant_pct = (100.0 * (1.0 - bad / total) if total else 100.0)
        spent = self._burn(total, bad)  # lifetime burn = budget spent
        fast = self._burn(ft, fb)
        return {
            "slo_p99_ms": self.p99_ms,
            "slo_target_pct": self.target_pct,
            "requests": total,
            "compliant_pct": round(compliant_pct, 4),
            "budget_remaining_pct": round(
                max(0.0, 1.0 - spent) * 100.0, 4),
            "burn_rate_fast": round(fast, 4),
            "burn_rate_slow": round(self._burn(st, sb), 4),
            "fast_window_s": self.FAST_WINDOW_S,
            "slow_window_s": self.SLOW_WINDOW_S,
            "fast_burn_threshold": self.FAST_BURN_THRESHOLD,
            "fast_burn_breach": bool(
                ft >= self.MIN_WINDOW_COUNT
                and fast >= self.FAST_BURN_THRESHOLD),
        }

    def fast_burn_breach(self) -> bool:
        now = time.monotonic()
        with self._lock:
            ft, fb = self._window_counts(now, self.FAST_WINDOW_S)
        return (ft >= self.MIN_WINDOW_COUNT
                and self._burn(ft, fb) >= self.FAST_BURN_THRESHOLD)


class RequestPlane:
    """The per-process request-plane state: the bounded audit ring of
    finished request summaries, per-(route, bucket) phase histograms
    for tail attribution, the optional SLO ledger, and the ``req:*``
    span emission into the telemetry spine."""

    SLO_SEEN_CAP = 65536

    def __init__(self, ring: int = RING_DEFAULT,
                 exemplars: int = EXEMPLARS_DEFAULT,
                 slo_p99_ms: float = 0.0,
                 slo_target_pct: float = 99.0,
                 dedupe_window_s: float = 120.0):
        self.audit: deque = deque(maxlen=max(int(ring), 1))
        self.exemplars = max(int(exemplars), 1)
        self.slo = (SLOLedger(slo_p99_ms, slo_target_pct)
                    if slo_p99_ms and slo_p99_ms > 0 else None)
        self._lock = threading.Lock()
        self._hists: dict = {}  # (route, bucket) -> {phase|"total": hist}
        self.requests_total = 0
        self.by_disposition = dict.fromkeys(DISPOSITIONS, 0)
        # a client or router retry reuses its request_id: booking each
        # attempt's outcome would burn the error budget twice. Terminal
        # dispositions dedupe by id within a window: the FIRST
        # finish for an id books; later finishes for the same id within
        # ``dedupe_window_s`` count only in ``slo_deduped``. Insertion-
        # ordered dict, evicted from the front by age and a hard cap.
        self.dedupe_window_s = float(dedupe_window_s)
        self._slo_seen: dict = {}  # request_id -> mono_t of first book
        self.slo_deduped = 0

    # ------------------------------------------------------- lifecycle

    def begin(self, request_id: str, route: str, payload) -> RequestTrace:
        return RequestTrace(self, request_id, route,
                            shape_bucket(payload))

    def finish(self, tr: RequestTrace, disposition: str,
               reason: str | None = None) -> dict:
        """Terminate a request's timeline: compute its phases, record
        the audit/tail/SLO accounting, emit its ``req:*`` spans.
        Idempotent — the first disposition wins (a request cannot both
        expire and complete)."""
        if disposition not in DISPOSITIONS:
            raise ValueError(f"unknown disposition {disposition!r}")
        if tr.summary is not None:
            return tr.summary
        now = time.monotonic()
        phases = tr._phases(now)
        total_s = now - tr.t0
        summary = {
            "request_id": tr.request_id,
            "route": tr.route,
            "bucket": tr.bucket,
            "disposition": disposition,
            "reason": reason,
            "total_ms": round(total_s * 1e3, 4),
            "phases_ms": {k: round(v * 1e3, 4)
                          for k, v in phases.items()},
            "decode_ticks": tr.decode_ticks,
            "t_wall": tr.wall0,
        }
        if tr.slot is not None:
            summary["slot"] = tr.slot
            summary["iter_admit"] = tr.iter_admit
            summary["iter_retire"] = tr.iter_retire
        if tr.served_step is not None:
            summary["served_step"] = tr.served_step
        tr.summary = summary
        ok = disposition == "ok"
        with self._lock:
            self.requests_total += 1
            self.by_disposition[disposition] += 1
            self.audit.append(summary)
            hists = self._hists.setdefault((tr.route, tr.bucket), {})
            for name, dur in phases.items():
                h = hists.get(name)
                if h is None:
                    h = hists[name] = StreamingHistogram()
                h.record(dur * 1e3)
            th = hists.get("total")
            if th is None:
                th = hists["total"] = StreamingHistogram()
            th.record(total_s * 1e3)
            first_outcome = self._slo_first_outcome(tr.request_id, now)
        if self.slo is not None and first_outcome:
            self.slo.observe(total_s * 1e3, ok)
        self._emit(tr, summary, phases)
        return summary

    def _slo_first_outcome(self, request_id: str, now: float) -> bool:
        """Under ``self._lock``: True iff this id has NOT booked an SLO
        outcome within the dedupe window (and record that it now has).
        Front-evicts expired/overflow ids — the dict is insertion-
        ordered, so the oldest entries are always first."""
        seen = self._slo_seen
        cutoff = now - self.dedupe_window_s
        while seen:
            rid, t = next(iter(seen.items()))
            if t >= cutoff and len(seen) < self.SLO_SEEN_CAP:
                break
            del seen[rid]
        prior = seen.get(request_id)
        if prior is not None and prior >= cutoff:
            self.slo_deduped += 1
            return False
        seen.pop(request_id, None)  # re-insert at the back if expired
        seen[request_id] = now
        return True

    def _emit(self, tr: RequestTrace, summary: dict,
              phases: dict) -> None:
        """One backdated completed span per phase plus a ``req:done``
        instant carrying the summary — into the telemetry spine's ring
        and JSONL sink (``spans-serve-N.jsonl`` on a replica), so the
        span file alone tells each request's story."""
        tracer = telemetry.get_tracer()
        if not tracer.enabled:
            return
        # phase start offsets on the request's own monotonic clock
        starts = {"admit": 0.0}
        cursor = phases.get("admit", 0.0)
        for phase in ("queue_wait", "batch_assembly", "prefill",
                      "decode", "respond"):
            if phase in phases:
                starts[phase] = cursor
                cursor += phases[phase]
        for phase in PHASES:
            if phase not in phases:
                continue
            attrs = {"request_id": tr.request_id, "route": tr.route,
                     "bucket": tr.bucket,
                     "disposition": summary["disposition"]}
            if phase == "decode" and tr.decode_ticks:
                attrs["ticks"] = tr.decode_ticks
            telemetry.record_span(f"req:{phase}",
                                  ts=tr.wall0 + starts[phase],
                                  dur_s=phases[phase], **attrs)
        # continuous batching: the slot story rides the summary so
        # the offline report can tell which slot served the request and
        # how many scheduler iterations it was resident
        slot_attrs = ({"slot": tr.slot, "iter_admit": tr.iter_admit,
                       "iter_retire": tr.iter_retire}
                      if tr.slot is not None else {})
        tracer.record_instant(
            "req:done", request_id=tr.request_id, route=tr.route,
            bucket=tr.bucket, disposition=summary["disposition"],
            reason=summary["reason"], total_ms=summary["total_ms"],
            decode_ticks=tr.decode_ticks, **slot_attrs,
            **{f"{k}_ms": v for k, v in summary["phases_ms"].items()})

    # --------------------------------------------------------- reports

    def tail_report(self) -> dict:
        """The ``/metrics`` tail block: per route and shape-bucket, the
        p50-vs-p99 decomposition by phase (which phase GREW between the
        median and the tail), plus the worst live exemplars by total
        latency — request_id + phase breakdown, so the slow requests
        are named, not just counted."""
        with self._lock:
            # snapshot the inner dicts too: finish() inserts new phase
            # keys under the lock, and an unlocked items() walk would
            # race it ("dict changed size during iteration" mid-scrape)
            snapshot = {key: dict(hists)
                        for key, hists in self._hists.items()}
            ring = list(self.audit)
            requests_total = self.requests_total
            by_disposition = dict(self.by_disposition)
        routes: dict = {}
        for (route, bucket), hists in sorted(snapshot.items()):
            entry: dict = {"phases": {}}
            p99s = {}
            for name, h in hists.items():
                s = {"p50_ms": round(h.quantile(0.5), 3),
                     "p99_ms": round(h.quantile(0.99), 3),
                     "count": h.count}
                if name == "total":
                    entry["total"] = s
                else:
                    entry["phases"][name] = s
                    p99s[name] = s["p99_ms"]
            entry["p99_dominant_phase"] = (
                max(p99s, key=p99s.get) if p99s else None)
            routes.setdefault(route, {})[str(bucket)] = entry
        worst = sorted(ring, key=lambda s: s["total_ms"],
                       reverse=True)[:self.exemplars]
        exemplars = []
        for s in worst:
            pm = s["phases_ms"]
            exemplars.append({
                "request_id": s["request_id"], "route": s["route"],
                "bucket": s["bucket"], "disposition": s["disposition"],
                "total_ms": s["total_ms"],
                "dominant_phase": (max(pm, key=pm.get) if pm else None),
                "phases_ms": pm,
            })
        return {"routes": routes, "exemplars": exemplars,
                "requests_total": requests_total,
                "by_disposition": by_disposition}

    def audit_snapshot(self) -> list[dict]:
        """One consistent copy of the audit ring — what offline readers
        iterate while
        batcher/expiry threads keep finishing requests; iterating the
        live deque would race their appends."""
        with self._lock:
            return list(self.audit)

    def slo_report(self) -> dict | None:
        return self.slo.report() if self.slo is not None else None

    def fast_burn_breach(self) -> bool:
        return self.slo is not None and self.slo.fast_burn_breach()


# ------------------------------------------------ batch execution context

_CTX = threading.local()


class batch_context:
    """Bracket one microbatch execution with the traces of the requests
    in it: marks run start/end on every trace, and makes them the
    target of ``note_phase`` calls from the engine/decoder below (which
    cannot see request ids — they see tensors)."""

    def __init__(self, traces):
        self._traces = [t for t in traces if t is not None]

    def __enter__(self):
        _CTX.traces = self._traces
        for t in self._traces:
            t.run_start()
        return self

    def __exit__(self, *exc):
        _CTX.traces = []
        for t in self._traces:
            t.run_end()
        return False


def note_phase(phase: str, dur_s: float, ticks: int | None = None) -> None:
    """Attribute ``dur_s`` of the current microbatch's execution to
    ``phase`` on every request in the batch (each request WAITED that
    long, whatever its share of the math was). No-op outside a
    ``batch_context`` (direct engine calls, tests)."""
    for t in getattr(_CTX, "traces", ()):
        t.note(phase, dur_s, ticks)


def note_served_step(step) -> None:
    """Stamp the checkpoint step of the params
    snapshot serving the current microbatch on every request in it.
    The engine reads ``(params, step)`` ONCE per microbatch under its
    swap lock, so every request in a batch shares one step; the stamp
    rides into the summary and the wire meta. No-op outside a
    ``batch_context``."""
    if step is None:
        return
    for t in getattr(_CTX, "traces", ()):
        t.served_step = int(step)


def note_slot_admit(tr, iteration: int, slot: int) -> None:
    """Continuous batching: mark the iteration-level admission of
    a request into batch slot ``slot``. Emits a LIVE ``req:slot_admit``
    instant (unlike the backdated phase spans, slot events are visible
    while the request is still decoding) and stamps the trace so the
    finish summary carries the slot story. ``tr`` is the request's
    ``RequestTrace`` or None; the stamp is lock-free by the same
    lifecycle sequencing as ``taken``/``run_start`` (submit hands the
    request to exactly one scheduler thread through the batcher cv)."""
    if tr is not None:
        tr.slot = int(slot)
        tr.iter_admit = int(iteration)
    tracer = telemetry.get_tracer()
    if tr is not None and tracer.enabled:
        tracer.record_instant("req:slot_admit", request_id=tr.request_id,
                              route=tr.route, iteration=int(iteration),
                              slot=int(slot))


def note_slot_retire(tr, iteration: int) -> None:
    """Continuous batching: mark the iteration-level retirement of
    a request from its batch slot (generation complete or the request
    failed mid-flight). Live instant + trace stamp, mirror of
    ``note_slot_admit`` (same lifecycle-sequenced ``tr``)."""
    if tr is not None:
        tr.iter_retire = int(iteration)
    tracer = telemetry.get_tracer()
    if tr is not None and tracer.enabled:
        tracer.record_instant("req:slot_retire", request_id=tr.request_id,
                              route=tr.route, iteration=int(iteration),
                              slot=tr.slot)


def finish(tr: RequestTrace | None, disposition: str,
           reason: str | None = None) -> dict | None:
    """Finish a trace through the plane that began it (None-safe: the
    batcher calls this unconditionally; with the plane unconfigured
    there is no trace)."""
    if tr is None:
        return None
    return tr.plane.finish(tr, disposition, reason)


# --------------------------------------------------------- configuration

_PLANE: RequestPlane | None = None


def get_plane() -> RequestPlane | None:
    return _PLANE


def configure(enabled: bool = True, ring: int = RING_DEFAULT,
              exemplars: int = EXEMPLARS_DEFAULT,
              slo_p99_ms: float = 0.0,
              slo_target_pct: float = 99.0) -> RequestPlane | None:
    """Install (or with ``enabled=False`` remove) the process request
    plane. Returns the new plane (or None). Ids mint and echo
    regardless — the plane gates the accounting, not the wire
    contract."""
    global _PLANE
    _PLANE = (RequestPlane(ring=ring, exemplars=exemplars,
                           slo_p99_ms=slo_p99_ms,
                           slo_target_pct=slo_target_pct)
              if enabled else None)
    return _PLANE


def configure_from_flags(FLAGS) -> RequestPlane | None:
    """The one flag->feature mapping for ``--reqtrace_*`` / ``--slo_*``,
    called by the serving entry point next to
    ``telemetry.configure_from_flags``. The plane rides the telemetry
    spine: ``--telemetry=false`` leaves it unconfigured."""
    return configure(
        enabled=bool(getattr(FLAGS, "telemetry", True)),
        ring=int(getattr(FLAGS, "reqtrace_ring", RING_DEFAULT)
                 or RING_DEFAULT),
        exemplars=int(getattr(FLAGS, "reqtrace_exemplars",
                              EXEMPLARS_DEFAULT) or EXEMPLARS_DEFAULT),
        slo_p99_ms=float(getattr(FLAGS, "slo_p99_ms", 0.0) or 0.0),
        slo_target_pct=float(getattr(FLAGS, "slo_target_pct", 99.0)
                             or 99.0),
    )
