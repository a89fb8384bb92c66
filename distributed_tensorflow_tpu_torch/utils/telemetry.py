"""Telemetry spine: span tracing, the step-time breakdown, the hang
watchdog and the crash flight recorder.

The counterpart of ``distributed_tensorflow_tpu/utils/telemetry.py``,
stdlib only, so every layer (``utils/faults.py`` included) can import it.
Four pieces share one ring of recent events:

- **Span tracing.** ``trace_span("serve_batch", count=...)`` is a
  thread-safe context manager; completed spans land in a fixed ring and,
  when a logdir is configured, batch-flush to
  ``<logdir>/spans-<host>.jsonl``. ``record_span`` emits a span the caller
  timed itself (the request plane's phases), ``record_instant`` a
  zero-length marker. ``chrome_trace`` turns any record set into
  Chrome-trace/Perfetto JSON.
- **Step-time breakdown.** ``StepTimer`` accumulates per-step kinds of
  host time (the training loops' host_wait, dispatch and device).
- **Hang watchdog.** ``--watchdog_s N`` arms a daemon thread around every
  serving batch or scheduler iteration (``armed(...)``); on expiry it
  dumps all-thread stacks, the last spans and the stalled operation's
  context, then optionally aborts (``--watchdog_abort``).
- **Crash flight recorder.** A ring of recent spans and notes,
  flushed to ``<logdir>/flightrec-<host>.jsonl`` from ``sys.excepthook``,
  ``atexit`` and any injected ``crash``/``error`` fault.

The serving entry point configures it with job name ``serve``
(``spans-serve-N.jsonl``, ``flightrec-serve-N.jsonl``). The training
loops use ``StepTimer`` only; their spans and watchdog are not ported
yet.
"""

from __future__ import annotations

import atexit
import faulthandler
import json
import os
import sys
import threading
import time
from collections import deque

SPAN_RING = 2048        # completed spans retained for dumps
FLIGHT_EVENTS = 512     # flight-recorder ring length (--flightrec_events)
WATCHDOG_LAST_SPANS = 32


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    return str(v)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """One active span: two perf_counter reads, one wall-clock read, a
    thread-local stack push/pop, one deque append."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_wall", "_depth")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self._name)
        self._wall = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self._tracer._stack().pop()
        rec = dict(self._attrs) if self._attrs else {}
        rec["name"] = self._name
        rec["ts"] = self._wall
        rec["dur_s"] = dur
        rec["tid"] = threading.get_ident()
        rec["thread"] = threading.current_thread().name
        rec["depth"] = self._depth
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        self._tracer._finish(rec)
        return False


class Tracer:
    """Thread-safe span collector: a fixed ring plus an optional batched
    JSONL sink. ``enabled=False`` makes ``span`` return a shared no-op
    context manager (``--telemetry=false``: no record cost)."""

    def __init__(self, ring: int = SPAN_RING):
        self.enabled = True
        self._ring: deque = deque(maxlen=ring)
        self._pending: list = []
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._local = threading.local()
        self._path: str | None = None
        self._file = None
        self._file_path: str | None = None  # path _file was opened for

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, attrs=None):
        if not self.enabled:
            return _NOOP
        return _Span(self, name, attrs)

    def _finish(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            if self._path is not None:
                self._pending.append(rec)
        _FLIGHT.record("span", rec)

    def record_instant(self, name: str, **attrs) -> None:
        """A zero-duration marker span (fault injections, slot events)."""
        if not self.enabled:
            return
        rec = {k: _json_safe(v) for k, v in attrs.items()}
        rec.update(name=name, ts=time.time(), dur_s=0.0,
                   tid=threading.get_ident(),
                   thread=threading.current_thread().name,
                   depth=len(self._stack()), instant=True)
        self._finish(rec)

    def record_complete(self, name: str, ts: float, dur_s: float,
                        attrs=None) -> None:
        """A completed span timed by the caller, emitted after the fact
        (the request plane measures a request's phases as it moves and
        emits them together when it finishes)."""
        if not self.enabled:
            return
        rec = {k: _json_safe(v) for k, v in (attrs or {}).items()}
        rec.update(name=name, ts=float(ts), dur_s=float(dur_s),
                   tid=threading.get_ident(),
                   thread=threading.current_thread().name,
                   depth=len(self._stack()))
        self._finish(rec)

    def configure_sink(self, path: str | None) -> None:
        """Set (or clear) the spans JSONL file; writes happen in batches
        at ``flush``."""
        with self._lock:
            self._path = path
        with self._io_lock:
            if self._file is not None and path != self._file_path:
                self._file.close()
                self._file = None
                self._file_path = None

    def flush(self) -> None:
        """Write pending spans to the JSONL sink (the hot path never
        touches the file)."""
        with self._lock:
            if self._path is None or not self._pending:
                return
            pending, self._pending = self._pending, []
            path = self._path
        with self._io_lock:
            try:
                # the handle must match the path this flush took: a
                # configure_sink racing in between would otherwise send
                # every later flush to the previous run's file
                if self._file is not None and self._file_path != path:
                    self._file.close()
                    self._file = None
                if self._file is None:
                    os.makedirs(os.path.dirname(path) or ".",
                                exist_ok=True)
                    self._file = open(path, "a")
                    self._file_path = path
                for rec in pending:
                    self._file.write(json.dumps(
                        {k: _json_safe(v) for k, v in rec.items()}) + "\n")
                self._file.flush()
            except OSError as e:  # telemetry must never kill the run
                print(f"telemetry: span sink write failed: {e}")

    def last(self, k: int = WATCHDOG_LAST_SPANS) -> list:
        with self._lock:
            ring = list(self._ring)
        return ring[-k:]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()


_TRACER = Tracer()


def trace_span(name: str, **attrs):
    """The span entry point: ``with trace_span("serve_reload", step=s):``.
    A shared no-op when telemetry is disabled."""
    return _TRACER.span(name, attrs or None)


def get_tracer() -> Tracer:
    return _TRACER


def record_span(name: str, *, ts: float, dur_s: float, **attrs) -> None:
    """Emit a completed span the caller timed (``Tracer.record_complete``)
    to the global tracer: the request plane's emission entry point."""
    _TRACER.record_complete(name, ts, dur_s, attrs or None)


def last_spans(k: int = WATCHDOG_LAST_SPANS) -> list:
    return _TRACER.last(k)


def chrome_trace(records=None) -> dict:
    """Span records -> a Chrome-trace/Perfetto ``traceEvents`` dict.
    Complete spans become ``ph: "X"`` duration events, instant markers
    ``ph: "i"``."""
    if records is None:
        records = _TRACER.last(10 ** 9)
    pid = os.getpid()
    core = ("name", "ts", "dur_s", "tid", "thread", "depth", "instant")
    events = []
    for r in records:
        args = {k: _json_safe(v) for k, v in r.items() if k not in core}
        ev = {"name": r.get("name", "?"), "pid": r.get("pid", pid),
              "tid": r.get("tid", 0), "ts": float(r.get("ts", 0.0)) * 1e6,
              "cat": "telemetry", "args": args}
        if r.get("instant"):
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = float(r.get("dur_s", 0.0)) * 1e6
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------------ step breakdown


class StepTimer:
    """Per-window step-time breakdown accumulator.

    The loop wraps its kinds of per-step work and calls ``add``:
    ``host_wait`` (drawing the prefetched batch), ``dispatch`` (the step
    call returning: on a card this is the host's work of enqueueing the
    step, since the kernels run asynchronously), ``device`` (time blocked
    waiting for the device). ``scalars()`` returns the per-step means
    since the last call and resets the window. Another loop names its own
    kinds in ``keys`` (the ps worker's pull, upload, grad, download and
    push).
    """

    KEYS = ("host_wait", "dispatch", "device")

    def __init__(self, keys: tuple[str, ...] = KEYS):
        self.keys = keys
        self.reset()

    def reset(self) -> None:
        self._acc = dict.fromkeys(self.keys, 0.0)
        self._steps = 0

    def add(self, key: str, dt: float) -> None:
        self._acc[key] += dt

    def steps(self, n: int = 1) -> None:
        self._steps += n

    def scalars(self) -> dict:
        n = max(self._steps, 1)
        out = {f"step_{k}_s": round(self._acc[k] / n, 9)
               for k in self.keys}
        self.reset()
        return out


# ------------------------------------------------------------ watchdog


class Watchdog:
    """Hang watchdog: ``arm(what, **ctx)`` brackets an operation that
    must finish within ``timeout_s``; a daemon thread fires when one does
    not, dumping the operation's context, the last spans and every
    thread's stack to ``out``, flushing the flight recorder, then
    optionally hard-exiting (``abort``).

    Fires at most once per armed operation, and a disarm after the fire
    is a no-op. Several threads may hold armed operations at once.
    ``fired`` counts reports."""

    EXIT_CODE = 124  # the timeout(1) convention

    def __init__(self, timeout_s: float, abort: bool = False, out=None):
        if timeout_s <= 0:
            raise ValueError(f"watchdog timeout must be > 0, got "
                             f"{timeout_s}")
        self.timeout_s = float(timeout_s)
        self.abort = bool(abort)
        self._out = out
        self._cv = threading.Condition()
        self._armed: dict[int, tuple] = {}  # gen -> (what, ctx, t0, deadline)
        self._gen = 0
        self._closed = False
        self._thread: threading.Thread | None = None
        self.fired = 0

    class _Armed:
        __slots__ = ("_wd", "_gen")

        def __init__(self, wd, gen):
            self._wd = wd
            self._gen = gen

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            wd = self._wd
            with wd._cv:
                wd._armed.pop(self._gen, None)
                wd._cv.notify_all()
            return False

    def arm(self, what: str, **ctx):
        with self._cv:
            if self._closed:
                return _NOOP
            self._gen += 1
            now = time.monotonic()
            self._armed[self._gen] = (what, ctx, now,
                                      now + self.timeout_s)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="telemetry-watchdog",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
            return Watchdog._Armed(self, self._gen)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._armed.clear()
            self._cv.notify_all()

    def _loop(self) -> None:
        cv = self._cv
        cv.acquire()
        try:
            while not self._closed:
                if not self._armed:
                    cv.wait(0.5)
                    continue
                now = time.monotonic()
                expired = [(g, e) for g, e in self._armed.items()
                           if e[3] <= now]
                if not expired:
                    soonest = min(e[3] for e in self._armed.values())
                    cv.wait(min(max(soonest - now, 0.0), 1.0))
                    continue
                for gen, _entry in expired:
                    self._armed.pop(gen, None)  # fire once per armed op
                self.fired += len(expired)
                # dump outside the cv: the stack dump and fsync take
                # time, and healthy threads arming and disarming must not
                # wait behind another operation's report
                cv.release()
                try:
                    for _gen, (what, ctx, armed_at, _dl) in expired:
                        try:
                            self._dump(what, ctx, now - armed_at)
                        except Exception as e:  # must not kill the dog
                            print(f"watchdog dump failed: {e}",
                                  flush=True)
                    if self.abort:
                        os._exit(self.EXIT_CODE)
                finally:
                    cv.acquire()
        finally:
            cv.release()

    def _dump(self, what: str, ctx: dict, waited: float) -> None:
        out = self._out or sys.stderr
        line = "=" * 70
        print(f"\n{line}\nWATCHDOG: {what!r} has not completed after "
              f"{waited:.1f}s (timeout {self.timeout_s}s)\n"
              f"  in-flight op context: "
              f"{ {k: _json_safe(v) for k, v in ctx.items()} }",
              file=out, flush=True)
        spans = last_spans(WATCHDOG_LAST_SPANS)
        print(f"last {len(spans)} spans (oldest first):", file=out)
        for r in spans:
            extras = {k: v for k, v in r.items()
                      if k not in ("name", "ts", "dur_s", "tid", "thread",
                                   "depth")}
            print(f"  {r.get('ts', 0):.6f} {r.get('dur_s', 0) * 1e3:9.3f}ms "
                  f"[{r.get('thread', '?')}] "
                  f"{'  ' * r.get('depth', 0)}{r.get('name', '?')} "
                  f"{extras if extras else ''}", file=out)
        print("all-thread stacks:", file=out, flush=True)
        try:
            faulthandler.dump_traceback(file=out, all_threads=True)
        except (ValueError, OSError, AttributeError):
            # a stream without a file descriptor (StringIO): keep the
            # span report, skip the stacks
            print("  (stream has no file descriptor; stacks skipped)",
                  file=out)
        _FLIGHT.record("note", {"note": f"watchdog fired: {what}",
                                "waited_s": round(waited, 3),
                                **{k: _json_safe(v) for k, v in ctx.items()}})
        _FLIGHT.dump(f"watchdog:{what}")
        print(f"{line}\nend watchdog report "
              f"({'aborting' if self.abort else 'continuing'})\n{line}",
              file=out, flush=True)


_WATCHDOG: Watchdog | None = None


def get_watchdog() -> Watchdog | None:
    return _WATCHDOG


def set_watchdog(wd: Watchdog | None) -> Watchdog | None:
    """Install (or with None remove) the process watchdog ``armed()``
    uses; closes any previous one."""
    global _WATCHDOG
    if _WATCHDOG is not None and _WATCHDOG is not wd:
        _WATCHDOG.close()
    _WATCHDOG = wd
    return wd


def armed(what: str, **ctx):
    """Bracket a device dispatch with the process watchdog (a no-op when
    none is armed, the default)."""
    wd = _WATCHDOG
    if wd is None:
        return _NOOP
    return wd.arm(what, **ctx)


# ---------------------------------------------------- flight recorder


class FlightRecorder:
    """Fixed-size ring of recent spans and notes, dumped to
    ``<logdir>/flightrec-<host>.jsonl`` on crash paths.

    The ring records always; the dump happens only when a path is
    configured. Dumps overwrite (the newest postmortem wins) and start
    with a ``meta`` line naming the reason. Installed once per process on
    ``sys.excepthook`` (chained) and ``atexit``; ``utils/faults.py`` dumps
    directly before an injected ``crash``'s ``os._exit``."""

    def __init__(self, maxlen: int = FLIGHT_EVENTS):
        self._ring: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        # a watchdog fire can race the excepthook: two writers of the
        # same file must not interleave
        self._dump_lock = threading.Lock()
        self._path: str | None = None
        self._installed = False
        self.last_dump: str | None = None

    def record(self, kind: str, fields: dict) -> None:
        rec = {"kind": kind, "t": time.time()}
        rec.update(fields)
        with self._lock:
            self._ring.append(rec)

    def configure(self, path: str | None, maxlen: int | None = None) -> None:
        with self._lock:
            self._path = path
            # a re-pointed recorder is a new run: its atexit dump must not
            # be suppressed by a previous run's postmortem
            self.last_dump = None
            if maxlen is not None and maxlen != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, maxlen))
        if path is not None:
            self._install()

    @property
    def path(self) -> str | None:
        with self._lock:
            return self._path

    def _install(self) -> None:
        with self._lock:
            if self._installed:
                return
            self._installed = True
        prev_hook = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.record("note",
                            {"note": f"uncaught {exc_type.__name__}: {exc}"})
                self.dump(f"excepthook:{exc_type.__name__}")
            except Exception:
                pass
            prev_hook(exc_type, exc, tb)

        sys.excepthook = _hook
        atexit.register(self._atexit_dump)

    @staticmethod
    def _holds_postmortem(path: str) -> bool:
        """True when ``path`` already holds a dump whose reason is not a
        routine shutdown."""
        try:
            with open(path) as f:
                meta = json.loads(f.readline())
            return (meta.get("kind") == "meta"
                    and meta.get("reason", "") != "atexit")
        except (OSError, ValueError):
            return False

    def _atexit_dump(self) -> None:
        try:
            # a clean shutdown must not overwrite this run's crash or
            # watchdog report with the reason "atexit"
            with self._lock:
                dumped = self.last_dump
            if dumped is None:
                self.dump("atexit")
        except Exception:
            pass

    def dump(self, reason: str) -> str | None:
        """Write the ring (and flush pending spans) now; returns the path,
        or None when no sink is configured."""
        _TRACER.flush()
        with self._lock:
            path = self._path
            ring = list(self._ring)
        if path is None:
            return None
        if reason == "atexit" and self._holds_postmortem(path):
            # a clean shutdown never buries an earlier run's postmortem
            return None
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with self._dump_lock, open(path, "w") as f:
                f.write(json.dumps({
                    "kind": "meta", "reason": reason, "t": time.time(),
                    "pid": os.getpid(), "events": len(ring)}) + "\n")
                for rec in ring:
                    f.write(json.dumps(
                        {k: _json_safe(v) for k, v in rec.items()}) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            print(f"telemetry: flight-recorder dump failed: {e}")
            return None
        with self._lock:
            self.last_dump = reason
        return path


_FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _FLIGHT


def record_fault(point: str, mode: str, ctx: dict) -> None:
    """``utils/faults.py`` calls this at every fired injection, before the
    mode's effect: the fault lands as an instant span, and the crash,
    error and refuse modes dump the flight recorder at once
    (``mode=crash`` is ``os._exit``, so this is its only record)."""
    _TRACER.record_instant(f"fault:{point}", mode=mode,
                           **{k: _json_safe(v) for k, v in ctx.items()})
    if mode in ("crash", "error", "refuse"):
        _FLIGHT.dump(f"fault:{point}:{mode}")


# -------------------------------------------------------- configuration


def host_tag(job_name: str = "", task_index: int = 0) -> str:
    return f"{job_name or 'worker'}-{int(task_index)}"


def configure(logdir: str | None = None, host: str | None = None,
              enabled: bool = True, watchdog_s: float = 0.0,
              watchdog_abort: bool = False,
              flight_events: int | None = None) -> Tracer:
    """Point the spine at a run: the span sink and the flight-recorder
    path under ``logdir`` (per-``host`` file names), and the optional
    watchdog. Calling again re-points the sinks."""
    _TRACER.enabled = bool(enabled)
    host = host or host_tag()
    if enabled and logdir:
        os.makedirs(logdir, exist_ok=True)
        _TRACER.configure_sink(os.path.join(logdir,
                                            f"spans-{host}.jsonl"))
        _FLIGHT.configure(os.path.join(logdir,
                                       f"flightrec-{host}.jsonl"),
                          maxlen=flight_events)
    else:
        _TRACER.configure_sink(None)
        _FLIGHT.configure(None, maxlen=flight_events)
    if enabled and watchdog_s and watchdog_s > 0:
        set_watchdog(Watchdog(watchdog_s, abort=watchdog_abort))
    else:
        set_watchdog(None)
    return _TRACER


def configure_from_flags(FLAGS, job_name: str | None = None) -> Tracer:
    """The flag-to-feature mapping of ``--telemetry``, ``--watchdog_s``,
    ``--watchdog_abort`` and ``--flightrec_events``. ``job_name`` names
    the role in the file names: the serving entry point passes "serve",
    so a server pointed at the trainer's logdir writes
    ``spans-serve-N.jsonl`` beside the trainer's files."""
    return configure(
        logdir=getattr(FLAGS, "logdir", None),
        host=host_tag(job_name or getattr(FLAGS, "job_name", "")
                      or "worker",
                      getattr(FLAGS, "task_index", 0) or 0),
        enabled=bool(getattr(FLAGS, "telemetry", True)),
        watchdog_s=float(getattr(FLAGS, "watchdog_s", 0.0) or 0.0),
        watchdog_abort=bool(getattr(FLAGS, "watchdog_abort", False)),
        flight_events=int(getattr(FLAGS, "flightrec_events", FLIGHT_EVENTS)
                          or FLIGHT_EVENTS),
    )
