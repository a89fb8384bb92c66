"""Dynamic microbatch assembly with bounded admission — the serving
front door.

The counterpart of ``distributed_tensorflow_tpu/serving/batcher.py``. A
bounded request queue feeds one worker that closes a microbatch when
``max_batch`` requests of one group are waiting or the oldest has waited
``max_delay_ms``; the engine pads each batch to a power of two.

Admission never hangs the client:

- a full queue rejects immediately (``RejectedError`` with the reason),
- a request whose deadline expires before its batch runs completes with a
  deadline ``RejectedError``,
- a dead worker (a batch raising ``BaseException``) fails every pending
  future and closes the batcher; a batch raising ``Exception`` fails only
  its own futures.

Fault points (``utils/faults.py``): ``serve_admit`` fires inside submit
after the admission checks, ``serve_batch`` after a microbatch is
assembled. The batch runs inside a ``serve_batch`` span and under the
process watchdog (``--watchdog_s``).

Request plane (``serving/reqtrace.py``): every submission mints (or
echoes) a ``request_id`` and, with the plane configured, owns a phase
timeline that ends in exactly one disposition: ``ok``, ``rejected_full``,
``rejected_closed``, ``rejected_fault`` (an injected admission fault),
``expired`` or ``failed``. ``RejectedError.request_id`` carries the id to
the wire.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from distributed_tensorflow_tpu_torch.serving import reqtrace
from distributed_tensorflow_tpu_torch.utils import telemetry
from distributed_tensorflow_tpu_torch.utils.faults import fault_point
from distributed_tensorflow_tpu_torch.utils.telemetry import trace_span


class RejectedError(RuntimeError):
    """A request the serving stack declined to run, with the reason (queue
    full, deadline exceeded, batcher closed). ``request_id`` names it."""

    def __init__(self, reason: str, request_id: str | None = None):
        super().__init__(reason)
        self.reason = reason
        self.request_id = request_id


class Future:
    """Single-assignment result slot for one request. ``request_id`` is
    set at submit; ``meta`` (the request plane's summary: disposition,
    phases) is set before the result when the plane is configured."""

    __slots__ = ("_event", "_value", "_error", "request_id", "meta")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None
        self.request_id: str | None = None
        self.meta: dict | None = None

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class _Request:
    payload: Any
    opts: dict
    group: Any
    future: Future
    t_submit: float
    deadline: float
    request_id: str = ""
    trace: Any = None  # reqtrace.RequestTrace | None


def pow2_bucket(n: int, cap: int) -> int:
    """The smallest power of two >= n, clamped to ``cap`` — the batch
    padding policy (the rounding is the request plane's
    ``reqtrace.pow2_ceil``, so its shape buckets round the same way)."""
    if n < 1:
        raise ValueError(f"bucket of {n} requests")
    return min(reqtrace.pow2_ceil(n), cap)


@dataclass
class BatcherStats:
    admitted: int = 0
    completed: int = 0
    rejected_full: int = 0
    rejected_closed: int = 0
    rejected_deadline: int = 0
    rejected_fault: int = 0
    failed: int = 0
    batches: int = 0
    batched_requests: int = 0
    queue_depth: int = 0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def as_dict(self) -> dict:
        with self.lock:
            d = {k: getattr(self, k) for k in (
                "admitted", "completed", "rejected_full", "rejected_closed",
                "rejected_deadline", "rejected_fault", "failed", "batches",
                "batched_requests", "queue_depth")}
        d["mean_batch_size"] = (d["batched_requests"] / d["batches"]
                                if d["batches"] else 0.0)
        return d


class _QueueBatcher:
    """The bounded admission queue both batchers share (this module's
    ``DynamicBatcher`` and ``continuous.ContinuousBatcher``): ``submit``'s
    checks and dispositions, deadline expiry on its own thread, close and
    die. A subclass supplies its worker loop (``_run``) and may validate
    or group a request at submit (``_accept``)."""

    _worker_kind = "batcher worker"  # names the worker in death reasons

    def __init__(self, *, queue_depth: int, default_timeout_ms: float,
                 latency, name: str):
        self.queue_depth = int(queue_depth)
        self.default_timeout_s = float(default_timeout_ms) / 1000.0
        self.latency = latency
        self._route = name  # the request plane's route key
        self.stats = BatcherStats()
        self._queue: list[_Request] = []
        self._cv = threading.Condition()
        self._closed = False

    def _start(self, worker_name: str) -> None:
        self._worker = threading.Thread(target=self._run, name=worker_name,
                                        daemon=True)
        self._worker.start()
        # deadlines fire even while the worker is inside a long batch
        self._expirer = threading.Thread(
            target=self._expiry_loop, name=f"{self._route}-expiry",
            daemon=True)
        self._expirer.start()

    def _run(self) -> None:
        raise NotImplementedError

    def _accept(self, payload, opts: dict, trace):
        """``(payload, group)`` the request is queued with. Raises for a
        request that can never be served, before it is queued."""
        return payload, None

    # ------------------------------------------------------- admission

    def submit(self, payload, timeout_ms: float | None = None,
               request_id: str | None = None, **opts) -> Future:
        """Admit one request; returns its Future. Raises ``RejectedError``
        immediately on a full queue, a closed batcher or an armed
        ``serve_admit`` fault. ``request_id`` (client-supplied) is echoed;
        omitted, one is minted."""
        now = time.monotonic()
        rid = str(request_id) if request_id else reqtrace.new_request_id()
        plane = reqtrace.get_plane()
        tr = (plane.begin(rid, self._route, payload)
              if plane is not None else None)
        timeout_s = (self.default_timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1000.0)
        payload, group = self._accept(payload, opts, tr)
        req = _Request(payload=payload, opts=opts, group=group,
                       future=Future(), t_submit=now,
                       deadline=now + timeout_s, request_id=rid, trace=tr)
        req.future.request_id = rid
        with self._cv:
            if self._closed:
                with self.stats.lock:
                    self.stats.rejected_closed += 1
                reqtrace.finish(tr, "rejected_closed",
                                reason="batcher closed")
                raise RejectedError("batcher closed", request_id=rid)
            if len(self._queue) >= self.queue_depth:
                with self.stats.lock:
                    self.stats.rejected_full += 1
                reason = (f"queue full (depth={self.queue_depth}); "
                          f"retry later")
                reqtrace.finish(tr, "rejected_full", reason=reason)
                raise RejectedError(reason, request_id=rid)
            with self.stats.lock:
                admit_count = self.stats.admitted + 1
            try:
                fault_point("serve_admit", count=admit_count)
            except Exception as e:
                with self.stats.lock:
                    self.stats.rejected_fault += 1
                reqtrace.finish(tr, "rejected_fault",
                                reason=f"admission fault: {e}")
                raise RejectedError(f"admission fault: {e}",
                                    request_id=rid) from e
            self._queue.append(req)
            if tr is not None:
                tr.admitted()
            with self.stats.lock:
                self.stats.admitted += 1
                self.stats.queue_depth = len(self._queue)
            self._cv.notify_all()
        return req.future

    # ---------------------------------------------------------- expiry

    def _expire_locked(self) -> None:
        now = time.monotonic()
        keep = []
        for r in self._queue:
            if r.deadline <= now:
                with self.stats.lock:
                    self.stats.rejected_deadline += 1
                r.future.meta = reqtrace.finish(
                    r.trace, "expired",
                    reason="deadline exceeded before execution")
                r.future.set_error(RejectedError(
                    "deadline exceeded before execution",
                    request_id=r.request_id))
            else:
                keep.append(r)
        if len(keep) != len(self._queue):
            self._queue = keep
            with self.stats.lock:
                self.stats.queue_depth = len(self._queue)

    def _expiry_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._queue:
                    return
                self._expire_locked()
                if self._queue:
                    wake = min(r.deadline for r in self._queue)
                    self._cv.wait(max(wake - time.monotonic(), 0.0) + 1e-3)
                else:
                    self._cv.wait(0.05)

    def _die(self, error: BaseException) -> None:
        """The worker died: close, and fail everything still queued."""
        what = f"{self._worker_kind} died: {error}"
        with self._cv:
            self._closed = True
            pending, self._queue = self._queue, []
            with self.stats.lock:
                self.stats.queue_depth = 0
                self.stats.failed += len(pending)
            self._cv.notify_all()
        for r in pending:
            if not r.future.done():
                r.future.meta = reqtrace.finish(r.trace, "failed",
                                                reason=what)
                r.future.set_error(RejectedError(what,
                                                 request_id=r.request_id))
        print(f"serving {self._worker_kind} died: {type(error).__name__}: "
              f"{error}")

    # ----------------------------------------------------------- admin

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def close(self, drain: bool = True) -> None:
        """Stop the worker. ``drain=True`` serves what is queued first;
        False rejects the queue."""
        with self._cv:
            self._closed = True
            if not drain:
                pending, self._queue = self._queue, []
                for r in pending:
                    r.future.meta = reqtrace.finish(
                        r.trace, "rejected_closed", reason="batcher closed")
                    r.future.set_error(RejectedError(
                        "batcher closed", request_id=r.request_id))
                with self.stats.lock:
                    self.stats.queue_depth = 0
            self._cv.notify_all()
        self._worker.join(timeout=30)
        self._expirer.join(timeout=30)


class DynamicBatcher(_QueueBatcher):
    """Bounded queue + one worker thread assembling microbatches.

    ``runner(payloads, opts_list) -> results`` executes one microbatch.
    ``group_key(payload, opts)`` partitions requests into shape-compatible
    groups (None = everything batches together). ``latency`` (a
    ``StreamingHistogram``) records per-request end-to-end milliseconds;
    ``on_batch(batcher)`` runs after every successful batch.
    """

    def __init__(self, runner: Callable, *, max_batch: int = 8,
                 max_delay_ms: float = 5.0, queue_depth: int = 64,
                 default_timeout_ms: float = 1000.0,
                 group_key: Callable | None = None,
                 latency=None, on_batch: Callable | None = None,
                 name: str = "serve"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_depth < max_batch:
            raise ValueError(f"queue_depth ({queue_depth}) must hold at "
                             f"least one full batch ({max_batch})")
        super().__init__(queue_depth=queue_depth,
                         default_timeout_ms=default_timeout_ms,
                         latency=latency, name=name)
        self._runner = runner
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self._group_key = group_key
        self._on_batch = on_batch
        self._start(f"{name}-batcher")

    def _accept(self, payload, opts: dict, trace):
        return payload, (self._group_key(payload, opts)
                         if self._group_key is not None else None)

    # ---------------------------------------------------------- worker

    def _take_batch(self) -> list[_Request] | None:
        """Block until a batch is ready (or the batcher closes); expire
        overdue requests while waiting. Returns None only at close."""
        with self._cv:
            while True:
                if self._closed and not self._queue:
                    return None
                self._expire_locked()
                if self._queue:
                    oldest = self._queue[0]
                    ready_at = oldest.t_submit + self.max_delay_s
                    same = [r for r in self._queue
                            if r.group == oldest.group]
                    if (len(same) >= self.max_batch or self._closed
                            or time.monotonic() >= ready_at):
                        batch = same[:self.max_batch]
                        taken = set(map(id, batch))
                        self._queue = [r for r in self._queue
                                       if id(r) not in taken]
                        for r in batch:
                            if r.trace is not None:
                                r.trace.taken()
                        with self.stats.lock:
                            self.stats.queue_depth = len(self._queue)
                        # the expiry thread sleeps until the oldest
                        # deadline it saw; wake it to re-read the queue
                        self._cv.notify_all()
                        return batch
                    self._cv.wait(max(ready_at - time.monotonic(), 0.0))
                else:
                    self._cv.wait(0.1)

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                with self.stats.lock:
                    self.stats.batches += 1
                    self.stats.batched_requests += len(batch)
                    n_batch = self.stats.batches
                fault_point("serve_batch", count=n_batch, size=len(batch))
                with trace_span("serve_batch", count=n_batch,
                                size=len(batch)), \
                        telemetry.armed("serve_batch", count=n_batch,
                                        size=len(batch)), \
                        reqtrace.batch_context([r.trace for r in batch]):
                    results = self._runner([r.payload for r in batch],
                                           [r.opts for r in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"runner returned {len(results)} results for "
                        f"{len(batch)} requests")
                now = time.monotonic()
                for r, res in zip(batch, results):
                    if self.latency is not None:
                        self.latency.record((now - r.t_submit) * 1e3)
                    # meta before the result: a client reading the future
                    # right after result() sees the summary
                    r.future.meta = reqtrace.finish(r.trace, "ok")
                    r.future.set_result(res)
                with self.stats.lock:
                    self.stats.completed += len(batch)
                if self._on_batch is not None:
                    try:
                        self._on_batch(self)
                    except Exception as e:  # hooks never kill serving
                        print(f"serving on_batch hook failed: {e}")
            except Exception as e:
                # one bad batch: fail ITS futures, keep serving
                with self.stats.lock:
                    self.stats.failed += len(batch)
                for r in batch:
                    if not r.future.done():
                        r.future.meta = reqtrace.finish(
                            r.trace, "failed",
                            reason=f"{type(e).__name__}: {e}")
                        r.future.set_error(e)
            except BaseException as e:
                # worker death: fail the batch AND everything pending, close
                for r in batch:
                    if not r.future.done():
                        r.future.meta = reqtrace.finish(
                            r.trace, "failed",
                            reason=f"worker died: {type(e).__name__}: {e}")
                        r.future.set_error(e)
                self._die(e)
                return
