"""Continuous batching: iteration-level scheduling over paged KV slots.

The counterpart of ``distributed_tensorflow_tpu/serving/continuous.py``.
The whole-batch path (``DynamicBatcher`` + ``engine.generate``) commits a
microbatch for its entire generation: one 512-token request holds its
batch, and the worker, while short requests queue behind it, and every
row is billed a dense ``(B, seq_len, H, Dh)`` cache. This module
schedules between decode iterations instead, over a paged cache:

- ``ContinuousScheduler`` owns a fixed set of batch slots over one step
  (``decode.make_slot_step``). Every iteration feeds each resident slot
  its next token at its own position; requests are admitted into free
  slots and retired out of finished ones between iterations.
- A prompt enters the cache one token per iteration through the same step
  (prefill-as-decode), so a long prompt stalls in-flight decodes for no
  more than one iteration at a time.
- ``kvpage.PageAllocator`` commits a request's worst-case footprint at
  admission (an admitted request always runs to completion) and hands out
  pages as generation crosses page boundaries, so ``pages_in_use`` tracks
  live tokens. Occupancy feeds ``/metrics``' ``hbm.kv_pages`` block and
  the ``--serve_hbm_headroom_pct`` drain floor.
- ``ContinuousBatcher`` is ``DynamicBatcher``'s sibling with the same
  ``Future``, expiry, stats and admission contract (reject, never hang;
  the ``serve_admit`` and ``serve_batch`` fault points; a request-plane
  disposition on every exit) and the same close, drain and die story.

On a card ``EngineSlotBackend`` replays the slot step from one CUDA graph,
captured after a warm-up with static buffers for the page table, the
tokens and the positions and the pools as the graph's own tensors: the
counterpart of the JAX package's one jitted step with donated pools. On
the CPU it runs the step eagerly. A failed capture or replay raises.

Phase accounting under mid-batch admission: a request's slot residency is
bracketed by ``taken()``/``run_start()`` at slot admission and
``run_end()`` at retirement; each iteration's wall time is noted to every
resident (``decode`` with one tick when that slot sampled a token,
``prefill`` while its prompt is still entering the cache), so the plane's
``sum(phases) == wall`` holds whatever the iteration of admission or
retirement.

Greedy tokens equal whole-batch ``generate()``'s wherever the top-2
margin clears the logits' tolerance: on the JAX package's XLA:CPU the
two are bitwise equal, but neither torch's CPU BLAS nor cuBLAS promises
row-count-independent reductions. Temperature sampling draws from a
per-request ``torch.Generator`` seeded by the request's ``seed`` (0 when
absent) and promises no reproducibility across schedulers or frameworks.

Threads: ``ContinuousBatcher`` starts a scheduler thread (``_run``,
the iteration loop) and an expiry thread (``_expiry_loop``). Queue and
lifecycle state live under the batcher's condition variable, counters
under their own locks; the step runs outside every lock but the
backend's, so admission never waits on the card. Lock order: batcher cv
-> ``_slot_lock`` -> {``_lock``, ``allocator._lock``, ``backend._lock``}.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.serving import decode as dec
from distributed_tensorflow_tpu_torch.serving import reqtrace
from distributed_tensorflow_tpu_torch.serving.batcher import _QueueBatcher
from distributed_tensorflow_tpu_torch.serving.kvpage import PageAllocator
from distributed_tensorflow_tpu_torch.utils import telemetry
from distributed_tensorflow_tpu_torch.utils.faults import fault_point

GRAPH_WARMUP_STEPS = 2  # eager runs on the backend's stream before capture


class HostSlotBackend:
    """Device-free slot stepper: deterministic logits from a small seeded
    embedding/head pair, numpy only. The test double of
    ``EngineSlotBackend``: the scheduler's state machine, the page
    ledger and the phase accounting run against it. ``step_cost`` (a
    callable) charges a chosen amount of work per iteration."""

    def __init__(self, *, n_slots: int = 4, capacity: int = 64,
                 page_size: int = 16, num_pages: int = 0,
                 vocab_size: int = 32, step_cost=None):
        if n_slots < 2:
            raise ValueError(f"n_slots must be >= 2, got {n_slots}")
        if page_size < 1 or capacity % page_size:
            raise ValueError(f"page_size ({page_size}) must divide the "
                             f"capacity ({capacity})")
        self.n_slots = int(n_slots)
        self.capacity = int(capacity)
        self.page_size = int(page_size)
        self.pages_per_slot = self.capacity // self.page_size
        self.num_pages = int(num_pages) or self.n_slots * self.pages_per_slot
        self.vocab_size = int(vocab_size)
        self._step_cost = step_cost
        rng = np.random.default_rng(0)
        self._emb = rng.standard_normal(
            (self.vocab_size, 16)).astype(np.float32)
        self._head = rng.standard_normal(
            (16, self.vocab_size)).astype(np.float32)

    def step(self, page_table, tok, t):
        if self._step_cost is not None:
            self._step_cost()
        # position-dependent, so greedy sequences are not trivial
        h = self._emb[tok] + np.asarray(t)[:, None].astype(np.float32)
        return h @ self._head

    def wants_refresh(self) -> bool:
        return False

    def refresh(self) -> None:
        pass

    def reset(self) -> None:
        pass


class EngineSlotBackend:
    """Device-backed slot stepper over the paged KV pools of
    ``engine.model``, on the engine's device.

    Holds the engine's current (module, step) pinned for the in-flight
    requests: the scheduler re-pins (``refresh``) only when no slot is
    resident, so a hot swap changes what later requests see, never one in
    mid-generation (drain-to-swap).

    On a CUDA device the step is one CUDA graph, captured at the first
    step after ``GRAPH_WARMUP_STEPS`` eager runs, on a stream the backend
    owns; the page table, tokens and positions are copied into its static
    buffers and the logits read back from its static output. A re-pin
    drops the graph, and the next step captures one on the new module
    (the graph holds the old module's addresses). ``captures`` counts the
    captures. On the CPU the step runs eagerly. All mutable state is
    guarded by one lock: the scheduler thread steps while ``/metrics``
    handlers read."""

    def __init__(self, engine, *, n_slots: int = 4, page_size: int = 16,
                 num_pages: int = 0):
        dec.check_decodable(engine.model)
        if n_slots < 2:
            # width >= 2 keeps every contraction a GEMM, the floor the
            # whole-batch decode keeps too
            raise ValueError(f"n_slots must be >= 2, got {n_slots}")
        capacity = engine.model.seq_len
        if page_size < 1 or capacity % page_size:
            raise ValueError(f"page_size ({page_size}) must divide the "
                             f"cache capacity ({capacity})")
        pages_per_slot = capacity // page_size
        if num_pages <= 0:
            # full provisioning: every slot can hold a max-length request
            num_pages = n_slots * pages_per_slot
        if num_pages < pages_per_slot:
            raise ValueError(
                f"num_pages ({num_pages}) cannot hold one full-context "
                f"request ({pages_per_slot} pages)")
        device = engine.device
        self.engine = engine
        self.device = device
        self.graph = device.type == "cuda"
        self.n_slots = int(n_slots)
        self.capacity = capacity
        self.page_size = int(page_size)
        self.pages_per_slot = pages_per_slot
        self.num_pages = int(num_pages)
        self.vocab_size = engine.model.vocab_size
        self.captures = 0
        self._lock = threading.Lock()
        self._step_fn = dec.make_slot_step(engine.model, page_size)
        self._pools = dec.make_slot_pools(engine.model, page_size,
                                          self.num_pages, device=device)
        self._module, self._params_step = engine.current()
        self._graph = None
        self._stream = None
        if self.graph:
            self._inputs = (
                torch.zeros((self.n_slots, pages_per_slot), dtype=torch.int32,
                            device=device),
                torch.zeros(self.n_slots, dtype=torch.int32, device=device),
                torch.zeros(self.n_slots, dtype=torch.int32, device=device))
            self._logits = None
            self._stream = torch.cuda.Stream(device)
            # the pools and the input buffers were zeroed on the current
            # stream
            self._stream.wait_stream(torch.cuda.current_stream(device))

    @property
    def params_step(self) -> int:
        with self._lock:
            return self._params_step

    @property
    def pools(self) -> tuple:
        """The live (k_pool, v_pool) pairs (tests and the smoke script
        read them)."""
        with self._lock:
            return self._pools

    def wants_refresh(self) -> bool:
        with self._lock:
            pinned = self._params_step
        return self.engine.step != pinned

    def refresh(self) -> None:
        """Re-pin the engine's current module; the scheduler calls it only
        with zero residents (drain-to-swap). The graph of the old module
        is dropped."""
        with self._lock:
            self._module, self._params_step = self.engine.current()
            if self._stream is not None:
                # the new module was placed on another thread's stream
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                self._graph = None
                self._logits = None

    def reset(self) -> None:
        """Zero the pools in place (the scheduler's abort path: after a
        failed step their contents are unknown). In place, because a
        captured graph holds their addresses."""
        with self._lock, torch.no_grad(), self._on_stream():
            for k_pool, v_pool in self._pools:
                k_pool.zero_()
                v_pool.zero_()

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _run(self, page_table, tok, t):
        return self._step_fn(self._module, self._pools, page_table, tok, t)

    def _capture(self) -> None:
        """Warm up on the backend's stream, then record one step into a
        CUDA graph. The warm-up writes the pools with the values the
        graph's first replay writes again (the same tokens at the same
        positions), so it changes nothing a live request reads."""
        for _ in range(GRAPH_WARMUP_STEPS):
            self._run(*self._inputs)
        self._stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            self._logits = self._run(*self._inputs)
        self._graph = graph
        self.captures += 1

    def step(self, page_table, tok, t) -> np.ndarray:
        with self._lock, torch.no_grad(), self._on_stream():
            if not self.graph:
                logits = self._run(
                    torch.from_numpy(np.asarray(page_table)).to(self.device),
                    torch.from_numpy(np.asarray(tok)).to(self.device),
                    torch.from_numpy(np.asarray(t)).to(self.device))
                return logits.cpu().numpy()
            for buf, host in zip(self._inputs, (page_table, tok, t)):
                buf.copy_(torch.from_numpy(np.asarray(host)))
            if self._graph is None:
                self._capture()
            self._graph.replay()
            return self._logits.cpu().numpy()


class _Slot:
    """One resident request's decode state: ``fed`` counts positions
    already written into the cache (prompt first, then generated tokens);
    the request retires when ``len(generated) == n``."""

    __slots__ = ("req", "prompt", "n", "fed", "generated", "reservation",
                 "temperature", "seed", "rng", "keep_logits", "logits")

    def __init__(self, req, prompt, n, reservation):
        self.req = req
        self.prompt = prompt
        self.n = n
        self.fed = 0
        self.generated: list[int] = []
        self.reservation = reservation
        self.temperature = float(req.opts.get("temperature", 0.0) or 0.0)
        self.seed = req.opts.get("seed")
        self.rng = None
        self.keep_logits = bool(req.opts.get("return_logits", False))
        self.logits: list[np.ndarray] = []


class ContinuousScheduler:
    """Slot and page state machine driven by the batcher's scheduler
    thread.

    A slot is empty (``None``: its page-table row is all zeros, the
    scratch page) or resident (a ``_Slot``). One iteration (``_iterate``)
    feeds every resident its next token at its own position through one
    backend step, samples where a slot's prompt is consumed, and retires
    slots whose generation completed. Underscored methods run on the
    scheduler thread only; ``snapshot`` and ``allocator.occupancy()`` are
    the cross-thread reads.

    Feed schedule (that of ``generate()``): a request with prompt length P
    and N new tokens feeds positions ``0 .. P+N-2``, prompt tokens first,
    then its own samples; the sample drawn after feeding position
    ``P-1+k`` is output token ``k``, and the last token is sampled but
    never fed. The cache footprint is ``P+N-1`` tokens, the page
    commitment."""

    def __init__(self, backend):
        self.backend = backend
        self.n_slots = backend.n_slots
        self.capacity = backend.capacity
        self.page_size = backend.page_size
        self.pages_per_slot = backend.pages_per_slot
        self.allocator = PageAllocator(backend.num_pages, backend.page_size)
        self._slots: list = [None] * self.n_slots
        self._free_slots = list(range(self.n_slots - 1, -1, -1))
        self._page_table = np.zeros((self.n_slots, self.pages_per_slot),
                                    np.int32)
        self._tok = np.zeros(self.n_slots, np.int32)
        self._t = np.zeros(self.n_slots, np.int32)
        # slot state is touched by the scheduler thread, and by close()'s
        # failure path; one uncontended lock makes the ownership explicit
        self._slot_lock = threading.Lock()
        # counters: written by the scheduler thread, read by /metrics
        self._lock = threading.Lock()
        self._iterations = 0
        self._tokens_emitted = 0
        self._resident_iterations = 0
        self._live_tokens_high = 0
        self._ledger_ok = True

    # ------------------------------------------------- admission checks

    def _validate(self, prompt: np.ndarray, n: int) -> str | None:
        """The reasons ``decode.generate`` refuses a request (vocabulary,
        capacity) plus the page-pool bound; None when servable."""
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            return f"prompt must be 1-D with >= 1 token; got shape " \
                   f"{tuple(prompt.shape)}"
        if n < 1:
            return f"max_new_tokens must be >= 1, got {n}"
        p = int(prompt.shape[0])
        if p + n > self.capacity:
            return (f"prompt ({p}) + max_new_tokens ({n}) exceeds the "
                    f"model's context window / cache capacity "
                    f"({self.capacity})")
        vocab = getattr(self.backend, "vocab_size", None)
        if vocab is not None and prompt.size and (
                int(prompt.min()) < 0 or int(prompt.max()) >= vocab):
            return (f"prompt ids must be in [0, {vocab}); got range "
                    f"[{prompt.min()}, {prompt.max()}]")
        if self.allocator.pages_for(p + n - 1) > self.allocator.num_pages:
            return (f"request footprint ({p + n - 1} tokens) exceeds the "
                    f"KV page pool ({self.allocator.num_pages} pages of "
                    f"{self.page_size})")
        return None

    def _can_admit(self, req) -> bool:
        with self._slot_lock:
            if not self._free_slots:
                return False
        p = int(np.asarray(req.payload).shape[-1])
        n = int(req.opts.get("max_new_tokens", 16))
        return self.allocator.can_admit(p + n - 1)

    def _has_residents(self) -> bool:
        with self._slot_lock:
            return len(self._free_slots) < self.n_slots

    def _wants_refresh(self) -> bool:
        return self.backend.wants_refresh()

    def _refresh(self) -> None:
        self.backend.refresh()

    # ---------------------------------------------------- slot lifecycle

    def _admit(self, req) -> None:
        """Move a validated request whose pages fit into a free slot. The
        caller checked ``_can_admit``; runs under the batcher cv (no
        device work here)."""
        prompt = np.asarray(req.payload, np.int32).reshape(-1)
        n = int(req.opts.get("max_new_tokens", 16))
        reservation = self.allocator.reserve(len(prompt) + n - 1)
        with self._slot_lock:
            i = self._free_slots.pop()
            self._slots[i] = _Slot(req, prompt, n, reservation)
        tr = req.trace
        if tr is not None:
            tr.taken()
            tr.run_start()
        with self._lock:
            it = self._iterations
        reqtrace.note_slot_admit(tr, iteration=it, slot=i)

    def _retire(self, i: int):
        """Free slot ``i`` (generation complete): release its pages, point
        its page-table row back at scratch, hand back (request, result)."""
        s = self._slots[i]
        tr = s.req.trace
        if tr is not None:
            tr.run_end()
        with self._lock:
            it = self._iterations
        reqtrace.note_slot_retire(tr, iteration=it)
        self.allocator.release(s.reservation)
        self._page_table[i, :] = 0
        self._tok[i] = 0
        self._t[i] = 0
        self._slots[i] = None
        self._free_slots.append(i)
        tokens = np.concatenate(
            [s.prompt, np.asarray(s.generated, np.int32)])
        if s.keep_logits:
            return s.req, {"tokens": tokens, "logits": np.stack(s.logits)}
        return s.req, tokens

    def _abort_residents(self) -> list:
        """Failure path: evict every resident (pages released, slots
        cleared, pools zeroed) and return their requests for the batcher
        to fail. The scheduler keeps serving afterwards."""
        failed = []
        with self._slot_lock:
            for i in range(self.n_slots):
                s = self._slots[i]
                if s is None:
                    continue
                if s.req.trace is not None:
                    s.req.trace.run_end()
                self.allocator.release(s.reservation)
                self._page_table[i, :] = 0
                self._tok[i] = 0
                self._t[i] = 0
                self._slots[i] = None
                self._free_slots.append(i)
                failed.append(s.req)
        self.backend.reset()
        return failed

    # -------------------------------------------------------- iteration

    def _sample(self, s: _Slot, row: np.ndarray) -> int:
        if s.temperature > 0.0:
            if s.rng is None:
                s.rng = torch.Generator().manual_seed(
                    int(s.seed) if s.seed is not None else 0)
            return int(dec._gumbel_sample(row[None, :], s.temperature,
                                          s.rng)[0])
        return int(row.argmax())

    def _iterate(self):
        """One decode tick over the residents. Returns ``(finished,
        n_active)``: the (request, result) pairs retired this iteration
        and the number of residents it fed."""
        with self._slot_lock:
            return self._iterate_locked()

    def _iterate_locked(self):
        t0 = time.perf_counter()
        active = [i for i in range(self.n_slots)
                  if self._slots[i] is not None]
        for i in active:
            s = self._slots[i]
            if s.fed % self.page_size == 0:
                # crossing into a fresh logical page: map a physical one
                # (the admission commitment guarantees one is free)
                self._page_table[i, s.fed // self.page_size] = \
                    self.allocator.alloc(s.reservation)
            p = len(s.prompt)
            self._tok[i] = (s.prompt[s.fed] if s.fed < p
                            else s.generated[s.fed - p])
            self._t[i] = s.fed
        logits = self.backend.step(self._page_table, self._tok, self._t)
        d = time.perf_counter() - t0
        finished = []
        n_sampled = 0
        for i in active:
            s = self._slots[i]
            sampling = s.fed >= len(s.prompt) - 1
            tr = s.req.trace
            if tr is not None:
                # every resident waited the whole iteration; noting before
                # any run_end keeps the note inside the run window, so
                # sum(phases) == wall survives mid-batch retirement
                tr.note("decode" if sampling else "prefill", d,
                        ticks=1 if sampling else None)
            s.fed += 1
            if sampling:
                n_sampled += 1
                tok = self._sample(s, logits[i])
                s.generated.append(tok)
                if s.keep_logits:
                    s.logits.append(np.array(logits[i], copy=True))
                if len(s.generated) >= s.n:
                    finished.append(self._retire(i))
        # the page ledger: pages in use must equal the residents' summed
        # ceil(fed / page_size), i.e. memory tracks live tokens
        expect = sum(
            -(-self._slots[i].fed // self.page_size)
            for i in range(self.n_slots) if self._slots[i] is not None)
        in_use = self.allocator.occupancy()["pages_in_use"]
        live_tokens = sum(
            self._slots[i].fed for i in range(self.n_slots)
            if self._slots[i] is not None)
        with self._lock:
            self._iterations += 1
            self._tokens_emitted += n_sampled
            self._resident_iterations += len(active)
            self._ledger_ok = self._ledger_ok and (in_use == expect)
            if live_tokens > self._live_tokens_high:
                self._live_tokens_high = live_tokens
        return finished, len(active)

    # ---------------------------------------------------------- reports

    def snapshot(self) -> dict:
        """Scheduler counters and page occupancy: ``/metrics``'
        ``continuous`` block."""
        with self._lock:
            iterations = self._iterations
            tokens = self._tokens_emitted
            resident = self._resident_iterations
            live_high = self._live_tokens_high
            ledger_ok = self._ledger_ok
        return {
            "n_slots": self.n_slots,
            "iterations": iterations,
            "tokens_emitted": tokens,
            "tokens_per_iteration": round(tokens / iterations, 4)
            if iterations else 0.0,
            "slot_occupancy": round(
                resident / (iterations * self.n_slots), 4)
            if iterations else 0.0,
            "live_tokens_high_water": live_high,
            "page_ledger_ok": ledger_ok,
            "kv_pages": self.allocator.occupancy(),
        }


class ContinuousBatcher(_QueueBatcher):
    """``DynamicBatcher``'s continuous-mode sibling: the same bounded
    admission, Future, expiry, stats and request-plane contract (the
    shared ``batcher._QueueBatcher``), with an iteration-level scheduler
    loop as the worker. One "batch" in the stats is one scheduler
    iteration (``mean_batch_size`` reads as the mean slot occupancy).

    Admission is strict FIFO: the queue head is admitted as soon as a
    slot and its whole page commitment are free, and nothing overtakes
    it. A request that can never be served (vocabulary, capacity, page
    pool) raises ``ValueError`` at submit, a 400 on the wire, with the
    disposition "failed". ``close(drain=False)`` rejects the queue, but
    residents still finish: nothing preempts them."""

    _worker_kind = "scheduler"

    def __init__(self, backend, *, queue_depth: int = 64,
                 default_timeout_ms: float = 1000.0,
                 latency=None, on_iteration=None, name: str = "generate"):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, "
                             f"got {queue_depth}")
        super().__init__(queue_depth=queue_depth,
                         default_timeout_ms=default_timeout_ms,
                         latency=latency, name=name)
        self._on_iteration = on_iteration
        self.scheduler = ContinuousScheduler(backend)
        self.max_batch = backend.n_slots  # the DynamicBatcher interface
        self._start(f"{name}-sched")

    def _accept(self, payload, opts: dict, trace):
        """Validation against the capacity, the vocabulary and the page
        pool: a request that can never be served fails here."""
        prompt = np.asarray(payload)
        n = int(opts.get("max_new_tokens", 16))
        err = self.scheduler._validate(prompt, n)
        if err is not None:
            with self.stats.lock:
                self.stats.failed += 1
            reqtrace.finish(trace, "failed", reason=err)
            raise ValueError(err)
        return prompt, None

    # ------------------------------------------------- scheduler thread

    def _admit_locked(self) -> None:
        """Strict-FIFO slot admission from the queue head; stops at the
        first request that does not fit (slot or pages)."""
        sched = self.scheduler
        admitted = False
        while self._queue and sched._can_admit(self._queue[0]):
            r = self._queue.pop(0)
            sched._admit(r)
            admitted = True
        if admitted:
            with self.stats.lock:
                self.stats.queue_depth = len(self._queue)
            # the expiry thread sleeps until the oldest deadline it saw;
            # wake it to re-read the queue (and to exit once it drains)
            self._cv.notify_all()

    def _run(self) -> None:
        sched = self.scheduler
        while True:
            with self._cv:
                while True:
                    self._expire_locked()
                    draining = sched._wants_refresh()
                    if not draining:
                        self._admit_locked()
                    if sched._has_residents():
                        break
                    if self._closed and not self._queue:
                        return
                    if draining:
                        # drain-to-swap: with zero residents a hot swap
                        # is safe (nothing is mid-flight)
                        sched._refresh()
                        continue
                    self._cv.wait(0.05)
            # the step runs outside the cv: admission never waits on the
            # card
            try:
                with self.stats.lock:
                    self.stats.batches += 1
                    n_iter = self.stats.batches
                fault_point("serve_batch", count=n_iter)
                with telemetry.armed("serve_batch", count=n_iter):
                    finished, n_active = sched._iterate()
                with self.stats.lock:
                    self.stats.batched_requests += n_active
                now = time.monotonic()
                for r, res in finished:
                    if self.latency is not None:
                        self.latency.record((now - r.t_submit) * 1e3)
                    # meta before the result, as on the whole-batch path
                    r.future.meta = reqtrace.finish(r.trace, "ok")
                    r.future.set_result(res)
                if finished:
                    with self.stats.lock:
                        self.stats.completed += len(finished)
                if self._on_iteration is not None:
                    try:
                        self._on_iteration(self)
                    except Exception as e:  # hooks never kill serving
                        print(f"serving on_iteration hook failed: {e}")
            except Exception as e:
                # one bad iteration (an injected serve_batch fault
                # included): fail the residents, reset, keep serving
                self._fail_residents(e, died=False)
            except BaseException as e:
                self._fail_residents(e, died=True)
                self._die(e)
                return

    def _fail_residents(self, error: BaseException, died: bool) -> None:
        requests = self.scheduler._abort_residents()
        if not requests:
            return
        with self.stats.lock:
            self.stats.failed += len(requests)
        what = "scheduler died" if died else f"{type(error).__name__}"
        for r in requests:
            if not r.future.done():
                r.future.meta = reqtrace.finish(
                    r.trace, "failed", reason=f"{what}: {error}")
                r.future.set_error(error)
