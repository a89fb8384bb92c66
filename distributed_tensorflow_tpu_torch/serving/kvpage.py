"""Free-list allocator over fixed-size KV-cache pages.

The counterpart of ``distributed_tensorflow_tpu/serving/kvpage.py``.

The whole-batch decode path preallocates a dense ``(B, seq_len, H, Dh)``
cache per block — every request is billed the full context window
whether it uses 8 tokens or 800. The paged cache (the vLLM
PagedAttention memory model) splits each slot's capacity into
fixed-size pages and lets a slot map only the pages its live tokens
actually occupy, so cache memory is proportional to live tokens.

This module is the HOST side of that story: pure bookkeeping over page
ids, no tensors. The device pools live with the slot step
(``decode.make_slot_pools``); the scheduler asks this allocator which
physical page backs each (slot, logical-page) entry and writes the id
into the page table the step consumes.

Two-phase discipline — **commit at admission, allocate on demand**:

- ``reserve(n_tokens)`` at admission commits ``ceil(n / page_size)``
  pages against the pool WITHOUT taking any. Admission is refused
  (``can_admit``) unless the request's whole worst-case footprint fits,
  so a mid-generation allocation can never fail — the no-preemption
  guarantee: an admitted request always runs to completion, there is no
  swap/recompute path to fall back to.
- ``alloc(reservation)`` takes one physical page as generation actually
  crosses a page boundary, so ``pages_in_use`` tracks LIVE tokens
  (``pages_in_use == sum over residents of ceil(fed / page_size)`` —
  the ledger invariant the tests assert), while ``pages_committed``
  tracks admission headroom.
- ``release(reservation)`` at retirement returns the pages and the
  commitment in one motion.

Page id 0 is never handed out: the device pools reserve row 0 as the
scratch page free slots read and write (their page-table rows are all
zero), so a freshly-zeroed table is safe by construction.

Occupancy feeds the ``/metrics`` ``hbm`` block (``kv_pages``) and the
``--serve_hbm_headroom_pct`` drain floor: a replica whose free-page
ratio falls below the floor flips /healthz before admission failures
turn into client-visible 429 storms.

All state is guarded by one lock: the scheduler thread mutates while
/metrics and /healthz handler threads read ``occupancy()``.
"""

from __future__ import annotations

import threading


def pages_needed(n_tokens: int, page_size: int) -> int:
    """``ceil(n_tokens / page_size)`` — the page footprint of a token
    count (0 tokens = 0 pages)."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens must be >= 0, got {n_tokens}")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    return -(-n_tokens // page_size)


class PageReservation:
    """One request's committed page budget: ``budget`` pages promised at
    admission, ``pages`` the physical ids actually taken so far. Opaque
    to the scheduler — only the allocator reads or writes it (under its
    lock), so the commitment arithmetic cannot drift."""

    __slots__ = ("budget", "pages")

    def __init__(self, budget: int):
        self.budget = int(budget)
        self.pages: list[int] = []


class PageAllocator:
    """Free list over physical pages ``1..num_pages`` with
    commitment-based admission (see module docstring)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # pop() hands out 1, 2, 3, ... — deterministic layout, easy to
        # eyeball in a page-table dump
        self._free = list(range(self.num_pages, 0, -1))
        self._committed = 0
        self._in_use = 0
        self._high_water = 0
        self._allocs_total = 0
        self._reservations = 0

    def pages_for(self, n_tokens: int) -> int:
        return pages_needed(n_tokens, self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        """True when a request storing up to ``n_tokens`` can be
        admitted without ever failing a mid-generation allocation."""
        need = self.pages_for(n_tokens)
        with self._lock:
            return self._committed + need <= self.num_pages

    def reserve(self, n_tokens: int) -> PageReservation:
        """Commit the worst-case footprint. Raises ``RuntimeError`` when
        the commitment does not fit — the scheduler must gate on
        ``can_admit`` first, so reaching this is a scheduler bug, not
        load."""
        need = self.pages_for(n_tokens)
        with self._lock:
            if self._committed + need > self.num_pages:
                raise RuntimeError(
                    f"page commitment overflow: {need} pages requested, "
                    f"{self.num_pages - self._committed} uncommitted of "
                    f"{self.num_pages} — admission must gate on "
                    f"can_admit()")
            self._committed += need
            self._reservations += 1
        return PageReservation(need)

    def alloc(self, res: PageReservation) -> int:
        """Take one physical page against ``res``. The commitment made
        at reserve() guarantees the free list is never empty here."""
        with self._lock:
            if len(res.pages) >= res.budget:
                raise RuntimeError(
                    f"reservation budget exhausted ({res.budget} pages) "
                    f"— the scheduler fed more tokens than it admitted")
            page = self._free.pop()
            res.pages.append(page)
            self._in_use += 1
            self._allocs_total += 1
            if self._in_use > self._high_water:
                self._high_water = self._in_use
        return page

    def release(self, res: PageReservation) -> None:
        """Return ``res``'s pages and commitment to the pool (retire /
        abort). Idempotent: a second release of the same reservation is
        a no-op."""
        with self._lock:
            self._free.extend(res.pages)
            self._in_use -= len(res.pages)
            self._committed -= res.budget
            if res.budget or res.pages:
                self._reservations -= 1
            res.pages = []
            res.budget = 0

    def occupancy(self) -> dict:
        """One consistent snapshot for /metrics (``hbm.kv_pages``), the
        health floor, and the bench's analytic facts."""
        with self._lock:
            in_use = self._in_use
            committed = self._committed
            high = self._high_water
            allocs = self._allocs_total
            live = self._reservations
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "pages_in_use": in_use,
            "pages_committed": committed,
            "pages_high_water": high,
            "allocs_total": allocs,
            "reservations": live,
            "occupancy_pct": round(100.0 * in_use / self.num_pages, 4),
            # the drain floor judges COMMITTED, not in-use: admission is
            # what fails when commitments exhaust the pool
            "free_pct": round(
                100.0 * (self.num_pages - committed) / self.num_pages, 4),
        }
