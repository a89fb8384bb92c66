"""Throughput metering, the collective in-flight cap and the device's
busy share in a profiled window.

The counterpart of ``distributed_tensorflow_tpu/utils/profiling.py``
(``Throughput``, ``collective_sync_cadence``). ``busy_share`` reads a
``torch.profiler`` trace, the port's stand-in for the JAX package's
``--profile_dir`` device trace.
"""

from __future__ import annotations

import time


class Throughput:
    """images/sec (and per-chip) meter over a training window."""

    def __init__(self, batch_size: int, n_chips: int = 1):
        self.batch_size = batch_size
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._images = 0

    def step(self, n: int | None = None):
        self._images += n if n is not None else self.batch_size

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._start
        return self._images / dt if dt > 0 else 0.0

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / max(self.n_chips, 1)


def collective_sync_cadence(backend: str | None, world_size: int) -> int:
    """How often (in steps) a data-parallel loop must wait for the device
    to bound the collectives in flight; 0 = never.

    gloo on the CPU with more than one rank: 1. The JAX package saw two
    collective programs in flight on one gloo pair crash the transport
    (a preamble/size mismatch); the port's gloo collectives block, and
    the cadence keeps that contract explicit. NCCL on the card: 0, since
    a stream runs its collectives in enqueue order."""
    return 1 if backend == "gloo" and world_size > 1 else 0


def busy_share(events, window: str | None = None) -> float | None:
    """The share of a profiled window in which the device ran at least
    one kernel or copy: the union of the device events' intervals, cut
    to the window. The window is the host event named ``window`` where
    one is given (the traced work, without idle margins around it; the
    device's copy of that annotation is not device time), else from the
    first event's start to the last event's end. ``events`` are
    ``torch.profiler.profile().events()``. None when the trace holds no
    device time (the profiler saw no device)."""
    from torch.autograd import DeviceType

    device, spans, marked = [], [], None
    for e in events:
        iv = (e.time_range.start, e.time_range.end)
        spans.append(iv)
        if window is not None and e.name == window:
            if e.device_type != DeviceType.CUDA:
                marked = iv
        elif e.device_type == DeviceType.CUDA and iv[1] > iv[0]:
            device.append(iv)
    if not device:
        return None
    lo, hi = marked or (min(s for s, _ in spans), max(s for _, s in spans))
    busy, end = 0.0, lo
    for start, stop in sorted(device):
        start, stop = max(start, end), min(stop, hi)
        if stop > start:
            busy += stop - start
            end = stop
    return busy / (hi - lo) if hi > lo else None
