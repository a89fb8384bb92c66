"""Host→device input pipeline.

The counterpart of ``distributed_tensorflow_tpu/data/pipeline.py``. The
reference uploads each feed_dict batch synchronously inside ``sess.run``
(``MNISTDist.py:179,188``). Here a background thread assembles the next
host batches into pinned memory while the current step runs, and the
consumer copies each one to the card asynchronously on its current
stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.utils.faults import fault_point


def batch_iterator(dataset, batch_size: int, raw: bool = False) -> Iterator:
    """Endless minibatch stream; ``raw=True`` yields thin-wire (uint8,
    int32) batches (see DataSet.next_batch_raw)."""
    draw = dataset.next_batch_raw if raw else dataset.next_batch
    while True:
        yield draw(batch_size)


_END = object()
_POLL_S = 0.05  # how often a blocked worker looks at the stop flag


class _PinnedSlot:
    """One batch's pinned host buffers and the event that marks the end
    of the last copy out of them."""

    def __init__(self):
        self.buffers: tuple[torch.Tensor, ...] = ()
        self.copied: torch.cuda.Event | None = None

    def fill(self, batch) -> tuple[torch.Tensor, ...]:
        """Write ``batch`` (numpy arrays) into the buffers, after the
        previous copy out of them has completed."""
        if self.copied is not None:
            self.copied.synchronize()
        host = [torch.from_numpy(np.asarray(a)) for a in batch]
        if [(b.shape, b.dtype) for b in self.buffers] != \
                [(h.shape, h.dtype) for h in host]:
            self.buffers = tuple(torch.empty(h.shape, dtype=h.dtype,
                                             pin_memory=True) for h in host)
        for buf, h in zip(self.buffers, host):
            buf.copy_(h)
        return self.buffers


def prefetch_to_device(it: Iterator, size: int = 2,
                       device: torch.device | str = "cpu") -> Iterator:
    """Wrap a host batch iterator (tuples of numpy arrays) with a
    prefetch queue of ``size`` batches, yielding tuples of tensors on
    ``device``.

    For a CUDA device the worker thread writes each batch into one of
    ``size + 2`` pinned slots (the queue's, the one being written and the
    one being copied); the consumer copies it to the card with
    ``non_blocking=True`` on its current stream and records an event, and
    the worker waits on that event before it writes the slot again. For
    the CPU the tensors wrap the host arrays.

    Worker exceptions reach the consumer (no silent end of stream), and
    closing the generator (break / ``.close()``) stops the worker thread
    rather than leaking it on a full queue."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    q: queue.Queue = queue.Queue(maxsize=size)
    free: queue.Queue = queue.Queue()
    stop = threading.Event()
    slots = [_PinnedSlot() for _ in range(size + 2)] if cuda else []
    for i in range(len(slots)):
        free.put(i)

    def _send(item) -> bool:
        """put that gives up when the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _take_slot() -> int | None:
        while not stop.is_set():
            try:
                return free.get(timeout=_POLL_S)
            except queue.Empty:
                continue
        return None

    def _worker():
        try:
            for count, batch in enumerate(it):
                # an exception here reaches the consumer as itself: not
                # a hang and not a silent short epoch
                fault_point("prefetch", count=count)
                if cuda:
                    i = _take_slot()
                    if i is None:
                        return
                    item = (i, slots[i].fill(batch))
                else:
                    item = (None, tuple(torch.from_numpy(np.asarray(a))
                                        for a in batch))
                if stop.is_set() or not _send(item):
                    return
            _send(_END)
        except BaseException as e:  # noqa: BLE001 — delivered to the consumer
            _send(e)

    t = threading.Thread(target=_worker, name="prefetch", daemon=True)
    t.start()
    # bound locally: module globals (queue.Empty) may already be torn down
    # when a leaked generator is finalized at interpreter shutdown
    empty_exc = queue.Empty
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            i, host = item
            if not cuda:
                yield host
                continue
            out = tuple(h.to(device, non_blocking=True) for h in host)
            slot = slots[i]
            slot.copied = torch.cuda.Event()
            slot.copied.record(torch.cuda.current_stream(device))
            free.put(i)
            yield out
    finally:
        stop.set()
        # drain so a blocked worker sees stop promptly
        try:
            while True:
                q.get_nowait()
        except empty_exc:
            pass
        t.join(timeout=10)
