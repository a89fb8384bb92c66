"""The per-step time breakdown of the training loop.

The counterpart of ``distributed_tensorflow_tpu/utils/telemetry.py``'s
``StepTimer``; the span tracer, flight recorder and watchdog of that
module are not ported yet.
"""

from __future__ import annotations


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
