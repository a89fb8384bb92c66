"""Supervisor: the reference's training orchestration.

The counterpart of ``distributed_tensorflow_tpu/training/supervisor.py``.
``tf.train.Supervisor`` (``MNISTDist.py:158-170``) owns chief designation
(task 0), init-or-restore at session start, periodic chief-only
checkpointing (on a writer thread with ``--async_checkpoint``), a
should_stop signal and cleanup; ``managed`` replaces
``managed_session``: it yields the (possibly restored) state and writes a
final checkpoint on the way out, on an error and on SIGTERM or SIGINT too
(MNISTDist.py:169-191). In sync mode every process runs one: each
restores the newest checkpoint, the loop then broadcasts rank 0's state
(``parallel.replicate_state``), and only the chief writes. The state is
replicated, so the monolithic format holds all of it; the coordinated
save of sharded state is not ported.
"""

from __future__ import annotations

import contextlib
import signal

import torch

from distributed_tensorflow_tpu_torch.checkpoint import (
    Checkpointer,
    checkpoint_keys,
    latest_checkpoint,
)
from distributed_tensorflow_tpu_torch.utils.pytree import _BF16_TAG, tree_map


@torch.no_grad()
def _adopt(live, restored):
    """Copy a restored tree into the live one, leaf by leaf: tensors in
    place (so the model's parameters and the optimizer's slots stay where
    they live, on their device), other leaves replaced."""
    return tree_map(lambda a, b: a.copy_(b) if isinstance(a, torch.Tensor)
                    else b, live, restored)


class Supervisor:
    def __init__(self, is_chief: bool, logdir: str,
                 save_model_secs: int = 600, max_to_keep: int = 5,
                 background: bool = False):
        self.is_chief = is_chief
        self.logdir = logdir
        self.checkpointer = Checkpointer(
            logdir, is_chief=is_chief, save_model_secs=save_model_secs,
            max_to_keep=max_to_keep, background=background)
        self._stop = False
        # the checkpoint.RestoreReport of the last init_or_restore (None
        # on a fresh init)
        self.restore_report = None

    def should_stop(self) -> bool:
        return self._stop

    def request_stop(self):
        """Ask the loop to stop (``sv.stop()``, MNISTDist.py:192);
        idempotent."""
        self._stop = True

    def init_or_restore(self, init_state):
        """Restore the newest verified checkpoint into ``init_state`` (its
        tensors are overwritten in place) or keep the fresh init
        (MNISTDist.py:169-170); returns (state, start_step).

        A params-only checkpoint (``{"params", "step"}``, the ps-mode
        layout) restores into a full TrainState: its params and step are
        adopted and the optimizer state starts fresh."""
        state, step = self._init_or_restore(init_state)
        self.restore_report = rep = self.checkpointer.last_restore_report
        if rep is not None:
            print(f"restored checkpoint step={rep.step} "
                  f"(fallback_depth={rep.fallback_depth}, "
                  f"quarantined={len(rep.quarantined)}, "
                  f"time={rep.time_s:.2f}s)")
        return state, step

    def _init_or_restore(self, init_state):
        try:
            restored = self.checkpointer.restore(init_state)
        except KeyError as e:
            # the fallback is only for a genuine params-only file; any
            # other mismatch (a switched --optimizer) stays loud
            if not (hasattr(init_state, "params")
                    and self._latest_is_params_only()):
                if "opt_state" in str(e):
                    raise KeyError(
                        f"{e.args[0] if e.args else e} — note: the optimizer "
                        f"state layout depends on --optimizer; resume with "
                        f"the same optimizer the checkpoint was written "
                        f"with") from e
                raise
            blob, step = self.checkpointer.restore(
                {"params": init_state.params, "step": 0})
            print(f"restored a params-only (ps-mode) checkpoint at step "
                  f"{step}; optimizer state starts fresh")
            return init_state._replace(
                params=_adopt(init_state.params, blob["params"]),
                step=torch.tensor(step, dtype=init_state.step.dtype)), step
        if restored is None:
            return init_state, 0
        state, step = restored
        return _adopt(init_state, state), step

    def _latest_is_params_only(self) -> bool:
        """True when the newest checkpoint holds exactly the
        ``{"params", "step"}`` layout."""
        found = latest_checkpoint(self.checkpointer.directory)
        if found is None:
            return False
        keys = {k.removeprefix(_BF16_TAG) for k in checkpoint_keys(found[0])}
        return bool(keys) and all(
            k == "step" or k.startswith("params/") for k in keys)

    def maybe_checkpoint(self, state, step: int):
        return self.checkpointer.maybe_save(state, step)

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT -> request_stop, so the loop exits cleanly and
        ``managed`` writes the final checkpoint. Returns a restore
        callable; a no-op off the main thread."""
        previous = {}

        def _handler(signum, frame):
            print(f"signal {signum}: stop requested, checkpointing... "
                  f"(repeat to force-quit)", flush=True)
            self.request_stop()
            # a second signal gets the original disposition
            for sig, old in previous.items():
                signal.signal(sig, old)

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                previous[sig] = signal.signal(sig, _handler)
        except ValueError:  # not the main thread
            previous = {}

        def _restore():
            for sig, old in previous.items():
                signal.signal(sig, old)

        return _restore

    @contextlib.contextmanager
    def managed(self, init_state):
        """Restore-or-init on entry; on exit (normal, error, or a signal
        that requested the stop) the chief writes a final checkpoint of
        the last state the loop published with ``box.update``,
        synchronously, after any background write, and the writer thread
        stops."""
        box = _StateBox(*self.init_or_restore(init_state))
        restore_signals = self._install_signal_handlers()
        try:
            yield box
        finally:
            restore_signals()
            if self.is_chief:
                try:
                    self.checkpointer.save(box.state, box.step)
                except Exception as e:  # noqa: BLE001 — best-effort on exit
                    print(f"final checkpoint failed: {e}")
            self.checkpointer.close()
            self.request_stop()


class _StateBox:
    """Mutable holder so the loop can publish progress to the supervisor."""

    def __init__(self, state, step: int):
        self.state = state
        self.step = step

    def update(self, state, step: int):
        self.state = state
        self.step = step
