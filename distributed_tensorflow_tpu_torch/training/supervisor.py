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
(``parallel.replicate_state``), and only the chief writes a replicated
state. A tensor-parallel state, which no one rank holds whole, is saved
by every rank together (``_coordinated_save``): as a sharded set, each
rank its own slices, or with ``--sharded_checkpoint=false`` gathered
and written by the chief; ``managed``'s exit first runs a bounded
agreement of every rank (``utils.pytree.agree_clean_exit``).
"""

from __future__ import annotations

import contextlib
import signal
import threading

import torch

from distributed_tensorflow_tpu_torch.checkpoint import (
    Checkpointer,
    checkpoint_keys,
    latest_checkpoint,
)
from distributed_tensorflow_tpu_torch.utils.faults import fault_point
from distributed_tensorflow_tpu_torch.utils.pytree import (
    _BF16_TAG,
    agree_clean_exit,
    flatten_pytree,
    join_collective_fetch,
    needs_collective_fetch,
    run_bounded,
    tree_map,
)


@torch.no_grad()
def _adopt(live, restored):
    """Copy a restored tree into the live one, leaf by leaf: tensors in
    place (so the model's parameters and the optimizer's slots stay where
    they live, on their device), other leaves replaced."""
    return tree_map(lambda a, b: a.copy_(b) if isinstance(a, torch.Tensor)
                    else b, live, restored)


class _CancelGate:
    """Cancel flag whose check and the guarded action are mutually
    excluded: ``cancel()`` blocks while a holder is inside the lock, so a
    time-bounded caller that abandons a save either prevents the write
    entirely or waits for an already-started write to finish before
    closing the writer — never both racing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cancelled = False

    def cancel(self):
        with self._lock:
            self._cancelled = True

    @property
    def lock(self):
        return self._lock

    @property
    def cancelled(self) -> bool:
        return self._cancelled


class Supervisor:
    def __init__(self, is_chief: bool, logdir: str,
                 save_model_secs: int = 600, max_to_keep: int = 5,
                 background: bool = False,
                 final_save_timeout_s: float = 300.0,
                 exit_agreement_timeout_s: float = 60.0,
                 sharded_spanning: bool = True):
        """``final_save_timeout_s`` and ``exit_agreement_timeout_s`` bound
        the exit path's two collectives when the state is sharded over
        ranks (``run_bounded`` extends each 4x with a progress line
        before abandoning); ``sharded_spanning`` picks the sharded format
        for such state (True) over the gather-then-chief-writes
        monolithic one."""
        self.is_chief = is_chief
        self.logdir = logdir
        self.final_save_timeout_s = final_save_timeout_s
        self.exit_agreement_timeout_s = exit_agreement_timeout_s
        self.sharded_spanning = sharded_spanning
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
        adopted and the optimizer state starts fresh.

        The ladder re-scans a set that vanishes mid-read; the bounded
        retry here covers the one read it does not: the key scan of the
        params-only fallback, where a racing peer's GC can delete the set
        between selection and the scan. Three tries, so a sick directory
        still fails loudly."""
        for attempt in range(2):
            try:
                state, step = self._init_or_restore(init_state)
                break
            except FileNotFoundError as e:
                print(f"checkpoint vanished mid-restore (racing peer "
                      f"GC?): {e} — re-scanning (attempt "
                      f"{attempt + 1}/3)")
        else:
            # third and final attempt: an error here is the loud exit
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

    def checkpoint_coordinated(self, state, step: int,
                               attempt: str | None = None):
        """One coordinated checkpoint: EVERY rank calls this together (the
        loop's cadenced vote agreed on the step first; ``attempt`` is the
        per-save nonce that vote distributed, so two save attempts at one
        step never assemble into a mixed set)."""
        self._coordinated_save(state, step, final=False, attempt=attempt)

    def _coordinated_save(self, state, step: int, *, final: bool,
                          cancelled: _CancelGate | None = None,
                          attempt: str | None = None):
        """The ONE fetch-then-write gate, shared by the cadenced vote and
        the ``managed`` exit so the two cannot drift apart. A state sharded
        over ranks writes the sharded format by default: every rank its
        own file, no collective. Otherwise the chief flattens (a
        collective gather when the state is sharded, which the other
        ranks join) and writes; ``final`` picks the synchronous write over
        the background-capable one. ``cancelled`` is consulted between
        the fetch and the write under its lock: a bounded caller that
        abandoned this save either stops the write or waits for it."""
        fault_point("collective_fetch", step=step)
        if self.sharded_spanning and needs_collective_fetch(state):
            self.checkpointer.save_sharded(state, step, attempt=attempt)
            return
        if self.is_chief:
            flat = flatten_pytree(state)
            # between the fetch and the gated write: a mode=delay rule
            # here makes the fetch complete AFTER a bounded caller gave
            # up on it, the discard path below
            fault_point("cancel_gate", step=step)
            with (cancelled.lock if cancelled is not None
                  else contextlib.nullcontext()):
                if cancelled is not None and cancelled.cancelled:
                    print(f"final checkpoint fetch completed after its "
                          f"bound expired; discarding (step {step})")
                    return
                if final:
                    self.checkpointer.save_fetched(flat, step)
                else:
                    self.checkpointer.submit_fetched(flat, step)
        elif needs_collective_fetch(state):
            join_collective_fetch(state)

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
        that requested the stop) a final checkpoint of the last state the
        loop published with ``box.update``, synchronously, after any
        background write; then the writer thread stops.

        A replicated state is written by the chief. A state sharded over
        ranks is saved by every rank together, and first every rank —
        clean or unwinding an exception — joins one bounded agreement of
        the clean flags, which also carries the sharded save's attempt
        token: the save runs only when every rank is clean, so a mixed
        exit skips on every rank alike instead of stranding clean peers
        in a collective the failed rank never joins. A run whose exit
        protocol was abandoned (a peer never reached it) raises on an
        otherwise clean exit, so the process exits non-zero."""
        box = _StateBox(*self.init_or_restore(init_state))
        restore_signals = self._install_signal_handlers()
        clean_exit = False
        try:
            yield box
            clean_exit = True
        finally:
            restore_signals()
            abandoned = None
            needs = needs_collective_fetch(box.state)
            proceed, attempt = True, None
            if needs:
                verdict, attempt = agree_clean_exit(
                    clean_exit, timeout_s=self.exit_agreement_timeout_s,
                    return_token=True)
                if verdict is None:
                    proceed = False
                    abandoned = ("a peer process never reached the exit "
                                 "agreement (died hard?); final checkpoint "
                                 "skipped")
                    print(f"final checkpoint skipped: {abandoned} — dying "
                          f"loudly instead of hanging in the collective "
                          f"fetch")
                elif not verdict:
                    proceed = False
                    print("final checkpoint skipped: a process exited on "
                          "an error with state sharded over ranks (the "
                          "collective save needs every process at the "
                          "same point; all peers skip symmetrically)")
            if proceed and needs and not self.sharded_spanning:
                # the gather gets its own bound; the cancel gate keeps an
                # abandoned fetch that completes late from writing
                # through the checkpointer closed below
                gate = _CancelGate()
                done, err = run_bounded(
                    lambda: self._coordinated_save(box.state, box.step,
                                                   final=True,
                                                   cancelled=gate),
                    self.final_save_timeout_s,
                    what="final collective checkpoint")
                if not done:
                    gate.cancel()
                    abandoned = ("final checkpoint abandoned: a peer never "
                                 "joined the collective fetch")
                    print(f"{abandoned} — exiting loudly")
                elif isinstance(err, Exception):
                    print(f"final checkpoint failed: {err}")
            elif proceed and (self.is_chief or needs):
                try:
                    self._coordinated_save(box.state, box.step, final=True,
                                           attempt=attempt)
                except Exception as e:  # noqa: BLE001 — best-effort on exit
                    print(f"final checkpoint failed: {e}")
            self.checkpointer.close()
            self.request_stop()
            if abandoned and clean_exit:
                raise RuntimeError(abandoned)


class _StateBox:
    """Mutable holder so the loop can publish progress to the supervisor."""

    def __init__(self, state, step: int):
        self.state = state
        self.step = step

    def update(self, state, step: int):
        self.state = state
        self.step = step
