"""Checkpoints in the JAX package's monolithic on-disk format.

The counterpart of ``distributed_tensorflow_tpu/checkpoint/checkpoint.py``:
a nested state flattens to path-keyed arrays in one ``ckpt-{step}.npz`` per
step, with a ``__manifest__`` entry holding each array's CRC-32C, written
atomically (tmp + fsync + rename + directory fsync). An index file records
the latest step and old steps are garbage-collected past ``max_to_keep``.

Restore walks the same verify-quarantine-fallback ladder: the newest step
whose arrays pass their CRCs restores; a damaged set is renamed to
``*.corrupt`` and the next older one is tried. A file written by either
package restores in the other. ``Checkpointer`` is the Supervisor's
time-cadenced, chief-only writer; its background-thread mode
(``--async_checkpoint``) is not ported, so every save is synchronous.

The sharded format (one file per process, ``ckpt-{step}.shardP-of-N``) is
not ported yet: a directory holding one raises
``ShardedCheckpointNotPorted``.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
import zipfile
from dataclasses import dataclass

import numpy as np

from distributed_tensorflow_tpu_torch.utils.events import crc32c
from distributed_tensorflow_tpu_torch.utils.pytree import (
    _BF16_TAG,
    flatten_pytree,
    unflatten_pytree,
)

_INDEX = "checkpoint"  # index filename, same as TF's
_PREFIX = "ckpt"
_MANIFEST = "__manifest__"
_MANIFEST_VERSION = 1
_MONO_RE = re.compile(rf"{_PREFIX}-(\d+)\.npz")
_MAX_RESCANS = 3  # re-scans after a set vanishes mid-read (racing delete)
_SHARD_RE = re.compile(
    rf"{_PREFIX}-(\d+)\.shard(\d+)-of-(\d+)(?:\.([0-9a-f]{{8}}))?\.npz")


class CheckpointCorruptError(ValueError):
    """A checkpoint that is present but fails integrity verification (CRC
    mismatch, truncated file). ``restore_with_fallback`` quarantines the
    set and falls back; every other reader stays loud."""


class CheckpointFormatError(ValueError):
    """An intact checkpoint this build cannot read. Never quarantined."""


class ShardedCheckpointNotPorted(CheckpointFormatError):
    """The directory holds the sharded format, which this package does not
    read yet."""


def _fsync_dir(directory: str) -> None:
    """fsync the directory entry so a rename survives a machine crash.
    Best-effort: platforms that cannot open a directory skip it."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def _atomic_npz(directory: str, final: str, arrays: dict) -> None:
    """tmp + fsync + rename + dir-fsync: neither a killed process nor a
    machine crash leaves a torn or zero-length "complete" file."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        _fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _manifest_entry(flat: dict[str, np.ndarray]) -> np.ndarray:
    """The JSON manifest stored beside the arrays: per-key CRC-32C of the
    raw array bytes."""
    crcs = {k: crc32c(np.ascontiguousarray(v)) for k, v in flat.items()}
    blob = json.dumps({"version": _MANIFEST_VERSION, "crc32c": crcs})
    return np.frombuffer(blob.encode(), dtype=np.uint8)


def _verify_flat(path: str, flat: dict[str, np.ndarray],
                 manifest: dict | None) -> None:
    """CRC-check ``flat`` against a parsed manifest; None (a file saved
    before manifests existed) verifies nothing."""
    if manifest is None:
        return
    crcs = manifest.get("crc32c", {})
    missing = set(crcs) - set(flat)
    if missing:
        raise CheckpointCorruptError(
            f"{path}: manifest lists {sorted(missing)} but the arrays are "
            f"absent — file truncated or mixed")
    for k, v in flat.items():
        want = crcs.get(k)
        if want is None:
            raise CheckpointCorruptError(
                f"{path}: array {k!r} is not covered by the manifest")
        got = crc32c(np.ascontiguousarray(v))
        if got != want:
            raise CheckpointCorruptError(
                f"{path}: CRC-32C mismatch for {k!r} "
                f"(stored {want:#010x}, computed {got:#010x}) — bit rot "
                f"or a torn write")


def save_checkpoint(directory: str, state, step: int,
                    max_to_keep: int = 5) -> str:
    """Atomic write of ``state`` (nested dicts of tensors or arrays) at
    ``step``; returns the checkpoint path."""
    flat = flatten_pytree(state)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_PREFIX}-{step}.npz")
    _atomic_npz(directory, final, {**flat, _MANIFEST: _manifest_entry(flat)})
    _write_index(directory, step)
    _gc(directory, max_to_keep)
    return final


def _write_index(directory: str, step: int) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump({"latest_step": step, "time": time.time()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, _INDEX))
    _fsync_dir(directory)


def _mono_steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for m in map(_MONO_RE.fullmatch,
                                               os.listdir(directory)) if m)


def _all_steps(directory: str) -> list[int]:
    """Restorable steps. Raises on a sharded set rather than silently
    serving an older monolithic step behind it."""
    names = os.listdir(directory)
    shards = [n for n in names if _SHARD_RE.fullmatch(n)]
    if shards:
        raise ShardedCheckpointNotPorted(
            f"{directory!r} holds sharded checkpoints ({shards[0]}, ...); "
            f"sharded checkpoints are not yet ported to "
            f"distributed_tensorflow_tpu_torch — restore them with the JAX "
            f"package or re-save them monolithic")
    return _mono_steps(directory)


def _gc(directory: str, max_to_keep: int) -> None:
    """Delete monolithic files older than the newest ``max_to_keep``.
    Quarantined ``*.corrupt`` files match no scan and are kept."""
    for s in _mono_steps(directory)[:-max_to_keep]:
        try:
            os.unlink(os.path.join(directory, f"{_PREFIX}-{s}.npz"))
        except OSError:
            pass


def _step_path(directory: str, step: int) -> str | None:
    p = os.path.join(directory, f"{_PREFIX}-{step}.npz")
    return p if os.path.exists(p) else None


def latest_checkpoint(directory: str) -> tuple[str, int] | None:
    """(path, step) of the newest checkpoint, or None. Selection is a
    directory scan; the index file is written for tooling but not
    trusted, since a crash between the file and the index write would
    hide the newer file."""
    if not os.path.isdir(directory):
        return None
    for step in reversed(_all_steps(directory)):
        p = _step_path(directory, step)
        if p is not None:
            return p, step
    return None


def checkpoint_keys(path: str) -> set[str]:
    """The stored array keys of one monolithic file (bf16 tags kept,
    manifest dropped), read without loading the arrays."""
    if _SHARD_RE.fullmatch(os.path.basename(path)):
        raise ShardedCheckpointNotPorted(
            f"{path}: sharded checkpoints are not yet ported to "
            f"distributed_tensorflow_tpu_torch")
    with np.load(path) as z:
        return set(z.files) - {_MANIFEST}


def load_flat(path: str) -> dict[str, np.ndarray]:
    """Flat path-keyed arrays of one monolithic file, CRC-verified when it
    carries a manifest."""
    if _SHARD_RE.fullmatch(os.path.basename(path)):
        raise ShardedCheckpointNotPorted(
            f"{path}: sharded checkpoints are not yet ported to "
            f"distributed_tensorflow_tpu_torch")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    manifest = None
    raw = flat.pop(_MANIFEST, None)
    if raw is not None:
        try:
            manifest = json.loads(bytes(raw).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"{path}: manifest does not decode ({e})") from None
    _verify_flat(path, flat, manifest)
    return flat


@dataclass
class RestoreReport:
    """Where a restore's state came from and what it cost to get it."""

    step: int | None = None
    path: str | None = None
    fallback_depth: int = 0  # older sets walked to
    quarantined: tuple[str, ...] = ()
    rescans: int = 0
    time_s: float = 0.0


def _is_corrupt_error(e: BaseException) -> bool:
    """Decode-phase errors that mean this set is damaged (quarantine and
    fall back). Never FileNotFoundError (a racing delete: re-scan) and
    never CheckpointFormatError (an intact file: stay loud)."""
    if isinstance(e, (FileNotFoundError, CheckpointFormatError)):
        return False
    return isinstance(e, (CheckpointCorruptError, zipfile.BadZipFile,
                          EOFError, ValueError))


def _quarantine_paths(paths: list[str]) -> list[str]:
    """Rename each file to ``*.corrupt`` (suffix-numbered on collision),
    out of every scan, kept for postmortem."""
    moved = []
    for p in paths:
        dst = p + ".corrupt"
        i = 1
        while os.path.exists(dst):
            dst = f"{p}.corrupt{i}"
            i += 1
        try:
            os.replace(p, dst)
            moved.append(dst)
        except OSError:
            pass  # vanished under us — nothing to quarantine
    return moved


def quarantine_step(directory: str, step: int) -> list[str]:
    """Quarantine the file representing ``step``; returns the new paths."""
    p = _step_path(directory, step)
    return _quarantine_paths([p] if p else [])


def _select_subtree(flat: dict[str, np.ndarray],
                    subtree: str) -> dict[str, np.ndarray]:
    """The flat keys under one top-level field of the stored state, the
    field prefix stripped (bf16 tags kept) — how the serving engine
    restores the params of a full TrainState checkpoint."""
    prefix = subtree + "/"
    tagged = _BF16_TAG + prefix
    out = {}
    for k, v in flat.items():
        if k.startswith(prefix):
            out[k[len(prefix):]] = v
        elif k.startswith(tagged):
            out[_BF16_TAG + k[len(tagged):]] = v
        elif k == subtree:
            out[""] = v
        elif k == _BF16_TAG + subtree:
            out[_BF16_TAG] = v
    return out


def restore_params_with_fallback(directory: str, params_template):
    """``restore_with_fallback`` against only the ``params`` field of the
    stored state. Returns (params, step, RestoreReport) or None."""
    return restore_with_fallback(directory, params_template,
                                 subtree="params")


def restore_with_fallback(directory: str, template, *,
                          subtree: str | None = None):
    """The restore ladder: newest checkpoint first, walking back whenever
    the pick is damaged.

      - FileNotFoundError mid-read (a racing delete): re-scan, at most
        ``_MAX_RESCANS`` times; nothing is quarantined.
      - corruption (CRC mismatch, torn or zero-length file): the set is
        renamed to ``*.corrupt`` and the ladder goes one rung down.
      - structural mismatch with ``template`` (missing key, wrong shape):
        loud, immediately.

    Returns ``(state, step, RestoreReport)``, or None when the directory
    holds no checkpoint. Raises CheckpointCorruptError when sets existed
    but every one was quarantined. ``subtree`` restricts the unflatten to
    one top-level field; the CRC check still covers the whole file."""
    t0 = time.monotonic()
    depth = 0
    rescans = 0
    quarantined: list[str] = []
    while True:
        found = latest_checkpoint(directory)
        if found is None:
            if quarantined:
                raise CheckpointCorruptError(
                    f"no restorable checkpoint left in {directory!r}: "
                    f"every set failed verification; quarantined "
                    f"{quarantined}")
            return None
        path, step = found
        try:
            flat = load_flat(path)
        except FileNotFoundError:
            rescans += 1
            if rescans > _MAX_RESCANS:
                raise
            depth += 1
            continue
        except Exception as e:  # noqa: BLE001 — decode phase, classified
            if not _is_corrupt_error(e):
                raise
            moved = quarantine_step(directory, step)
            quarantined += moved
            depth += 1
            print(f"checkpoint at step {step} failed verification "
                  f"({type(e).__name__}: {e}); quarantined {len(moved)} "
                  f"file(s) to *.corrupt — falling back to the "
                  f"next-older checkpoint")
            if not moved and _step_path(directory, step) is not None:
                raise  # could not rename: re-looping would spin here
            continue
        if subtree is not None:
            flat = _select_subtree(flat, subtree)
        try:
            state = unflatten_pytree(template, flat)
        except KeyError as e:
            raise KeyError(f"checkpoint {path}: {e}") from None
        return state, step, RestoreReport(
            step=step, path=path, fallback_depth=depth,
            quarantined=tuple(quarantined), rescans=rescans,
            time_s=time.monotonic() - t0)


def max_to_keep_from_flags(FLAGS) -> int:
    """The one flag-to-feature mapping for ``--max_to_keep``."""
    return int(FLAGS.max_to_keep)


class Checkpointer:
    """Time-cadenced, chief-only checkpointing (Supervisor parity).

    ``maybe_save`` is called every loop iteration; it writes only when
    ``save_model_secs`` have elapsed since the last save
    (MNISTDist.py:165; 0 turns the cadence off) and only on the chief
    (``:159``). ``save`` forces a write (the exit path). Writes are
    synchronous on the calling thread."""

    def __init__(self, directory: str, is_chief: bool = True,
                 save_model_secs: int = 600, max_to_keep: int = 5):
        self.directory = directory
        self.is_chief = is_chief
        self.save_model_secs = save_model_secs
        self.max_to_keep = max_to_keep
        self._last_save = time.time()
        self.last_restore_report: RestoreReport | None = None

    def cadence_due(self) -> bool:
        return (self.is_chief and self.save_model_secs > 0
                and time.time() - self._last_save >= self.save_model_secs)

    def maybe_save(self, state, step: int) -> str | None:
        """The path of a checkpoint written now, else None."""
        if not self.cadence_due():
            return None
        return self.save(state, step)

    def save(self, state, step: int) -> str | None:
        """Forced write; None on a non-chief."""
        if not self.is_chief:
            return None
        path = save_checkpoint(self.directory, state, step, self.max_to_keep)
        self._last_save = time.time()
        return path

    def restore(self, template):
        """Verified restore through the fallback ladder; the RestoreReport
        lands in ``last_restore_report``. (state, step) or None."""
        out = restore_with_fallback(self.directory, template)
        if out is None:
            self.last_restore_report = None
            return None
        state, step, report = out
        self.last_restore_report = report
        return state, step
