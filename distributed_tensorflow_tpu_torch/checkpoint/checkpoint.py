"""Checkpoints in the JAX package's on-disk formats.

The counterpart of ``distributed_tensorflow_tpu/checkpoint/checkpoint.py``:
a nested state flattens to path-keyed arrays in one ``ckpt-{step}.npz`` per
step, with a ``__manifest__`` entry holding each array's CRC-32C, written
atomically (tmp + fsync + rename + directory fsync). An index file records
the latest step and old steps are garbage-collected past ``max_to_keep``.

Restore walks the same verify-quarantine-fallback ladder: the newest step
whose arrays pass their CRCs restores; a damaged set is renamed to
``*.corrupt`` and the next older one is tried. A file written by either
package restores in the other. ``Checkpointer`` is the Supervisor's
time-cadenced, chief-only writer; with ``background=True``
(``--async_checkpoint``) its cadenced writes run on a writer thread.

The sharded format (one file per process, ``ckpt-{step}.shardP-of-N``,
written by the JAX package for cross-host-sharded state) is read here:
every reader takes a complete set and reassembles the same flat dict a
monolithic file loads to. This package does not write it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
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
# the optional 8-hex nonce names the save attempt, so shard files of two
# attempts at the same (step, n) never assemble into one set
_SHARD_RE = re.compile(
    rf"{_PREFIX}-(\d+)\.shard(\d+)-of-(\d+)(?:\.([0-9a-f]{{8}}))?\.npz")
_SHARDMETA = "__shardmeta__"
_SHARD_FORMAT_VERSION = 1


class CheckpointCorruptError(ValueError):
    """A checkpoint that is present but fails integrity verification (CRC
    mismatch, truncated file, torn shard meta, overlapping or gapped
    slice coverage). ``restore_with_fallback`` quarantines the set and
    falls back; every other reader stays loud."""


class CheckpointFormatError(ValueError):
    """An intact checkpoint this build cannot read (a shard format version
    from a newer build). Never quarantined."""


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
    return _write_flat(directory, flatten_pytree(state), step, max_to_keep)


def _write_flat(directory: str, flat: dict[str, np.ndarray], step: int,
                max_to_keep: int) -> str:
    """The host half of a save: atomic npz write, index and GC of an
    already-fetched flat dict. Touches no device, so a writer thread can
    run it."""
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


def _scan_shards(directory: str) -> tuple[dict[int, list[str]],
                                          dict[int, list[str]]]:
    """One directory pass over shard files: ``(complete, all_by_step)``.
    ``complete[step]`` is the paths of the newest complete set at that
    step, completeness keyed by (step, n_shards, attempt) so sets of two
    save attempts never merge; ``all_by_step[step]`` is every shard file
    at that step, complete or orphaned (GC's view)."""
    by_key: dict[tuple[int, int, str], dict[int, str]] = {}
    all_by_step: dict[int, list[str]] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return {}, {}
    for name in names:
        m = _SHARD_RE.fullmatch(name)
        if m:
            step, p, n = int(m.group(1)), int(m.group(2)), int(m.group(3))
            path = os.path.join(directory, name)
            by_key.setdefault((step, n, m.group(4) or ""), {})[p] = path
            all_by_step.setdefault(step, []).append(path)
    complete: dict[int, tuple[float, list[str]]] = {}
    for (step, n, _attempt), by_p in by_key.items():
        if len(by_p) == n and all(i in by_p for i in range(n)):
            paths = [by_p[i] for i in range(n)]
            try:
                mtime = max(os.path.getmtime(p) for p in paths)
            except OSError:
                continue  # a racing GC deleted part of the set
            if step not in complete or mtime > complete[step][0]:
                complete[step] = (mtime, paths)
    return {s: paths for s, (_, paths) in complete.items()}, all_by_step


def _sharded_steps(directory: str) -> dict[int, list[str]]:
    """{step: [shard paths]} for the steps with a complete shard set."""
    return _scan_shards(directory)[0]


def _read_shard_meta(z, path: str) -> dict:
    try:
        meta = json.loads(bytes(z[_SHARDMETA]).decode())
    except KeyError:
        raise CheckpointCorruptError(
            f"{path}: no {_SHARDMETA} entry — not a shard file, or "
            f"torn") from None
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path}: shard meta does not decode ({e})") from None
    if meta.get("version") != _SHARD_FORMAT_VERSION:
        raise CheckpointFormatError(
            f"{path}: sharded-checkpoint format version "
            f"{meta.get('version')} (this build reads "
            f"{_SHARD_FORMAT_VERSION})")
    return meta


def load_flat_sharded(directory: str, step: int) -> dict[str, np.ndarray]:
    """Reassemble the complete shard set at ``step`` into the flat dict a
    monolithic file loads to (bf16 leaves under their ``__bf16__`` tag as
    uint16 bits), each shard's arrays CRC-checked, each leaf's slices
    checked to cover it exactly once."""
    paths = _sharded_steps(directory).get(step)
    if not paths:
        raise FileNotFoundError(
            f"no complete sharded checkpoint at step {step} in "
            f"{directory!r}")
    parts: dict[str, dict] = {}
    for path in paths:
        with np.load(path) as z:
            meta = _read_shard_meta(z, path)
            for k, want in (meta.get("crc32c") or {}).items():
                if k not in z.files:
                    raise CheckpointCorruptError(
                        f"{path}: manifest lists {k!r} but the array is "
                        f"absent")
                got = crc32c(np.ascontiguousarray(z[k]))
                if got != want:
                    raise CheckpointCorruptError(
                        f"{path}: CRC-32C mismatch for {k!r} (stored "
                        f"{want:#010x}, computed {got:#010x})")
            for key, info in meta["leaves"].items():
                dst = parts.setdefault(key, {
                    "global_shape": tuple(info["global_shape"]),
                    "entries": []})
                for e in info["entries"]:
                    dst["entries"].append((e["index"], z[e["npz"]],
                                           e["bf16"]))
    flat: dict[str, np.ndarray] = {}
    for key, info in parts.items():
        entries = info["entries"]
        if not entries:
            raise ValueError(f"sharded checkpoint step {step}: no data for "
                             f"leaf {key!r}")
        out = np.zeros(info["global_shape"], dtype=entries[0][1].dtype)
        # a positional coverage mask: overlap and gap each fail loudly
        mask = np.zeros(info["global_shape"], dtype=bool)
        for spec, data, _ in entries:
            sl = tuple(slice(s, e) for s, e in spec)
            if mask[sl].any():
                raise CheckpointCorruptError(
                    f"sharded checkpoint step {step}: leaf {key!r} has "
                    f"overlapping entries at {spec} — set mixes save "
                    f"attempts")
            out[sl] = data
            mask[sl] = True
        if not mask.all():
            raise CheckpointCorruptError(
                f"sharded checkpoint step {step}: leaf {key!r} covers "
                f"{int(mask.sum())} of {out.size} elements — set "
                f"incomplete")
        flat[(_BF16_TAG + key) if entries[0][2] else key] = out
    return flat


def _all_steps(directory: str) -> list[int]:
    """Restorable steps: monolithic files and complete shard sets."""
    return sorted(set(_mono_steps(directory)) | set(_sharded_steps(directory)))


def _gc(directory: str, max_to_keep: int) -> None:
    """Delete the files of steps older than the newest ``max_to_keep``
    restorable ones, both formats, and orphaned shard files strictly
    older than the oldest kept step (none while no step is restorable:
    an orphan then may be a peer's first save in progress). Quarantined
    ``*.corrupt`` files match no scan and are kept."""
    complete, all_shards = _scan_shards(directory)
    mono = set(_mono_steps(directory))
    restorable = sorted(mono | set(complete))
    keep = set(restorable[-max_to_keep:])
    horizon = min(keep) if keep else None
    doomed = []
    for s in restorable:
        if s not in keep:
            doomed += ([os.path.join(directory, f"{_PREFIX}-{s}.npz")]
                       + all_shards.get(s, []))
    for s, paths in all_shards.items():
        if not (s in complete or s in mono or horizon is None
                or s >= horizon):
            doomed += paths
    for path in doomed:
        try:
            os.unlink(path)
        except OSError:
            pass


def _step_available(directory: str, step: int) -> str | None:
    """The path that represents a restorable ``step``: the monolithic
    file, or the shard-0 file of a complete set."""
    p = os.path.join(directory, f"{_PREFIX}-{step}.npz")
    if os.path.exists(p):
        return p
    shard_set = _sharded_steps(directory).get(step)
    return shard_set[0] if shard_set else None


def latest_checkpoint(directory: str) -> tuple[str, int] | None:
    """(path, step) of the newest restorable checkpoint, or None; for a
    shard set the path is its shard-0 file (read it through
    ``load_flat``). Selection is a directory scan; the index file is
    written for tooling but not trusted, since a crash between the file
    and the index write would hide the newer file."""
    if not os.path.isdir(directory):
        return None
    for step in reversed(_all_steps(directory)):
        p = _step_available(directory, step)
        if p is not None:
            return p, step
    return None


def checkpoint_keys(path: str) -> set[str]:
    """The stored array keys (bf16 tags kept, manifest dropped), read
    without loading the arrays; for a shard file, the keys of its whole
    set."""
    m = _SHARD_RE.fullmatch(os.path.basename(path))
    if not m:
        with np.load(path) as z:
            return set(z.files) - {_MANIFEST}
    shards = _sharded_steps(os.path.dirname(path) or ".").get(
        int(m.group(1)))
    if not shards:
        # the set vanished after it was picked: unreadable is not "no keys"
        raise FileNotFoundError(
            f"sharded checkpoint set for {path!r} is no longer complete")
    keys: set[str] = set()
    for shard in shards:
        with np.load(shard) as z:
            for key, info in _read_shard_meta(z, shard)["leaves"].items():
                bf16 = any(e["bf16"] for e in info["entries"])
                keys.add((_BF16_TAG + key) if bf16 else key)
    return keys


def load_flat(path: str) -> dict[str, np.ndarray]:
    """Flat path-keyed arrays of either format: a monolithic file,
    CRC-verified when it carries a manifest, or any shard file of a
    complete set, reassembled (``load_flat_sharded``)."""
    m = _SHARD_RE.fullmatch(os.path.basename(path))
    if m:
        return load_flat_sharded(os.path.dirname(path) or ".",
                                 int(m.group(1)))
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
    """Quarantine every restorable file of ``step``: the monolithic file
    and the complete shard set. Returns the new paths."""
    paths = []
    mono = os.path.join(directory, f"{_PREFIX}-{step}.npz")
    if os.path.exists(mono):
        paths.append(mono)
    paths += _sharded_steps(directory).get(step, [])
    return _quarantine_paths(paths)


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
      - corruption (CRC mismatch, torn or zero-length file, a shard set
        whose slices overlap or leave a gap): the set is renamed to
        ``*.corrupt`` and the ladder goes one rung down.
      - structural mismatch with ``template`` (missing key, wrong shape):
        loud, immediately.

    Returns ``(state, step, RestoreReport)``, or None when the directory
    holds no checkpoint. Raises CheckpointCorruptError when sets existed
    but every one was quarantined. ``subtree`` restricts the unflatten to
    one top-level field; the CRC check still covers the whole set."""
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
            if not moved and _step_available(directory, step) is not None:
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


def background_save_from_flags(FLAGS) -> bool:
    """The one flag-to-feature mapping for ``--async_checkpoint`` (False
    for a caller without the flag)."""
    return bool(getattr(FLAGS, "async_checkpoint", False))


def max_to_keep_from_flags(FLAGS) -> int:
    """The one flag-to-feature mapping for ``--max_to_keep``."""
    return int(FLAGS.max_to_keep)


def _host_snapshot(state) -> dict[str, np.ndarray]:
    """``state`` flattened into arrays that own their memory: a tensor on
    the CPU flattens to a view of itself, which the next step would
    write in place under the writer thread."""
    return {k: np.array(v) for k, v in flatten_pytree(state).items()}


class Checkpointer:
    """Time-cadenced, chief-only checkpointing (Supervisor parity).

    ``maybe_save`` is called every loop iteration; it writes only when
    ``save_model_secs`` have elapsed since the last save
    (MNISTDist.py:165; 0 turns the cadence off) and only on the chief
    (``:159``). ``save`` forces a synchronous write (the exit path).

    With ``background=True`` a cadenced save fetches the state to host on
    the calling thread (ordered with the device's work; a CUDA graph
    replay or an in-place update would otherwise change it under the
    writer), then hands the arrays to one writer thread for the
    serialization, atomic rename and GC. At most one save waits: a newer
    snapshot replaces one that has not started (latest wins). A failed
    background write raises on the next ``maybe_save`` or ``wait``; the
    forced ``save`` drains pending writes first, so the index always
    ends at the newest step."""

    def __init__(self, directory: str, is_chief: bool = True,
                 save_model_secs: int = 600, max_to_keep: int = 5,
                 background: bool = False):
        self.directory = directory
        self.is_chief = is_chief
        self.save_model_secs = save_model_secs
        self.max_to_keep = max_to_keep
        self.background = background
        self._last_save = time.time()
        self._cv = threading.Condition()
        self._pending: tuple | None = None
        self._busy = False
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._closed = False
        self.last_restore_report: RestoreReport | None = None

    def cadence_due(self) -> bool:
        return (self.is_chief and self.save_model_secs > 0
                and time.time() - self._last_save >= self.save_model_secs)

    def maybe_save(self, state, step: int) -> str | None:
        """The path of a checkpoint written now, else None. In background
        mode the write completes later (or is superseded by a newer one),
        so no path is promised; ``wait()`` then ``latest_checkpoint``
        observe it."""
        if not self.cadence_due():
            return None
        if self.background:
            self._submit(_host_snapshot(state), step)
            self._last_save = time.time()
            return None
        return self.save(state, step)

    def save(self, state, step: int) -> str | None:
        """Forced synchronous write; None on a non-chief. Drains a pending
        background write first so an older step never lands after it."""
        if not self.is_chief:
            return None
        self._drain()
        with self._cv:
            prev_error, self._error = self._error, None
        if prev_error is not None:
            # superseded by this save: report it, do not fail the save
            print(f"note: a background checkpoint write had failed: "
                  f"{prev_error}")
        path = save_checkpoint(self.directory, state, step, self.max_to_keep)
        self._last_save = time.time()
        return path

    def wait(self):
        """Block until no background write is pending or running; raise if
        one failed."""
        self._drain()
        self._raise_pending_error()

    def close(self):
        """Stop the writer thread after it drained. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                # the atomic rename keeps the previous checkpoint valid
                print("warning: checkpoint writer still busy after 60s; "
                      "an in-flight write may not complete")
            else:
                self._thread = None

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

    # --- the writer thread ---

    def _submit(self, flat: dict[str, np.ndarray], step: int):
        self._raise_pending_error()
        with self._cv:
            if self._closed:
                raise RuntimeError("Checkpointer is closed")
            self._pending = (flat, step)  # replaces an unstarted older save
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer_loop, name="checkpoint-writer",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _writer_loop(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None:
                    return  # closed and drained
                (flat, step), self._pending = self._pending, None
                self._busy = True
            try:
                _write_flat(self.directory, flat, step, self.max_to_keep)
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _drain(self):
        with self._cv:
            while self._pending is not None or self._busy:
                self._cv.wait()

    def _raise_pending_error(self):
        with self._cv:
            e, self._error = self._error, None
        if e is not None:
            raise RuntimeError(f"background checkpoint write failed: {e}") \
                from e
