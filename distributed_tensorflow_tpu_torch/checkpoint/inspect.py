"""Checkpoint inspection CLI, the counterpart of
``distributed_tensorflow_tpu/checkpoint/inspect.py``.

    python -m distributed_tensorflow_tpu_torch.checkpoint.inspect --logdir /tmp/train_logs
    python -m distributed_tensorflow_tpu_torch.checkpoint.inspect --path ckpt-1000.npz --key params/weights/wd1
    python -m distributed_tensorflow_tpu_torch.checkpoint.inspect --verify --logdir /tmp/train_logs

Lists every stored array (path key, shape, dtype; bf16-tagged entries
decoded to float32), the global step and the total element count;
``--key`` also prints one array's statistics. ``--verify`` checks EVERY
set in a logdir, both formats, against its per-array CRC-32C manifest,
prints ok/CORRUPT/incomplete per step and exits 1 if the newest
restorable set is corrupt. Read-only; reads every layout either package
writes (full TrainState checkpoints and the ps mode's params-only ones).
The output lines and exit codes are the JAX package's.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (
    _MANIFEST,
    _MONO_RE,
    _scan_shards,
    latest_checkpoint,
    load_flat,
    load_flat_sharded,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    _BF16_TAG,
    _bf16_bits_to_f32,
)


def load_entries(path: str) -> dict[str, np.ndarray]:
    """{key: array} of one checkpoint (either format), bf16-tagged entries
    widened to float32 (exact) under their untagged key."""
    out = {}
    for k, arr in load_flat(path).items():
        if k.startswith(_BF16_TAG):
            k, arr = k[len(_BF16_TAG):], _bf16_bits_to_f32(arr)
        out[k] = arr
    return out


def describe(path: str, key: str | None = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    entries = load_entries(path)
    step = entries.get("step")
    print(f"checkpoint: {path}", file=out)
    if step is not None:
        print(f"global step: {int(np.asarray(step))}", file=out)
    total = 0
    for k in sorted(entries):
        if k == "step":
            continue
        a = entries[k]
        total += a.size
        print(f"  {k}  shape={tuple(a.shape)}  dtype={a.dtype}", file=out)
    print(f"total elements (excl. step): {total:,}", file=out)
    if key is not None:
        if key not in entries:
            print(f"error: no array {key!r} in checkpoint "
                  f"(keys: {sorted(entries)[:8]}...)", file=sys.stderr)
            return 2
        a = np.asarray(entries[key], np.float64)
        print(f"{key}: min={a.min():.6g} max={a.max():.6g} "
              f"mean={a.mean():.6g} std={a.std():.6g}", file=out)
    return 0


def verify_logdir(directory: str, out=None) -> int:
    """``--verify``: one line per (step, format) — ok, ok (no manifest),
    CORRUPT (reason) or incomplete (orphan shard files) — through the
    load paths restore uses. Returns 1 iff the newest restorable set,
    the one restore would pick first, is corrupt (or there is none)."""
    out = out if out is not None else sys.stdout
    if not os.path.isdir(directory):
        print(f"no such directory: {directory}", file=sys.stderr)
        return 1
    complete, all_shards = _scan_shards(directory)
    mono: dict[int, str] = {}
    for name in os.listdir(directory):
        m = _MONO_RE.fullmatch(name)
        if m:
            mono[int(m.group(1))] = os.path.join(directory, name)
    quarantined = [n for n in os.listdir(directory) if ".corrupt" in n]
    steps = sorted(set(mono) | set(complete) | set(all_shards))
    if not steps:
        print(f"no checkpoints in {directory}", file=out)
        return 1
    restorable = sorted(set(mono) | set(complete))
    newest = restorable[-1] if restorable else None
    newest_ok = True
    for step in steps:
        if step in mono:
            try:
                with np.load(mono[step]) as z:
                    has_manifest = _MANIFEST in z.files
                load_flat(mono[step])
                status = "ok" if has_manifest else "ok (no manifest)"
            except Exception as e:  # noqa: BLE001 — reported per set
                status = f"CORRUPT ({type(e).__name__}: {e})"
                if step == newest:
                    newest_ok = False
            print(f"step {step} [monolithic]: {status}", file=out)
        if step in complete:
            try:
                load_flat_sharded(directory, step)
                status = "ok"
            except Exception as e:  # noqa: BLE001 — reported per set
                status = f"CORRUPT ({type(e).__name__}: {e})"
                if step == newest and step not in mono:
                    newest_ok = False
            print(f"step {step} [sharded x{len(complete[step])}]: {status}",
                  file=out)
        elif step in all_shards and step not in mono:
            print(f"step {step} [sharded]: incomplete "
                  f"({len(all_shards[step])} orphan shard file(s), no "
                  f"complete set)", file=out)
    if quarantined:
        print(f"{len(quarantined)} quarantined *.corrupt file(s) present",
              file=out)
    if not newest_ok:
        print(f"newest restorable set (step {newest}) is CORRUPT — "
              f"restore would quarantine it and fall back", file=out)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Inspect a distributed_tensorflow_tpu checkpoint")
    p.add_argument("--logdir", help="checkpoint directory (inspects the "
                   "latest checkpoint, like restore does)")
    p.add_argument("--path", help="a specific ckpt-N.npz file")
    p.add_argument("--key", help="also print statistics of this array")
    p.add_argument("--verify", action="store_true",
                   help="checksum-check EVERY set in --logdir (both "
                   "formats); nonzero exit if the newest restorable set "
                   "is corrupt")
    args = p.parse_args(argv)
    if args.verify:
        if not args.logdir:
            p.error("--verify requires --logdir")
        return verify_logdir(args.logdir)
    if bool(args.logdir) == bool(args.path):
        p.error("exactly one of --logdir / --path is required")
    path = args.path
    if args.logdir:
        found = latest_checkpoint(args.logdir)
        if found is None:
            print(f"no checkpoint found in {args.logdir}", file=sys.stderr)
            return 1
        path = found[0]
    return describe(path, args.key)


if __name__ == "__main__":
    sys.exit(main())
