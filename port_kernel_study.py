#!/usr/bin/env python3
"""Launch and tree studies of the port's CUDA kernel on one NVIDIA GPU
(an H100).

    python3 port_kernel_study.py sweep       # launch configurations at large M
    python3 port_kernel_study.py trees DIR   # this tree's kernel against DIR's

``sweep`` times the kernel as it is over (M tile, cluster) launches that
``launch_config`` may pick between, after checking each against the plain
version and a repeat call. ``trees`` times the wrapper
``fused_dense_relu`` of another checkout of the repo (DIR, for example the
parent commit unpacked with ``git archive``) and of this one, in the
order DIR, this, this, DIR, each in its own process, at the shapes of
this ``chip_smoke.py``, beside the plain version and ``torch.addmm`` +
``relu_``, and prints each tree's mean. Times are per call, from CUDA events
around a CUDA graph of many calls over rotating buffers larger than L2
(``chip_smoke.graph_ms``); in ``sweep`` each is the least of two such
graphs. Needs a card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from distributed_tensorflow_tpu_torch.ops import fused_dense as fd

# (dtype, M) -> (M tile, cluster) launches for ``sweep``
SWEEP = {("f32", 128): [(32, 2), (64, 4), (32, 4), (16, 2), (64, 2)],
         ("f32", 256): [(64, 2), (64, 4), (32, 2), (32, 1), (64, 1)],
         ("bf16", 128): [(128, 8), (128, 4), (64, 4), (64, 8)],
         ("bf16", 256): [(128, 4), (128, 2), (128, 8), (64, 2), (64, 4)]}


def say(line: str) -> None:
    print(line, flush=True)


def launcher(lib, dtype, block_m: int, cluster: int):
    def fn(x, w, b):
        m, k = x.shape
        n = w.shape[1]
        out = torch.empty((m, n), dtype=dtype, device="cuda")
        err = lib.fused_dense_relu_launch(
            fd._DTYPE_CODE[dtype], 0, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), m, n, k, block_m, cluster, 0,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return out
    return fn


def rotating(shape, dtype):
    one = cs.inputs(shape, dtype, seed=1, device="cpu")
    per_call = sum(t.numel() for t in one) * one[0].element_size()
    n_buf = max(1, min(64, math.ceil(2 * cs.L2_BYTES / per_call)))
    bufs = [tuple(t.cuda() for t in cs.inputs(shape, dtype, seed=i))
            for i in range(n_buf)]
    return bufs, max(100, n_buf)


def checked_us(fns: dict, bufs, reps, tag) -> dict:
    """Each launcher's time in µs (least of two graphs, taken in turns),
    after checking it against the plain version and a repeat call."""
    ref = fd.fused_dense_relu_reference(*bufs[0])
    for name, fn in fns.items():
        got = fn(*bufs[0])
        if not (torch.allclose(got.float(), ref.float(), **cs.KERNEL_TOL[tag])
                and torch.equal(got, fn(*bufs[0]))):
            raise AssertionError(f"{name} disagrees with the plain version")
    times = {name: [] for name in fns}
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            times[name].append(cs.graph_ms(fns[name], bufs, reps) * 1e3)
    return {name: min(t) for name, t in times.items()}


def run_sweep() -> None:
    lib = fd._library()
    for (tag, m), cfgs in SWEEP.items():
        dtype = cs.DTYPES[tag]
        shape = (m, 3136, 1024)
        pick = fd.launch_config(m, 1024, 3136, dtype, 0, 0, fd.sm_count(0))
        bufs, reps = rotating(shape, dtype)
        us = checked_us({f"{bm}x64/c{c}": launcher(lib, dtype, bm, c)
                         for bm, c in cfgs}, bufs, reps, tag)
        say(f"sweep {tag} {shape} (launch_config: {pick.block_m}x64/c"
            f"{pick.cluster}): " + " | ".join(f"{name} {t:.2f} us"
                                              for name, t in us.items()))
        del bufs


# One tree's times, in a process of its own: TREE's package is imported
# first on the path, with this tree's chip_smoke.py for shapes and timing.
TREE_CHILD = r"""
import importlib.util, json, math, sys
tree, smoke = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("smoke", smoke)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from distributed_tensorflow_tpu_torch.ops import _build, fused_dense
assert fused_dense.__file__.startswith(tree), fused_dense.__file__
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
rows = []
for tag, dtype in cs.DTYPES.items():
    for shape in cs.SHAPES:
        one = cs.inputs(shape, dtype, seed=1, device="cpu")
        per_call = sum(t.numel() for t in one) * one[0].element_size()
        n_buf = max(1, min(64, math.ceil(2 * cs.L2_BYTES / per_call)))
        bufs = [tuple(t.cuda() for t in cs.inputs(shape, dtype, seed=i))
                for i in range(n_buf)]
        reps = max(100, n_buf)
        got = fused_dense.fused_dense_relu(*bufs[0])
        ref = fused_dense.fused_dense_relu_reference(*bufs[0])
        assert torch.allclose(got.float(), ref.float(), **cs.KERNEL_TOL[tag])
        rows.append({"tag": tag, "shape": list(shape),
                     "ms": cs.graph_ms(fused_dense.fused_dense_relu, bufs, reps),
                     "plain_ms": cs.graph_ms(fused_dense.fused_dense_relu_reference, bufs, reps),
                     "library_ms": cs.graph_ms(cs.library_call, bufs, reps)})
        del bufs
print("ROWS " + json.dumps(rows))
"""


def run_trees(other: str) -> None:
    here = str(Path(__file__).resolve().parent)
    other = str(Path(other).resolve())
    runs = {other: [], here: []}
    for tree in (other, here, here, other):
        out = subprocess.run([sys.executable, "-c", TREE_CHILD, tree,
                              str(Path(here) / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise RuntimeError(f"{tree}: {out.stderr[-3000:]}")
        line = next(ln for ln in out.stdout.splitlines() if ln.startswith("ROWS "))
        runs[tree].append(json.loads(line[5:]))
    for i, row in enumerate(runs[here][0]):
        dtype = cs.DTYPES[row["tag"]]
        bound_ms, by = cs.bound(tuple(row["shape"]), dtype)
        mean = {tree: {key: sum(r[i][key] for r in rs) / len(rs)
                       for key in ("ms", "plain_ms", "library_ms")}
                for tree, rs in runs.items()}
        spread = max(abs(rs[0][i]["ms"] - rs[1][i]["ms"]) / min(rs[0][i]["ms"], rs[1][i]["ms"])
                     for rs in runs.values())
        say(f"trees {row['tag']} {tuple(row['shape'])}: other "
            f"{mean[other]['ms'] * 1e3:.2f} us, this {mean[here]['ms'] * 1e3:.2f} us "
            f"(runs within {spread:.1%}); bound {bound_ms * 1e3:.2f} us ({by}), "
            f"{bound_ms / mean[here]['ms']:.0%} of it; plain "
            f"{mean[here]['plain_ms'] * 1e3:.2f} us, addmm+relu_ "
            f"{mean[here]['library_ms'] * 1e3:.2f} us (this tree's runs)")


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if (mode, len(sys.argv)) not in (("sweep", 2), ("trees", 3)):
        print(__doc__, file=sys.stderr)
        return 2
    cs.phase_device()
    if mode == "trees":
        run_trees(sys.argv[2])
    else:
        run_sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
