"""Where a profiled window of CUDA graph replays loses kernel records.

Runs the profiled chunk of ``chip_smoke.py`` phase 11 (d) (``--profile_dir``
over 50 replays of the device-resident step, zero 0, 1, 3 and 3
overlapped, f32 and bf16) ``reps`` times on one card, in turns with no
idle margins around the window and with the loop's, and reads each
Chrome trace: the kernels of every replay (by the ``cudaGraphLaunch``
correlation id), the fused_dense_relu "tma" launches among them, and
where the first replay's first kernel and the last replay's last kernel
sit against the window's host events; and each window's busy share,
which the margins must leave as it was. A replay with fewer kernels than
the others lost records; kernels stamped before the first host event
show the device's clock moved onto the host's off by that much.

    python3 profile_window_probe.py [reps]      # on a card; default 4
"""
import collections
import itertools
import json
import os
import sys
import tempfile

import torch.distributed as dist

import chip_smoke as cs
import distributed_tensorflow_tpu_torch.training.loop as loop


def analyze(path: str, label: str) -> int:
    """Print the trace's replays and return its "tma" kernel count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "GraphLaunch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    by_corr = collections.defaultdict(list)
    for k in kernels:
        by_corr[k.get("args", {}).get("correlation")].append(k)
    host = [e for e in events if e.get("cat") in ("cpu_op", "cuda_runtime")]
    t0 = min(e["ts"] for e in host)
    t1 = max(e["ts"] + e.get("dur", 0) for e in host)
    replays = [sorted(by_corr.get(g["args"].get("correlation"), []),
                      key=lambda e: e["ts"]) for g in launches]
    counts = collections.Counter(len(ks) for ks in replays)
    tma = sum("fdr_tma_kernel" in k["name"] for k in kernels)
    first = replays[0][0]["ts"] - t0 if replays and replays[0] else None
    last = (t1 - replays[-1][-1]["ts"] - replays[-1][-1]["dur"]
            if replays and replays[-1] else None)
    print(f"[probe] {label}: {len(launches)} graph launches, kernels per "
          f"replay {dict(counts)}, tma {tma}; first replay's first kernel "
          f"{first} us after the first host event, last replay's last "
          f"kernel ends {last} us before the last host event ends",
          flush=True)
    return tma


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    margins = (0.0, loop._PROFILE_MARGIN_S)
    short = dict.fromkeys(margins, 0)
    busy = collections.defaultdict(list)
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "empty")
        os.makedirs(data_dir)
        port = cs.free_port()
        cs.maybe_initialize_distributed(
            cs.ClusterSpec({"worker": [f"127.0.0.1:{port}"]}), 0, "cuda")
        try:
            for rep, margin in itertools.product(range(reps), margins):
                loop._PROFILE_MARGIN_S = margin
                for tag in cs.DTYPES:
                    for name in cs.ZERO:
                        d = os.path.join(work, f"{margin}-{rep}-{tag}-{name}"
                                         .replace(" ", "-"))
                        run = cs.TrainRun(d, data_dir, tag, True,
                                          "--training_iter",
                                          str(2 * cs.CHUNK),
                                          "--display_step",
                                          str(20 * cs.CHUNK), "--test_eval",
                                          "false", "--profile_dir",
                                          os.path.join(d, "trace"),
                                          "--profile_steps", str(cs.CHUNK),
                                          *cs.sync_args(port),
                                          *cs.zero_args(name), mode="sync")
                        busy[margin, tag, name].append(
                            run.result.device_busy_share)
                        short[margin] += analyze(
                            os.path.join(d, "trace", "trace.json"),
                            f"margin {margin} s, rep {rep} {tag} {name}"
                        ) != cs.CHUNK
        finally:
            dist.destroy_process_group()
    windows = reps * len(cs.DTYPES) * len(cs.ZERO)
    for margin, n in short.items():
        print(f"[probe] margin {margin} s: {n} of {windows} windows hold "
              f"the kernel other than {cs.CHUNK} times")
    for (margin, tag, name), shares in busy.items():
        print(f"[probe] margin {margin} s, {tag} {name}: busy share "
              f"{', '.join(f'{b:.4f}' for b in shares)} (over the profiled "
              f"steps)")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
