#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``distributed_tensorflow_tpu_torch`` only, never JAX, in phases:

1. device: requires a card (exits non-zero without one) and prints
   ``nvidia-smi``'s name and power limit;
2. build: compiles every CUDA source in ``ops/csrc/`` with nvcc for
   sm_90a, prints nvcc's register/shared-memory summary, and counts the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in each
   kernel's SASS (``cuobjdump -sass``): the "tma" variant must have both in
   bf16 and TMA loads in f32;
3. kernel vs plain: ``fused_dense_relu`` against its plain PyTorch version
   in float32 and bfloat16 at the wd1 shapes and a ragged one, with the
   variant ``launch_config`` picks; two calls on the same inputs must be
   bitwise equal (the split-K sum has a fixed order); one wrapper call
   must enqueue exactly one kernel (``torch.profiler``);
4. serving: writes a checkpoint of a seeded ``DeepCNN``, builds the stack
   through ``build_serving_stack`` with ``--pallas`` (then ``--bf16``),
   POSTs 64 examples to ``/v1/predict`` from 8 threads, checks every answer
   against the ``use_pallas=False`` forward on the card, and checks that
   the kernel launched once per predict batch, every time as the "tma"
   variant;
5. train: through ``train(FLAGS)``, the entry point of ``python -m
   distributed_tensorflow_tpu_torch.mnist_dist``, in f32 and in bf16
   (adam at 1e-3, batch 128, synthetic data from an empty ``--data_dir``):
   the kernel's gradient against the plain version's autograd at the
   training and test-eval shapes; 20 steps with ``--pallas`` against 20
   without, loss by loss, from one init and one batch stream, and against
   20 with the kernel's plain version in the kernel's place; 300 steps
   with ``--pallas`` that must reach test accuracy 0.98, with the kernel
   launched once per forward pass (train steps, display evals, test-eval
   batches), every time as the "tma" variant; the final checkpoint
   restored and resumed by a second ``train``; then steady-state
   images/s and ms/step with and without ``--pallas`` in turns, and the
   device's busy share over 20 steps from ``torch.profiler``;
6. times: per shape the kernel, its plain version and ``torch.addmm`` +
   ``relu_`` (a yardstick the port never calls), each from CUDA events
   around a CUDA graph of many launches over rotating buffers larger than
   L2, beside the least time the card could take;
7. the ``kernels`` JSON line, the card line, and ``{"ok": true, ...}`` last,
   after phase 12;
8. device-resident sync DP: a one-rank NCCL group on
   ``tcp://127.0.0.1:<free port>``, then ``train(FLAGS, mode="sync")`` with
   ``--device_data --pallas`` in f32 and in bf16 (each step one CUDA graph
   replay with the kernel inside): 20 replayed steps against 20 eager
   device steps on the same draws (dropout on); 300 steps that must reach
   test accuracy 0.98, with the kernel's launches counted (eager warm-up,
   replays, display evals, test eval); a profiled chunk whose device
   kernels, found by name in the trace, must hold the kernel once per
   step, all "tma"; a resume from a step off a chunk boundary that must
   realign to the display step; then images/s/GPU, ms/step and busy share
   of this path and of phase 5's host-fed path, in turns;
9. ResNet-20 on synthetic CIFAR-10 (BASELINE config 4, 272,474
   parameters, batch-norm running stats as ``model_state``), through
   ``train(FLAGS)`` in f32 and in bf16: 250 host-fed ``--augment`` steps
   (adam at 1e-3, batch 128) that must reach the JAX package's test
   accuracy at this recipe less 0.05 (0.635 f32, 0.5585 bf16), the final
   checkpoint's ``model_state`` restored bitwise and a resumed run that
   keeps it (its test accuracy normalizes by the restored stats); 20
   steps of ``--mode sync --device_data --augment`` replayed from a CUDA
   graph against 20 eager device steps on the same draws, losses,
   parameters and running stats bitwise under ``cudnn.deterministic``;
   then images/s/GPU and ms/step of the device-resident path at the
   JAX package's bench recipe (momentum 0.1, batch 512, chunk 50) and of
   the host-fed path at batch 128, in turns, with each one's busy share,
   kernels per step, idle between kernels and top kernels by device time
   from ``torch.profiler``. The slice adds no kernel: ``fused_dense_relu``
   must not launch here;
10. the asynchronous ps topology (BASELINE config 5) through the
   reference's command line: ``ps/0`` and ``worker/1`` as ``python -m
   distributed_tensorflow_tpu_torch.mnist_dist`` subprocesses on
   127.0.0.1 ports, ``worker/0`` in this process through the same
   ``mnist_dist.main`` (deep_cnn ``--pallas``, adam 1e-3, batch 128, in
   f32 and with ``--bf16 --ps_wire bf16``): two workers must reach test
   accuracy 0.98 within 600 global steps with the mirror cycle, while
   the ps holds no CUDA context (not in ``nvidia-smi``'s compute apps,
   no ``/dev/nvidia<N>`` open); worker/0's kernel launches must equal
   its cycles, display evals and test-eval batches, all "tma"; the
   final checkpoint, beside the background writer's cadenced ones, must
   evaluate through ``--eval_only`` to the printed accuracy and pass
   ``checkpoint.inspect --verify``; one worker's 20 mirror cycles must
   land the ps within 1e-5 of each leaf's scale of 20 full-pull cycles
   (keep_prob 1, cuDNN deterministic); then global steps/s, images/s
   over both workers and worker/0's per-cycle split (pull, upload,
   grad, download, push) with the mirror on and off on either wire, in
   turns, and the device's busy share over 20 of worker/0's cycles;
11. ZeRO-sharded sync DP on phase 8's one-rank NCCL group, in f32 and in
   bf16: 20 graph-replayed device steps each of ``--zero 1``, ``--zero
   3`` and ``--zero 3 --zero_overlap`` against 20 of phase 8's replicated
   device step on the same draws, losses and the whole state (optimizer
   slots included) bitwise under cuDNN's deterministic algorithms (at one
   rank the reduce-scatter and the gather are copies); ``train(FLAGS,
   mode="sync")`` with ``--zero 3 --zero_overlap --device_data --pallas``
   for 300 steps to test accuracy 0.98, the kernel launched once per
   forward pass, all "tma"; that run's final checkpoint resumed by a
   replicated run and by itself, and phase 8's replicated checkpoint
   resumed by ``--zero 1`` and by itself, 10 steps each, the resumed
   pairs' checkpoints bitwise equal; then images/s/GPU and ms/step of
   zero 0, 1, 3 and 3 overlapped in turns, each with its busy share and
   the kernel counted by name in a profiled chunk;
12. the causal LM at ``bench.py``'s ``lm_4k`` (vocab 64, seq 4096, batch
   8) and ``lm_bigvocab`` (vocab 32768, seq 8192, batch 4) configurations
   (d_model 256, 4 heads, 4 blocks, bf16, adam 1e-3): (a) the flash
   attention's autograd Function against dense attention at one lm_4k
   layer, (8, 4096, 4, 64) at block 512, causal, and the streamed head
   against dense + softmax cross-entropy + accuracy on 4096 rows of
   lm_bigvocab's head, values and gradients in f32 within 1e-4 of each
   output's scale, with their times; (b) lm_4k trains 20 steps through
   ``train(FLAGS)`` with ``--attn_block 512``, the loss finite and
   falling, with tokens/s/GPU, ms/step, the peak memory of the run and
   the busy share and top kernels of 5 profiled steps, and a few steps
   with dense attention that must peak at least twice as high; (c)
   lm_bigvocab trains 10 steps with ``--ce_block 512`` beside a few with
   ``--ce_block 0``, which must peak at least twice as high; (d) the JAX
   test's recall recipe (V 16, S 32, 200 adam steps) in f32 and bf16 to
   the JAX package's test accuracy less 0.05, then its final checkpoint
   restored and resumed; (e) a seeded lm_4k checkpoint served through
   ``build_serving_stack --model lm`` in f32 and bf16: 32 HTTP
   ``/v1/generate`` requests (prompt 64, 32 new tokens) from 8 threads,
   every greedy token equal to the argmax of a full-prefix forward on the
   card (a position whose top-2 margin is inside the logits' tolerance
   is a near tie, counted and printed), decode logits at batch 8 within
   1e-4 (f32) and 2e-2 (bf16) of the recompute's scale and whether they
   are bitwise equal, a 400 for an out-of-vocabulary prompt, a seeded
   sampled request that repeats, request p50/p99, and the prefill and
   per-step decode times; (f) ``fused_dense_relu`` must not launch over
   (b)-(e).

Any failed phase raises, so the script exits non-zero. f32 runs in full
f32: TF32 is turned off for cuDNN and cuBLAS.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch import flags, mnist_dist
from distributed_tensorflow_tpu_torch.checkpoint import (
    inspect as ckpt_inspect,
    latest_checkpoint,
    load_flat,
    restore_with_fallback,
    save_checkpoint,
)
from distributed_tensorflow_tpu_torch.cluster import (
    ClusterSpec,
    maybe_initialize_distributed,
)
from distributed_tensorflow_tpu_torch.data import (
    datasets,
    put_device_data,
    read_data_sets,
    synthetic_digits,
)
from distributed_tensorflow_tpu_torch.models import (
    DeepCNN,
    ResNet20,
    TransformerLM,
    cnn,
)
from distributed_tensorflow_tpu_torch.ops.augment import make_augment
from distributed_tensorflow_tpu_torch.ops import _build, fused_dense
from distributed_tensorflow_tpu_torch.ops import nn as ops_nn
from distributed_tensorflow_tpu_torch.ops.attention import (
    blockwise_attention,
    multi_head_attention,
)
from distributed_tensorflow_tpu_torch.ops.nn import streamed_softmax_ce_head
from distributed_tensorflow_tpu_torch.ops.fused_dense import (
    fused_dense_relu,
    fused_dense_relu_reference,
)
from distributed_tensorflow_tpu_torch.parallel import (
    PSClient,
    fetch_state_zero,
    make_mesh,
    shard_state_zero,
)
from distributed_tensorflow_tpu_torch.serving.__main__ import (
    build_serving_stack,
)
from distributed_tensorflow_tpu_torch.serving.server import InferenceServer
from distributed_tensorflow_tpu_torch.training import train_state
from distributed_tensorflow_tpu_torch.training.device_step import (
    WARMUP_STEPS,
    make_device_dp_train_step,
    make_zero_device_train_step,
)
from distributed_tensorflow_tpu_torch.training.loop import (
    evaluate_only,
    train,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    flatten_pytree,
    params_to_numpy,
    state_to_numpy,
    tree_leaves,
)

# H100 SXM data-sheet peaks at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
L2_BYTES = 50 * 2 ** 20

# (M, K, N): serving buckets 1 and 8, the training batch 128, a large
# batch, the test-eval batch 1000, and a ragged shape that TMA cannot
# describe (variant "simt")
SHAPES = [(1, 3136, 1024), (8, 3136, 1024), (128, 3136, 1024),
          (256, 3136, 1024), (1000, 3136, 1024), (130, 257, 70)]
SERVE_SHAPE = (8, 3136, 1024)  # the largest predict bucket (--serve_max_batch 8)
TRAIN_SHAPE = (128, 3136, 1024)  # --batch_size 128
BITWISE_M = (8, 256, 1000)  # shapes whose repeat call must be bitwise equal
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# kernel vs plain: f32 is a reordered float32 sum; bf16 both round one
# float32 sum to bfloat16 (one ulp = 2**-7 relative), 1e-3 near zero
KERNEL_TOL = {"f32": dict(rtol=1e-4, atol=1e-4),
              "bf16": dict(rtol=2 ** -7, atol=1e-3)}
# served logits vs the use_pallas=False forward. f32: as above, through
# two more layers (rtol/atol 1e-4). bf16: the two FC paths round wd1's
# output at different points (the plain one before its f32 bias, the
# kernel after a bf16 bias), and the out layer sums 1024 such terms into
# logits rounded to bfloat16, so the error scales with the logits'
# magnitude, not each logit's own: max |err| <= 2e-2 * max |logit|
SERVE_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(scale=2e-2)}

# the kernel's gradient on dyadic inputs (every sum exact in float32 in
# any order): equal but for rounding the bf16 outputs, half a bf16 ulp
GRAD_TOL = dict(rtol=2 ** -8, atol=1e-6)
# --pallas with the kernel against --pallas with its plain version in the
# kernel's place (the stand-in: the same single rounding of a float32 sum,
# autograd's backward), per-step display loss over 20 adam steps:
# |diff| <= tol * max(1, |loss|). Only the summation order differs, which
# read 1.2e-4 (f32) and 1.6e-3 (bf16) on an H100 (runs of this script)
STAND_IN_TOL = {"f32": 1e-3, "bf16": 5e-3}
# --pallas against the plain path, the same measure. f32: reordered
# float32 sums. bf16: the two paths round wd1's output at different
# places (the plain one before its float32 bias, the reference's rounding,
# ROADMAP queue 3), and the loss climbs from about 5 to 12 before it
# falls, which compounds that: the stand-in, with no kernel in it, reads
# 1.98e-2 from the plain path at step 7, the kernel 2.03e-2. The limit
# is the stand-in's reading plus the kernel's STAND_IN_TOL
TRAJ_TOL = {"f32": 1e-3, "bf16": 2.5e-2}
TRAJ_STEPS, TRAIN_STEPS, RESUME_STEPS, TIME_STEPS = 20, 300, 10, 150
ACCURACY_MIN = 0.98  # test accuracy after TRAIN_STEPS
PROFILE_STEPS = 20
EVAL_BATCH = 1000  # the loop's test-eval batch

# phase 8: steps per chunk, the timed run's steps (its first chunk, the
# warm-up and the capture, stays out of the window), the resume's stops
CHUNK, DEVICE_TIME_STEPS, RESUME_AT = 50, 550, (130, 230)

# phase 9: ResNet-20 on synthetic CIFAR-10. The host-fed recipe and its
# bar: the JAX package's test accuracy at this recipe on a CPU (0.6850
# in f32, 0.6085 in bf16; PERF.md), less 0.05. The JAX package climbs
# one class at a time and the port's trained test accuracy moves by a
# class between runs, so the recipe stops where the JAX reading is still
# climbing (at 300 steps it reads 0.9135, and the port read 0.90 once)
RESNET_ARGS = ("--model", "resnet20", "--dataset", "cifar10")
RESNET_STEPS, RESNET_RESUME_STEPS = 250, 10
RESNET_ACCURACY_MIN = {"f32": 0.635, "bf16": 0.5585}
# the JAX package's bench recipe (bench.py resnet_phase): momentum 0.1,
# batch 512, device-resident, chunk 50; the host-fed path at batch 128
RESNET_BENCH = ("--optimizer", "momentum", "--learning_rate", "0.1")
RESNET_BATCH = {"device": 512, "host": 128}
RESNET_TIME_STEPS = {"device": 150, "host": 40}
# the profiled windows: 10 steps, on the device path one chunk of 10
RESNET_PROFILE_STEPS = 10
CIFAR_META = {"image_size": 32, "channels": 3}

# phase 10: the ps topology (BASELINE config 5). Two workers share a
# budget of PS_STEPS global steps and must reach ACCURACY_MIN; one worker
# runs PS_TRAJ_STEPS cycles with the mirror and as many with the full pull
# (keep_prob 1), whose final ps params must agree within PS_TRAJ_TOL of
# each leaf's scale; the timing runs take PS_TIME_STEPS global steps, the
# first turn of each configuration with a profiled window of
# PS_PROFILE_CYCLES of worker/0's cycles
PS_STEPS, PS_TRAJ_STEPS, PS_TIME_STEPS, PS_PROFILE_CYCLES = 600, 20, 150, 20

# phase 11: the ZeRO configurations (their flags beside phase 8's), in
# the order of the timed turns; zero 0 is phase 8's replicated step
ZERO = {"zero 0": (0, False), "zero 1": (1, False), "zero 3": (3, False),
        "zero 3 overlap": (3, True)}
PS_TRAJ_TOL = 1e-5
PS_WIRE_ARGS = {"f32": (), "bf16": ("--bf16", "--ps_wire", "bf16")}
PS_READY_S = 300  # a role that has not reported ready by then is stuck
REPO = os.path.dirname(os.path.abspath(__file__))

# phase 12: the causal LM at bench.py's lm_4k (vocab 64, seq 4096, batch
# 8) and lm_bigvocab (vocab 32768, seq 8192, batch 4) configurations,
# width 256, 4 heads, 4 blocks, attn_block 512, ce_block 512, bf16. The
# Functions are checked at one lm_4k layer's attention and a 4096-row
# slice of lm_bigvocab's head, in f32, to 1e-4 of each output's scale
LM_WIDTH = {"d_model": 256, "num_heads": 4, "num_blocks": 4}
LM_4K, LM_BIGV = (4096, 64), (8192, 32768)  # (seq_len, vocab)
LM_ATTN_SHAPE, LM_ATTN_BLOCK = (8, 4096, 4, 64), 512
LM_HEAD_SHAPE, LM_CE_BLOCK = (4096, 256, 32768), 512
LM_FN_TOL = 1e-4
LM_4K_BATCH, LM_BIGV_BATCH = 8, 4
LM_STEPS, LM_BIGV_STEPS, LM_MEM_STEPS, LM_PROFILE_STEPS = 20, 10, 3, 5
LM_SPLIT = (64, 16)  # train and test sequences of phases 12b and 12c
# 12d: the JAX test's recipe (tests/test_lm.py:238-256) through
# train(FLAGS). The bar is the JAX package's test accuracy at it, read by
# its own mnist_dist.py on a CPU (--model lm --dataset lm --seq_len 32
# --vocab_size 16 --d_model 64 --num_heads 2 --num_blocks 2 --optimizer
# adam --learning_rate 0.003 --batch_size 32 --training_iter 200
# --keep_prob 1.0 --mode local [--bf16]; PERF.md), less 0.05, and never
# under 3/V
RECALL_VOCAB, RECALL_STEPS = 16, 200
RECALL_ARGS = ("--model", "lm", "--dataset", "lm", "--seq_len", "32",
               "--vocab_size", str(RECALL_VOCAB), "--d_model", "64",
               "--num_heads", "2", "--num_blocks", "2", "--learning_rate",
               "0.003", "--batch_size", "32", "--keep_prob", "1.0")
RECALL_JAX = {"f32": 0.33453369140625, "bf16": 0.332275390625}
# 12e: generate requests against an lm_4k checkpoint; decode logits vs
# the full-prefix recompute within this share of the logits' scale
LM_SERVE_REQUESTS, LM_PROMPT, LM_NEW = 32, 64, 32
LM_SERVE_TOL = {"f32": 1e-4, "bf16": 2e-2}

N_REQUESTS, N_THREADS = 64, 8
KERNEL_SRC = "distributed_tensorflow_tpu_torch/ops/csrc/fused_dense_relu.cu"
TPU_KERNEL = "distributed_tensorflow_tpu/ops/pallas_ops.py:69"

def say(phase: str, line: str) -> None:
    print(f"[{phase}] {line}", flush=True)


def serve_ok(got, ref, tag) -> bool:
    if tag == "bf16":
        scale = float(np.abs(ref).max())
        return float(np.abs(got - ref).max()) <= SERVE_TOL[tag]["scale"] * scale
    return bool(np.allclose(got, ref, **SERVE_TOL[tag]))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def inputs(shape, dtype, seed, device="cuda"):
    m, k, n = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((m, k), generator=g)  # post-ReLU-like activations
    w = torch.randn((k, n), generator=g) * 0.05
    b = torch.randn((n,), generator=g) * 0.1
    return tuple(t.to(device, dtype) for t in (x, w, b))


def bound(shape, dtype) -> tuple[float, str]:
    """Least time (ms) for relu(x @ w + b): each input read once, the
    output written once, over HBM; 2*M*N*K + 2*M*N operations over the
    dtype's peak (f32 FMA units for f32, tensor cores for bf16)."""
    m, k, n = shape
    es = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (m * k + k * n + n + m * n) * es / HBM_BYTES_PER_S
    t_ops = (2 * m * n * k + 2 * m * n) / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def graph_ms(fn, bufs, reps: int) -> float:
    """Device time per call: ``reps`` calls over rotating buffers captured
    in one CUDA graph (no host gaps), timed by CUDA events over a replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*bufs[i % len(bufs)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*bufs[i % len(bufs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def library_call(x, w, b):
    return torch.addmm(b, x, w).relu_()


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    # f32 in full f32 on the card: cuDNN's default is TF32 for f32 convs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    say("device", f"{card} | torch {torch.__version__} cuda "
                  f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} "
                  f"x{torch.cuda.device_count()}")
    return card


def sass_counts(lib_path: str) -> dict[str, dict[str, int]]:
    """Per kernel in the library, its ``HGMMA`` and ``UTMALDG`` SASS
    instructions, from ``cuobjdump -sass``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    say("build", f"{len(logs)} source(s) built in {dt:.1f} s "
                 f"({_build.nvcc_path()}, {' '.join(_build.NVCC_FLAGS)})")
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        for line in _build.build_log(name).splitlines():
            if any(s in line for s in ("registers", "spill", "Compiling")):
                say("build", f"{name}: {line.strip()}")
        _build.load_library(name)
    counts = sass_counts(str(_build.library_path("fused_dense_relu")))
    for fn, c in sorted(counts.items()):
        say("build", f"SASS {fn}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}")
    tma = {fn: c for fn, c in counts.items() if "fdr_tma_kernel" in fn}
    bf16 = [c for fn, c in tma.items() if "bfloat16" in fn]
    f32 = [c for fn, c in tma.items() if "bfloat16" not in fn]
    if not bf16 or not f32 or not all(c["HGMMA"] and c["UTMALDG"] for c in bf16) \
            or not all(c["UTMALDG"] for c in f32):
        raise AssertionError("the tma variant must run wgmma (HGMMA) in bf16 "
                             "and load by TMA (UTMALDG) in both dtypes")


def kernels_in_one_call(x, w, b, windows: int = 3) -> list[str]:
    """The device kernels that one wrapper call enqueues, by name
    (``torch.profiler``; the output's ``torch.empty`` launches none).
    Spin kernels (``torch.cuda._sleep``, about 10 us each) open the
    window: the tracer can drop the first kernels of a window (seen on an
    H100), so a trace without any spin is taken again, at most
    ``windows`` times, and in one with a spin every kernel after the last
    spin is the call's."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(20000)
            fused_dense_relu(x, w, b)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower()
             and "memset" not in e.name.lower()),
            key=lambda e: e.time_range.start)]
        spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if spins:
            return names[spins[-1] + 1:]
        say("kernel", f"profiler window without its spin kernels "
                      f"({names}); taking it again")
    raise AssertionError(f"the profiler recorded no spin kernel in "
                         f"{windows} windows")


def phase_kernel_vs_plain() -> dict:
    worst = {}
    for tag, dtype in DTYPES.items():
        worst[tag] = 0.0
        for shape in SHAPES:
            x, w, b = inputs(shape, dtype, seed=sum(shape))
            m, k, n = shape
            cfg = fused_dense.launch_config(m, n, k, dtype, x.data_ptr(),
                                            w.data_ptr(),
                                            fused_dense.sm_count(x.device.index))
            want = "simt" if shape == (130, 257, 70) else "tma"
            by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
            got = fused_dense_relu(x, w, b)
            ref = fused_dense_relu_reference(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = torch.allclose(got.float(), ref.float(), **KERNEL_TOL[tag])
            moved = (fused_dense.LAUNCHES_BY_VARIANT[want]
                     == by_variant[want] + 1)
            same = torch.equal(fused_dense_relu(x, w, b), got) \
                if m in BITWISE_M else None
            say("kernel", f"{tag} {shape}: variant {cfg.variant} block_m "
                          f"{cfg.block_m} cluster {cfg.cluster}; max_abs_err "
                          f"{err:.3e} (tolerance {KERNEL_TOL[tag]}) "
                          f"{'ok' if ok else 'FAIL'}"
                          + ("" if same is None else
                             f"; repeat call bitwise {'equal' if same else 'DIFFERENT'}"))
            if not (ok and got.shape == (m, n) and got.dtype == dtype):
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version at {tag} {shape}")
            if cfg.variant != want or not moved:
                raise AssertionError(f"{tag} {shape} launched variant "
                                     f"{cfg.variant}, expected {want}")
            if same is False:
                raise AssertionError(f"{tag} {shape}: two calls on the same "
                                     f"inputs differ")
            worst[tag] = max(worst[tag], err)
        # one wrapper call, one kernel: the split-K sum stays on chip
        x, w, b = inputs(SERVE_SHAPE, dtype, seed=3)
        names = kernels_in_one_call(x, w, b)
        say("kernel", f"{tag} {SERVE_SHAPE}: one call enqueued "
                      f"{len(names)} kernel(s) {names} (torch.profiler)")
        if len(names) != 1 or "fdr_tma_kernel" not in names[0]:
            raise AssertionError(f"one {tag} call must enqueue exactly one "
                                 f"tma kernel, got {names}")
    return worst


def _post(url: str, obj: dict) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_serve(tag: str) -> dict:
    """The port's main path: checkpoint -> build_serving_stack(--pallas)
    -> HTTP predict, checked against the use_pallas=False forward."""
    model = DeepCNN().init(torch.Generator().manual_seed(0))
    x, _ = synthetic_digits(N_REQUESTS, seed=7)
    with tempfile.TemporaryDirectory() as logdir:
        save_checkpoint(logdir, {"params": params_to_numpy(model),
                                 "step": np.int32(1)}, 1)
        flags.define_flags()
        flags.FLAGS._reset()
        flags.FLAGS._parse(
            ["--logdir", logdir, "--pallas", "--serve_max_batch", "8",
             "--serve_port", "0", "--serve_reload_secs", "0",
             "--serve_timeout_ms", "60000"]
            + (["--bf16"] if tag == "bf16" else []))
        engine, client, _watcher, metrics = build_serving_stack(flags.FLAGS)
        batcher = client.predict_batcher
        server = InferenceServer(engine, client, port=0).start_background()
        try:
            _post(server.address + "/v1/predict", {"inputs": x[0].tolist()})
            for n in (1, 2, 4, 8):  # first use of each bucket's shapes
                engine.predict(x[:n])
            torch.cuda.synchronize()
            batcher.latency.reset()
            outs = [None] * N_REQUESTS
            batches0 = batcher.stats.as_dict()["batches"]
            fused_dense.LAUNCHES = 0  # the main path's run starts here
            fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)

            def worker(t):
                for i in range(t, N_REQUESTS, N_THREADS):
                    outs[i] = _post(server.address + "/v1/predict",
                                    {"inputs": x[i].tolist()})["outputs"]

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(N_THREADS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            launches = fused_dense.LAUNCHES  # ... and ends here
            by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
            stats = batcher.stats.as_dict()
            lat = batcher.latency.summary()
        finally:
            server.close()
            batcher.close()
            metrics.logger.close()
    batches = stats["batches"] - batches0
    got = np.asarray(outs, dtype=np.float32)
    ref_model = DeepCNN(compute_dtype=engine.model.compute_dtype,
                        use_pallas=False)
    ref_model.load_state_dict(model.state_dict())
    ref_model = ref_model.cuda().eval()
    with torch.inference_mode():
        ref = ref_model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    err = float(np.abs(got - ref).max())
    ok = (got.shape == (N_REQUESTS, 10) and np.isfinite(got).all()
          and serve_ok(got, ref, tag))
    say("serve", f"{tag}: {N_REQUESTS} HTTP predicts in {wall:.3f} s, "
                 f"{batches} batches (mean {stats['mean_batch_size']:.2f}), "
                 f"kernel launches {launches} {by_variant}; logits vs "
                 f"use_pallas=False "
                 f"max_abs_err {err:.3e} (max |logit| "
                 f"{np.abs(ref).max():.3f}; tolerance {SERVE_TOL[tag]}); "
                 f"request p50 {lat['p50']:.3f} ms p99 {lat['p99']:.3f} ms")
    if not ok:
        raise AssertionError(f"served {tag} logits disagree with the "
                             f"use_pallas=False forward")
    if launches != batches or batches < 1 or stats["completed"] < N_REQUESTS:
        raise AssertionError(f"{tag}: {launches} kernel launches for "
                             f"{batches} predict batches")
    if by_variant != {"tma": batches, "simt": 0}:
        raise AssertionError(f"{tag}: serving must launch the tma variant "
                             f"for every batch, got {by_variant}")
    return {"launches": launches, "batches": batches, "max_abs_err": err,
            "latency_ms": lat, "wall_s": wall, "by_variant": by_variant}


def dyadic_inputs(shape, dtype, seed):
    """x, w, b and an upstream gradient g whose entries are small
    multiples of powers of two: every sum of their products is exact in
    float32, so the ReLU mask cannot differ between two summation
    orders."""
    m, k, n = shape
    r = np.random.default_rng(seed)
    arrs = (r.integers(-8, 9, (m, k)) / 8, r.integers(-8, 9, (k, n)) / 256,
            r.integers(-8, 9, n) / 64, r.integers(-8, 9, (m, n)) / 8)
    return [torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)
            for a in arrs]


def phase_train_grad() -> dict:
    """The kernel's forward and the port's backward against autograd
    through the plain version, at the training and test-eval shapes."""
    worst = {}
    for tag, dtype in DTYPES.items():
        worst[tag] = 0.0
        for shape in (TRAIN_SHAPE, (EVAL_BATCH, 3136, 1024)):
            x, w, b, g = dyadic_inputs(shape, dtype, seed=shape[0])
            for t in (x, w, b):
                t.requires_grad_()
            y = fused_dense_relu(x, w, b)
            y.backward(g)
            got = [y] + [t.grad for t in (x, w, b)]
            for t in (x, w, b):
                t.grad = None
            ref = fused_dense_relu_reference(x, w, b)
            ref.backward(g)
            want = [ref] + [t.grad for t in (x, w, b)]
            torch.cuda.synchronize()
            errs = {}
            for name, a, r in zip(("y", "dx", "dw", "db"), got, want):
                errs[name] = (a.float() - r.float()).abs().max().item()
                if not (a.dtype == r.dtype == dtype and torch.allclose(
                        a.float(), r.float(), **GRAD_TOL)):
                    raise AssertionError(f"{tag} {shape}: {name} through the "
                                         f"kernel disagrees with autograd "
                                         f"through the plain version")
            say("train", f"{tag} {shape} gradient vs plain autograd: max_abs_"
                         f"err " + ", ".join(f"{k} {v:.3e}"
                                             for k, v in errs.items())
                         + f" (tolerance {GRAD_TOL}) ok")
            worst[tag] = max(worst[tag], *errs.values())
    return worst


class TrainRun:
    """``train(FLAGS)`` with the slice's settings in ``logdir``: adam at
    1e-3, batch 128, synthetic data from the empty ``data_dir``. Its
    stdout is kept in ``out``; the display losses are read back from
    ``metrics.jsonl``."""

    def __init__(self, logdir: str, data_dir: str, tag: str, pallas: bool,
                 *extra: str, mode: str = "local"):
        flags.define_reference_flags()
        flags.FLAGS._reset()
        flags.FLAGS._parse(
            ["--device", "cuda", "--logdir", logdir, "--data_dir", data_dir,
             "--optimizer", "adam", "--learning_rate", "0.001",
             "--batch_size", "128", "--save_model_secs", "100000", *extra]
            + (["--pallas"] if pallas else [])
            + (["--bf16"] if tag == "bf16" else []))
        self.logdir = logdir
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            self.result = train(flags.FLAGS, mode=mode)
        self.out = buf.getvalue()

    def records(self, key: str) -> dict:
        with open(os.path.join(self.logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        return {r["step"]: r[key] for r in recs if key in r}


def forwards(start: int, stop: int, display_step: int, test_n: int) -> int:
    """The forward passes of a run from step ``start`` to ``stop``: one
    per train step, one per display eval, one per test-eval batch."""
    displays = sum(1 for s in range(start, stop) if s % display_step == 0)
    return (stop - start) + displays + math.ceil(test_n / EVAL_BATCH)


@contextlib.contextmanager
def plain_in_kernel_place():
    """The model calls the kernel's plain version where it would launch
    the kernel."""
    cnn.fused_dense_relu = fused_dense_relu_reference
    try:
        yield
    finally:
        cnn.fused_dense_relu = fused_dense_relu


def rel_diffs(got: dict, want: dict) -> list[float]:
    """Per display step, |got - want| / max(1, |want|)."""
    return [abs(got[s] - want[s]) / max(1.0, abs(want[s]))
            for s in sorted(want)]


def phase_train(tag: str, work: str, data_dir: str) -> dict:
    """Trajectory, convergence with launch counts, checkpoint and resume."""
    steps = TRAJ_STEPS

    def trajectory(name, pallas):
        run = TrainRun(os.path.join(work, f"{tag}-traj-{name}"), data_dir,
                       tag, pallas, "--training_iter", str(steps),
                       "--display_step", "1", "--keep_prob", "1",
                       "--test_eval", "false")
        return run.records("mini_batch_loss")

    plain, kern = trajectory("plain", False), trajectory("kernel", True)
    launched = fused_dense.LAUNCHES
    with plain_in_kernel_place():
        stand = trajectory("stand-in", True)
    if fused_dense.LAUNCHES != launched:
        raise AssertionError(f"{tag}: the stand-in run launched the kernel")
    if not sorted(plain) == sorted(kern) == sorted(stand) == \
            list(range(steps)):
        raise AssertionError(f"{tag}: display steps {sorted(kern)} with "
                             f"--pallas, {sorted(plain)} without")
    diffs = rel_diffs(kern, plain)
    stand_diffs, kern_stand = rel_diffs(stand, plain), rel_diffs(kern, stand)
    say("train", f"{tag}: {steps} steps with --pallas vs without, keep_prob "
                 f"1: loss {plain[0]:.6f} -> {plain[steps - 1]:.6f} (plain), "
                 f"{kern[0]:.6f} -> {kern[steps - 1]:.6f} (--pallas); max "
                 f"|diff|/max(1,|loss|) {max(diffs):.3e} (tolerance "
                 f"{TRAJ_TOL[tag]}); per step: plain loss "
                 f"{[round(plain[s], 4) for s in sorted(plain)]}, diff "
                 f"{[float(f'{d:.3g}') for d in diffs]}")
    say("train", f"{tag}: the plain version in the kernel's place vs "
                 f"without --pallas: max {max(stand_diffs):.3e}, per step "
                 f"{[float(f'{d:.3g}') for d in stand_diffs]}; the kernel "
                 f"vs that stand-in: max {max(kern_stand):.3e} (tolerance "
                 f"{STAND_IN_TOL[tag]}), per step "
                 f"{[float(f'{d:.3g}') for d in kern_stand]}")
    if max(diffs) > TRAJ_TOL[tag]:
        raise AssertionError(f"{tag}: the --pallas trajectory leaves the "
                             f"plain path's")
    if max(kern_stand) > STAND_IN_TOL[tag]:
        raise AssertionError(f"{tag}: the kernel's trajectory leaves its "
                             f"plain version's")

    logdir = os.path.join(work, f"{tag}-main")
    test_n = datasets.SYNTHETIC_TEST
    fused_dense.LAUNCHES = 0  # the main path's run starts here
    fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)
    main = TrainRun(logdir, data_dir, tag, True, "--training_iter",
                    str(TRAIN_STEPS))
    launches = fused_dense.LAUNCHES  # ... and ends here
    by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
    res = main.result
    want = forwards(0, TRAIN_STEPS, 100, test_n)
    for line in main.out.splitlines():
        if line.startswith(("job: ", "test accuracy")):
            say("train", f"{tag}: {line}")
    acc = res.test_metrics["accuracy"]
    say("train", f"{tag}: {TRAIN_STEPS} steps with --pallas, default "
                 f"keep_prob: test accuracy {acc:.4f} (need >= "
                 f"{ACCURACY_MIN}); kernel launches {launches} {by_variant} "
                 f"for {want} forward passes")
    if res.final_step != TRAIN_STEPS or not acc >= ACCURACY_MIN:
        raise AssertionError(f"{tag}: step {res.final_step}, test accuracy "
                             f"{acc}")
    if launches != want or by_variant != {"tma": want, "simt": 0}:
        raise AssertionError(f"{tag}: {launches} launches {by_variant} for "
                             f"{want} forward passes, all to be tma")

    # the final checkpoint restores into a fresh state, and a second
    # train() resumes from its step
    model = DeepCNN(compute_dtype=torch.bfloat16 if tag == "bf16" else None)
    template = train_state.create_train_state(model, train_state.adam(1e-3))
    restored = restore_with_fallback(logdir, template)
    if restored is None or restored[1] != TRAIN_STEPS:
        raise AssertionError(f"{tag}: the final checkpoint did not restore")
    fused_dense.LAUNCHES = 0
    stop = TRAIN_STEPS + RESUME_STEPS
    again = TrainRun(logdir, data_dir, tag, True, "--training_iter", str(stop))
    resumed = again.records("recovery_restore_step")
    want_again = forwards(TRAIN_STEPS, stop, 100, test_n)
    say("train", f"{tag}: resumed from step {resumed.get(TRAIN_STEPS)} to "
                 f"{again.result.final_step}, {fused_dense.LAUNCHES} launches "
                 f"for {want_again} forward passes, test accuracy "
                 f"{again.result.test_metrics['accuracy']:.4f}")
    if resumed.get(TRAIN_STEPS) != TRAIN_STEPS or \
            again.result.final_step != stop or \
            fused_dense.LAUNCHES != want_again:
        raise AssertionError(f"{tag}: the resume did not continue from "
                             f"step {TRAIN_STEPS}")
    return {"launches": launches, "accuracy": acc,
            "traj_max_rel_diff": max(diffs),
            "stand_in_max_rel_diff": max(stand_diffs),
            "kernel_vs_stand_in_max_rel_diff": max(kern_stand)}


def phase_train_times(card: str, work: str, data_dir: str) -> dict:
    """Steady-state throughput, with and without --pallas in turns, and
    the device's busy share over PROFILE_STEPS steps."""
    rates = {}
    for tag in DTYPES:
        for i, pallas in enumerate((False, True, True, False)):
            run = TrainRun(os.path.join(work, f"{tag}-time-{i}"), data_dir,
                           tag, pallas, "--training_iter", str(TIME_STEPS),
                           "--display_step", str(10 * TIME_STEPS),
                           "--test_eval", "false")
            rates.setdefault((tag, pallas), []).append(
                run.result.images_per_sec)
            split = {k: run.records(f"step_{k}_s")[TIME_STEPS] * 1e3
                     for k in ("host_wait", "dispatch", "device")}
            say("times", f"{tag} train {'--pallas' if pallas else 'plain'} "
                         f"run {i}: {run.result.images_per_sec:.1f} images/s;"
                         f" per step: " + ", ".join(
                             f"{k} {v:.4f} ms" for k, v in split.items())
                         + " (StepTimer)")
        for pallas in (False, True):
            run = TrainRun(os.path.join(work, f"{tag}-prof-{pallas}"),
                           data_dir, tag, pallas, "--training_iter",
                           str(2 * PROFILE_STEPS), "--display_step",
                           str(10 * TIME_STEPS), "--test_eval", "false",
                           "--profile_dir",
                           os.path.join(work, f"{tag}-prof-{pallas}", "trace"),
                           "--profile_steps", str(PROFILE_STEPS))
            busy = run.result.device_busy_share
            for line in run.out.splitlines():
                if line.strip() and not line.startswith(("job: ", "Optim")):
                    say("profile", f"{tag} {'--pallas' if pallas else 'plain'}"
                                   f" | {line}")
            per = rates[(tag, pallas)]
            mean = sum(per) / len(per)
            rates[(tag, pallas)] = {"images_per_sec": per,
                                    "ms_per_step": 128e3 / mean,
                                    "busy_share": busy}
            say("times", f"{tag} train {'--pallas' if pallas else 'plain   '}"
                         f": {', '.join(f'{r:.1f}' for r in per)} images/s/GPU"
                         f" over steps 1-{TIME_STEPS - 1} of {len(per)} runs "
                         f"(mean {mean:.1f}, {128e3 / mean:.4f} ms/step); "
                         f"device busy share over {PROFILE_STEPS} steps "
                         f"{'not measured' if busy is None else f'{busy:.4f}'}"
                         f" (torch.profiler) | {card}")
    return rates


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def device_kernels(trace_path: str) -> tuple[dict[str, int], dict]:
    """From a ``torch.profiler`` Chrome trace of replayed steps: the
    kernel's launches on the device by variant, found by kernel name; and
    the device's idle time between kernels, split into the gaps at the
    boundaries between replays and the gaps inside the step's graph. A
    replay starts with the int64 fills that copy its generators' seeds to
    the device (``FillFunctor<long>``; the step itself fills no int64
    tensor), so a gap that touches one of them is a boundary gap."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    counts = {"tma": 0, "simt": 0}
    idle = {"boundary_us": 0.0, "inside_us": 0.0, "boundaries": 0}
    end, prev_fill = None, False
    for e in kernels:
        # e.g. "void (anonymous namespace)::fdr_tma_kernel<float, 32>(...)"
        name = e.get("name", "")
        if "fdr_tma_kernel" in name:
            counts["tma"] += 1
        elif re.search(r"fdr_\w+_simt", name):
            counts["simt"] += 1
        fill = "FillFunctor<long>" in name
        idle["boundaries"] += fill and not prev_fill
        if end is not None and e["ts"] > end:
            key = "boundary_us" if fill or prev_fill else "inside_us"
            idle[key] += e["ts"] - end
        end = max(end or 0.0, e["ts"] + e["dur"])
        prev_fill = fill
    return counts, idle


def graph_vs_eager(tag: str, mesh, data) -> dict:
    """20 device steps replayed from a CUDA graph against 20 eager device
    steps, each from the seed-0 init, on the same draws (dropout on), with
    cuDNN's deterministic algorithms in both."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for graph in (True, False):
            model = DeepCNN(compute_dtype=(torch.bfloat16 if tag == "bf16"
                                           else None), use_pallas=True)
            opt = train_state.adam(1e-3)
            state = train_state.create_train_state(model, opt, seed=0,
                                                   device="cuda")
            state = state._replace(step=state.step.cuda())
            step_fn = make_device_dp_train_step(model, opt, mesh, data, 128,
                                                keep_prob=0.75, graph=graph)
            losses = {}
            for s in range(TRAJ_STEPS):
                state, m = step_fn(state, s, 1)
                losses[s] = float(m["loss"])
            runs[graph] = (losses, params_to_numpy(model))
    finally:
        torch.backends.cudnn.deterministic = False
    (replayed, p_graph), (eager, p_eager) = runs[True], runs[False]
    diffs = rel_diffs(replayed, eager)
    bitwise = replayed == eager and all(
        np.array_equal(a, b) for a, b in zip(
            tree_leaves(p_graph), tree_leaves(p_eager)))
    say("device", f"{tag}: {TRAJ_STEPS} steps replayed from a CUDA graph vs "
                  f"eager device steps, keep_prob 0.75: loss "
                  f"{eager[0]:.6f} -> {eager[TRAJ_STEPS - 1]:.6f}; max "
                  f"|diff|/max(1,|loss|) {max(diffs):.3e} (tolerance "
                  f"{STAND_IN_TOL[tag]}); losses and parameters bitwise "
                  f"{'equal' if bitwise else 'DIFFERENT'}")
    if max(diffs) > STAND_IN_TOL[tag]:
        raise AssertionError(f"{tag}: the graph's steps leave the eager "
                             f"steps' trajectory")
    return {"max_rel_diff": max(diffs), "bitwise": bitwise}


def sync_args(port: int) -> tuple[str, ...]:
    """The flags of the device-resident sync path: rank 0 of the one-rank
    group served on ``port``."""
    return ("--mode", "sync", "--worker_hosts", f"127.0.0.1:{port}",
            "--task_index", "0", "--device_data", "--device_chunk",
            str(CHUNK))


def phase_device_resident(tag: str, work: str, data_dir: str, mesh, data,
                          port: int) -> dict:
    """Phase 8: the sync-DP device-resident path through train(FLAGS)."""
    args = sync_args(port)
    out = graph_vs_eager(tag, mesh, data)

    test_n = datasets.SYNTHETIC_TEST
    fused_dense.LAUNCHES = 0  # the main path's run starts here
    fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)
    main = TrainRun(os.path.join(work, f"{tag}-dev-main"), data_dir, tag,
                    True, "--training_iter", str(TRAIN_STEPS), *args,
                    mode="sync")
    launches = fused_dense.LAUNCHES  # ... and ends here
    by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
    want = WARMUP_STEPS + forwards(0, TRAIN_STEPS, 100, test_n)
    res = main.result
    for line in main.out.splitlines():
        if line.startswith(("job: ", "test accuracy")):
            say("device", f"{tag}: {line}")
    acc = res.test_metrics["accuracy"]
    say("device", f"{tag}: {TRAIN_STEPS} device-resident steps with "
                  f"--pallas, default keep_prob: test accuracy {acc:.4f} "
                  f"(need >= {ACCURACY_MIN}); kernel launches {launches} "
                  f"{by_variant} for {want} forward passes ({WARMUP_STEPS} "
                  f"warm-up steps, {TRAIN_STEPS} replays, display evals, "
                  f"test eval)")
    if res.final_step != TRAIN_STEPS or not acc >= ACCURACY_MIN:
        raise AssertionError(f"{tag}: step {res.final_step}, test accuracy "
                             f"{acc}")
    if launches != want or by_variant != {"tma": want, "simt": 0}:
        raise AssertionError(f"{tag}: {launches} launches {by_variant} for "
                             f"{want} forward passes, all to be tma")

    # one profiled chunk: the kernel found on the device, once per step
    prof_dir = os.path.join(work, f"{tag}-dev-prof")
    prof = TrainRun(prof_dir, data_dir, tag, True, "--training_iter",
                    str(2 * CHUNK), "--display_step", str(20 * CHUNK),
                    "--test_eval", "false", "--profile_dir",
                    os.path.join(prof_dir, "trace"), "--profile_steps",
                    str(CHUNK), *args, mode="sync")
    on_device, idle = device_kernels(os.path.join(prof_dir, "trace",
                                                  "trace.json"))
    busy = prof.result.device_busy_share
    for line in prof.out.splitlines():
        if line.strip() and not line.startswith(("job: ", "Optim")):
            say("profile", f"{tag} device-resident | {line}")
    say("device", f"{tag}: a profiled chunk of {CHUNK} replayed steps ran "
                  f"the kernel {on_device} on the device (torch.profiler, by "
                  f"kernel name); device busy share "
                  f"{'not measured' if busy is None else f'{busy:.4f}'}; "
                  f"idle between kernels per step: "
                  f"{idle['inside_us'] / CHUNK:.2f} us inside the step's "
                  f"graph, {idle['boundary_us'] / CHUNK:.2f} us at the "
                  f"boundaries between replays ({idle['boundaries']} "
                  f"boundaries in the trace)")
    if on_device != {"tma": CHUNK, "simt": 0}:
        raise AssertionError(f"{tag}: a chunk of {CHUNK} replays must run "
                             f"the tma kernel {CHUNK} times, ran {on_device}")

    # a resume from a step off a chunk boundary realigns to the display
    res_dir = os.path.join(work, f"{tag}-dev-resume")
    first = TrainRun(res_dir, data_dir, tag, True, "--training_iter",
                     str(RESUME_AT[0]), "--test_eval", "false", *args,
                     mode="sync")
    again = TrainRun(res_dir, data_dir, tag, True, "--training_iter",
                     str(RESUME_AT[1]), "--test_eval", "false", *args,
                     mode="sync")
    # the log holds both runs: the second's records start at its restore
    restored = again.records("recovery_restore_step").get(RESUME_AT[0])
    shown = sorted(s for s in again.records("mini_batch_loss")
                   if s >= RESUME_AT[0])
    say("device", f"{tag}: stopped at {first.result.final_step}, resumed "
                  f"from {restored} to {again.result.final_step}, display "
                  f"steps {shown}")
    if first.result.final_step != RESUME_AT[0] or \
            restored != RESUME_AT[0] or \
            again.result.final_step != RESUME_AT[1] or \
            shown != [s for s in range(*RESUME_AT) if s % 100 == 0]:
        raise AssertionError(f"{tag}: the resume from step {RESUME_AT[0]} "
                             f"did not realign to the display step")
    out.update(launches=launches, accuracy=acc, busy_share=busy,
               on_device=on_device, idle=idle)
    return out


def phase_device_times(card: str, work: str, data_dir: str, port: int,
                       host: dict, device: dict) -> dict:
    """images/s/GPU of the device-resident path and phase 5's host-fed
    path (both --pallas), in turns: host, device, device, host."""
    args = sync_args(port)
    rates = {}
    for tag in DTYPES:
        for i, resident in enumerate((False, True, True, False)):
            logdir = os.path.join(work, f"{tag}-turn-{i}")
            if resident:
                run = TrainRun(logdir, data_dir, tag, True, "--training_iter",
                               str(DEVICE_TIME_STEPS), "--display_step",
                               str(30 * CHUNK), "--test_eval", "false",
                               *args, mode="sync")
            else:
                run = TrainRun(logdir, data_dir, tag, True, "--training_iter",
                               str(TIME_STEPS), "--display_step",
                               str(10 * TIME_STEPS), "--test_eval", "false")
            rates.setdefault((tag, resident), []).append(
                run.result.images_per_sec_per_chip)
            last = run.result.final_step
            split = {k: run.records(f"step_{k}_s")[last] * 1e3
                     for k in ("host_wait", "dispatch", "device")}
            say("times", f"{tag} {'device-resident' if resident else 'host-fed'}"
                         f" --pallas run {i}: "
                         f"{run.result.images_per_sec_per_chip:.1f} "
                         f"images/s/GPU; per step: " + ", ".join(
                             f"{k} {v:.4f} ms" for k, v in split.items())
                         + " (StepTimer)")
        for resident in (False, True):
            per = rates[(tag, resident)]
            mean = sum(per) / len(per)
            busy = (device[tag]["busy_share"] if resident
                    else host[(tag, True)]["busy_share"])
            rates[(tag, resident)] = {"images_per_sec": per,
                                      "ms_per_step": 128e3 / mean,
                                      "busy_share": busy}
            say("times", f"{tag} {'device-resident' if resident else 'host-fed'}"
                         f" --pallas: {', '.join(f'{r:.1f}' for r in per)} "
                         f"images/s/GPU (mean {mean:.1f}, "
                         f"{128e3 / mean:.4f} ms/step); device busy share "
                         f"{'not measured' if busy is None else f'{busy:.4f}'}"
                         f" (torch.profiler) | {card}")
    return rates


def resnet_graph_vs_eager(tag: str, mesh, data) -> dict:
    """Phase 9: 20 ResNet-20 device steps with --augment replayed from a
    CUDA graph against 20 eager device steps, each from the seed-0 init,
    on the same draws (batches, crops and flips), with cuDNN's
    deterministic algorithms: losses, parameters and running stats."""
    runs = {}
    aug = make_augment(CIFAR_META)
    torch.backends.cudnn.deterministic = True
    try:
        for graph in (True, False):
            model = ResNet20(compute_dtype=(torch.bfloat16 if tag == "bf16"
                                            else None))
            opt = train_state.adam(1e-3)
            state = train_state.create_train_state(model, opt, seed=0,
                                                   device="cuda")
            state = state._replace(step=state.step.cuda())
            step_fn = make_device_dp_train_step(model, opt, mesh, data, 128,
                                                graph=graph, augment_fn=aug)
            losses = {}
            for s in range(TRAJ_STEPS):
                state, m = step_fn(state, s, 1)
                losses[s] = float(m["loss"])
            runs[graph] = (losses, params_to_numpy(model),
                           state_to_numpy(model))
    finally:
        torch.backends.cudnn.deterministic = False
    (replayed, p_graph, s_graph), (eager, p_eager, s_eager) = \
        runs[True], runs[False]
    same = {"losses": replayed == eager,
            "params": all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(p_graph), tree_leaves(p_eager))),
            "bn_stats": all(np.array_equal(a, b) for a, b in zip(
                tree_leaves(s_graph), tree_leaves(s_eager)))}
    moved = float(np.abs(s_graph["stem"]["bn"]["mean"]).max())
    say("resnet", f"{tag}: {TRAJ_STEPS} ResNet-20 --augment steps replayed "
                  f"from a CUDA graph vs eager device steps: loss "
                  f"{eager[0]:.6f} -> {eager[TRAJ_STEPS - 1]:.6f}; bitwise "
                  f"equal: {same}; max |stem bn mean| {moved:.4f}")
    if not all(same.values()) or not moved > 0:
        raise AssertionError(f"{tag}: the ResNet graph's steps differ from "
                             f"eager steps ({same})")
    return same


def phase_resnet(tag: str, work: str, data_dir: str, mesh, data) -> dict:
    """Phase 9: host-fed --augment training to the bar, the checkpoint's
    model_state restored and resumed, graph replays against eager."""
    launched = fused_dense.LAUNCHES
    logdir = os.path.join(work, f"{tag}-resnet")
    main = TrainRun(logdir, data_dir, tag, False, *RESNET_ARGS, "--augment",
                    "--training_iter", str(RESNET_STEPS))
    res = main.result
    for line in main.out.splitlines():
        if line.startswith(("job: ", "test accuracy")):
            say("resnet", f"{tag}: {line}")
    acc = res.test_metrics["accuracy"]
    say("resnet", f"{tag}: {RESNET_STEPS} host-fed --augment steps (adam "
                  f"1e-3, batch 128): test accuracy {acc:.4f} (need >= "
                  f"{RESNET_ACCURACY_MIN[tag]}); {res.images_per_sec:.1f} "
                  f"images/s")
    if res.final_step != RESNET_STEPS or \
            not acc >= RESNET_ACCURACY_MIN[tag]:
        raise AssertionError(f"{tag}: ResNet-20 step {res.final_step}, test "
                             f"accuracy {acc}")

    # the final checkpoint's running stats restore bitwise ...
    model = ResNet20(compute_dtype=torch.bfloat16 if tag == "bf16" else None)
    template = train_state.create_train_state(model, train_state.adam(1e-3))
    restored = restore_with_fallback(logdir, template)
    saved = np.load(os.path.join(logdir, f"ckpt-{RESNET_STEPS}.npz"))
    keys = [k for k in saved.files if k.startswith("model_state/")]
    got = flatten_pytree(restored[0]) if restored is not None else {}
    if restored is None or restored[1] != RESNET_STEPS or len(keys) != 42 \
            or any(not np.array_equal(got[k], saved[k]) for k in keys) \
            or not np.abs(got["model_state/stem/bn/mean"]).max() > 0:
        raise AssertionError(f"{tag}: the final checkpoint's model_state did "
                             f"not restore")
    # ... and a resumed run normalizes its test eval by them
    stop = RESNET_STEPS + RESNET_RESUME_STEPS
    again = TrainRun(logdir, data_dir, tag, False, *RESNET_ARGS, "--augment",
                     "--training_iter", str(stop))
    resumed = again.records("recovery_restore_step").get(RESNET_STEPS)
    acc2 = again.result.test_metrics["accuracy"]
    say("resnet", f"{tag}: {len(keys)} model_state arrays restored bitwise; "
                  f"resumed from step {resumed} to "
                  f"{again.result.final_step}, test accuracy {acc2:.4f}")
    if resumed != RESNET_STEPS or again.result.final_step != stop or \
            not acc2 >= RESNET_ACCURACY_MIN[tag]:
        raise AssertionError(f"{tag}: the ResNet resume lost its state")
    same = resnet_graph_vs_eager(tag, mesh, data)
    if fused_dense.LAUNCHES != launched:
        raise AssertionError("the ResNet path launched fused_dense_relu")
    return {"accuracy": acc, "resumed_accuracy": acc2, "graph_bitwise": same}


def trace_kernels(trace_path: str, steps: int) -> dict:
    """From a ``torch.profiler`` Chrome trace: kernels per step, the idle
    time between kernels per step, and the top kernels by device time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    idle, end, by_name = 0.0, None, {}
    for e in kernels:
        if end is not None and e["ts"] > end:
            idle += e["ts"] - end
        end = max(end or 0.0, e["ts"] + e["dur"])
        name = e.get("name", "")[:90]
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"kernels_per_step": len(kernels) / steps,
            "idle_us_per_step": idle / steps,
            "busy_us_per_step": sum(by_name.values()) / steps,
            "top_us_per_step": [(n, t / steps) for n, t in top]}


def phase_resnet_times(card: str, work: str, data_dir: str,
                       port: int) -> dict:
    """Phase 9: images/s/GPU and ms/step of ResNet-20 device-resident at
    the bench recipe and host-fed at batch 128, in turns (host, device,
    device, host), then one profiled window of each."""
    sync = sync_args(port)
    rates = {}

    def run(tag, path, logdir, steps, *extra):
        args = ["--training_iter", str(steps), "--display_step",
                str(10 * steps), "--test_eval", "false", "--batch_size",
                str(RESNET_BATCH[path]), *RESNET_ARGS, *RESNET_BENCH, *extra]
        if path == "device":  # extra flags after the sync ones win
            return TrainRun(logdir, data_dir, tag, False, *sync, *args,
                            mode="sync")
        return TrainRun(logdir, data_dir, tag, False, *args)

    for tag in DTYPES:
        for i, path in enumerate(("host", "device", "device", "host")):
            r = run(tag, path, os.path.join(work, f"{tag}-rn-turn-{i}"),
                    RESNET_TIME_STEPS[path])
            rates.setdefault((tag, path), []).append(
                r.result.images_per_sec_per_chip)
            last = r.result.final_step
            split = {k: r.records(f"step_{k}_s")[last] * 1e3
                     for k in ("host_wait", "dispatch", "device")}
            say("times", f"{tag} ResNet-20 {path} run {i}: "
                         f"{r.result.images_per_sec_per_chip:.1f} "
                         f"images/s/GPU; per step: " + ", ".join(
                             f"{k} {v:.4f} ms" for k, v in split.items())
                         + " (StepTimer)")
        for path in ("host", "device"):
            steps = RESNET_PROFILE_STEPS
            prof_dir = os.path.join(work, f"{tag}-rn-prof-{path}")
            r = run(tag, path, prof_dir, 2 * steps, "--device_chunk",
                    str(steps), "--profile_dir",
                    os.path.join(prof_dir, "trace"), "--profile_steps",
                    str(steps))
            busy = r.result.device_busy_share
            tk = trace_kernels(os.path.join(prof_dir, "trace", "trace.json"),
                               steps)
            for line in r.out.splitlines():
                if line.strip() and not line.startswith(("job: ", "Optim")):
                    say("profile", f"{tag} ResNet-20 {path} | {line}")
            per = rates[(tag, path)]
            mean = sum(per) / len(per)
            ms = RESNET_BATCH[path] * 1e3 / mean
            rates[(tag, path)] = {"images_per_sec": per, "ms_per_step": ms,
                                  "busy_share": busy, **tk}
            say("times", f"{tag} ResNet-20 {path} (batch "
                         f"{RESNET_BATCH[path]}, momentum 0.1): "
                         f"{', '.join(f'{v:.1f}' for v in per)} images/s/GPU "
                         f"(mean {mean:.1f}, {ms:.4f} ms/step); device busy "
                         f"share {'not measured' if busy is None else f'{busy:.4f}'}"
                         f" over {steps} steps (torch.profiler); "
                         f"{tk['kernels_per_step']:.1f} kernels/step, "
                         f"{tk['busy_us_per_step']:.1f} us busy and "
                         f"{tk['idle_us_per_step']:.1f} us idle between "
                         f"kernels per step | {card}")
            for name, us in tk["top_us_per_step"]:
                say("times", f"{tag} ResNet-20 {path} top kernel: "
                             f"{us:.2f} us/step {name}")
    return rates


def _wait_for(proc, path: str, text: str, timeout: float) -> None:
    """Until ``text`` appears in the output file of ``proc``; raises if the
    process exits first or the time runs out."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path) as f:
            out = f.read()
        if text in out:
            return
        if proc.poll() is not None:
            raise AssertionError(f"{path}: exited {proc.returncode} before "
                                 f"{text!r}:\n{out[-3000:]}")
        time.sleep(0.2)
    raise AssertionError(f"{path}: no {text!r} within {timeout} s")


def cuda_pids() -> set[int]:
    """The pids that hold a CUDA context, by ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return {int(w) for w in out.split() if w.strip().isdigit()}


def nvidia_device_fds(pid: int) -> list[str]:
    """The GPU device nodes (``/dev/nvidia<N>``) that process ``pid`` has
    open: a process with a CUDA context holds its card's."""
    found = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if re.fullmatch(r"/dev/nvidia\d+", target):
            found.add(target)
    return sorted(found)


SUMMARY = "ps worker summary: "


def _summary(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith(SUMMARY)]
    if len(lines) != 1:
        raise AssertionError(f"expected one {SUMMARY!r} line, got {lines}")
    return json.loads(lines[0][len(SUMMARY):])


def ps_run(work: str, data_dir: str, name: str, wire: str, workers: int,
           steps: int, *extra: str, worker0: tuple[str, ...] = ()) -> dict:
    """One run of the ps topology through the reference's command line:
    ps/0 and workers 1.. as ``python -m ...mnist_dist`` subprocesses on
    127.0.0.1 ports, worker/0 in this process through the same
    ``mnist_dist.main`` once the others report ready, its kernel launches
    counted; ``worker0`` holds flags for worker/0 alone. Checks, while
    the ps still serves, that it holds no CUDA context; then shuts it
    down."""
    logdir = os.path.join(work, name)
    ps_addr = f"127.0.0.1:{free_port()}"
    hosts = ",".join(f"127.0.0.1:{free_port()}" for _ in range(workers))
    common = ["--ps_hosts", ps_addr, "--worker_hosts", hosts, "--device",
              "cuda", "--logdir", logdir, "--data_dir", data_dir,
              "--optimizer", "adam", "--learning_rate", "0.001",
              "--batch_size", "128", "--pallas", "--training_iter",
              str(steps), *PS_WIRE_ARGS[wire], *extra]
    procs = []

    def launch(job: str, i: int):
        out = os.path.join(work, f"{name}-{job}{i}.out")
        with open(out, "w") as f:
            p = subprocess.Popen(
                [sys.executable, "-m",
                 "distributed_tensorflow_tpu_torch.mnist_dist",
                 f"--job_name={job}", f"--task_index={i}", *common],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
        procs.append(p)
        return p, out

    t0 = time.perf_counter()
    try:
        # the workers start with the ps: a worker's client retries its
        # connection until the ps serves
        ps, ps_out = launch("ps", 0)
        others = [launch("worker", i) for i in range(1, workers)]
        _wait_for(ps, ps_out, "ps/0 serving at", PS_READY_S)
        for p, out in others:
            _wait_for(p, out, "waiting for the chief's initialization",
                      PS_READY_S)
        flags.define_reference_flags()
        flags.FLAGS._reset()
        flags.FLAGS._parse(["--job_name=worker", "--task_index=0", *common,
                            *worker0])
        buf = io.StringIO()
        fused_dense.LAUNCHES = 0  # the main path's run starts here
        fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)
        with contextlib.redirect_stdout(buf):
            rc = mnist_dist.main([])
        launches = fused_dense.LAUNCHES  # ... and ends here
        by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
        if rc != 0:
            raise AssertionError(f"{name}: worker/0 returned {rc}")
        ps_cuda = {"nvidia_smi": ps.pid in cuda_pids(),
                   "device_fds": nvidia_device_fds(ps.pid),
                   "worker0_visible": os.getpid() in cuda_pids(),
                   "worker0_fds": nvidia_device_fds(os.getpid())}
        texts = [buf.getvalue()]
        for p, out in others:
            p.wait(timeout=PS_READY_S)
            with open(out) as f:
                texts.append(f.read())
            if p.returncode != 0:
                raise AssertionError(f"{out}: exit {p.returncode}\n"
                                     f"{texts[-1][-3000:]}")
        stop = PSClient([ps_addr])
        stop.shutdown_all()
        stop.close()
        ps.wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    wall = time.perf_counter() - t0
    if ps.returncode != 0:
        raise AssertionError(f"{name}: ps/0 exit {ps.returncode}")
    if ps_cuda["nvidia_smi"] or ps_cuda["device_fds"]:
        raise AssertionError(f"{name}: the ps process holds a CUDA context "
                             f"({ps_cuda})")
    acc = re.search(r"^test accuracy:  (\S+) test loss:  (\S+)$",
                    texts[0], re.M)
    return {"logdir": logdir, "texts": texts, "wall_s": wall,
            "summaries": [_summary(t) for t in texts],
            "launches": launches, "by_variant": by_variant,
            "ps_cuda": ps_cuda,
            "test": (float(acc.group(1)), float(acc.group(2))) if acc
            else None}


def phase_ps(tag: str, work: str, data_dir: str) -> dict:
    """Phase 10: two workers to test accuracy within PS_STEPS global steps
    (the mirror cycle, cadenced background checkpoints), worker/0's
    kernel launches against its forward passes, the ps without a CUDA
    context, and the final checkpoint through --eval_only and the
    inspect CLI."""
    run = ps_run(work, data_dir, f"{tag}-ps-main", tag, 2, PS_STEPS,
                 "--save_model_secs", "2")
    s0, s1 = run["summaries"]
    for line in run["texts"][0].splitlines():
        if line.startswith(("job: ", "test accuracy")):
            say("ps", f"{tag}: {line}")
    acc, loss = run["test"]
    test_batches = math.ceil(datasets.SYNTHETIC_TEST / EVAL_BATCH)
    want = s0["cycles"] + s0["displays"] + test_batches
    final = latest_checkpoint(run["logdir"])
    say("ps", f"{tag}: 2 workers, {PS_STEPS} global steps, --ps_wire "
              f"{'bf16' if tag == 'bf16' else 'f32'}: test accuracy "
              f"{acc:.4f} (need >= {ACCURACY_MIN}); worker/0 {s0['cycles']} "
              f"cycles, worker/1 {s1['cycles']}; worker/0's kernel launches "
              f"{run['launches']} {run['by_variant']} for {want} forward "
              f"passes ({s0['cycles']} cycles, {s0['displays']} display "
              f"evals, {test_batches} test-eval batches); final step "
              f"{final[1] if final else None}; the ps and CUDA: "
              f"{run['ps_cuda']}; {run['wall_s']:.1f} s")
    if not acc >= ACCURACY_MIN or final is None or final[1] < PS_STEPS:
        raise AssertionError(f"{tag}: ps run reached test accuracy {acc}, "
                             f"final checkpoint {final}")
    if s0["cycles"] + s1["cycles"] < PS_STEPS or not s1["cycles"]:
        raise AssertionError(f"{tag}: the workers ran {s0['cycles']} and "
                             f"{s1['cycles']} cycles")
    if run["launches"] != want or run["by_variant"] != {"tma": want,
                                                        "simt": 0}:
        raise AssertionError(f"{tag}: worker/0 launched {run['launches']} "
                             f"{run['by_variant']} for {want} forward "
                             f"passes, all to be tma")

    # the final checkpoint restores through --eval_only to what the run
    # printed; the inspect CLI verifies every set the background writer
    # and the final save left
    flags.FLAGS._reset()
    flags.FLAGS._parse(["--eval_only", "--logdir", run["logdir"],
                        "--data_dir", data_dir, "--device", "cuda",
                        "--pallas", *(("--bf16",) if tag == "bf16" else ())])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m = evaluate_only(flags.FLAGS)
        verify = ckpt_inspect.main(["--verify", "--logdir", run["logdir"]])
    for line in buf.getvalue().splitlines():
        say("ps", f"{tag}: eval_only/inspect | {line}")
    if verify != 0 or m["accuracy"] != acc or \
            not math.isclose(m["loss"], loss, rel_tol=1e-5):
        raise AssertionError(f"{tag}: --eval_only read {m} from the final "
                             f"checkpoint, the run printed {acc}, {loss}; "
                             f"inspect --verify exit {verify}")
    steps_saved = sorted(int(n[5:-4]) for n in os.listdir(run["logdir"])
                         if re.fullmatch(r"ckpt-\d+\.npz", n))
    say("ps", f"{tag}: checkpoints in the logdir at steps {steps_saved} "
              f"(cadenced ones from the background writer, the last the "
              f"synchronous final save)")
    return {"launches": run["launches"], "accuracy": acc,
            "cycles": [s0["cycles"], s1["cycles"]],
            "ps_cuda": run["ps_cuda"]}


def phase_ps_mirror_vs_full(work: str, data_dir: str) -> dict:
    """One worker, keep_prob 1, the same batches: PS_TRAJ_STEPS cycles with
    the mirror against as many serial full pulls, each from the seed-0
    init, with cuDNN's deterministic algorithms; the final ps params."""
    final = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("mirror", ()),
                            ("full", ("--ps_mirror=false",
                                      "--ps_prefetch=false"))):
            run = ps_run(work, data_dir, f"f32-ps-traj-{name}", "f32", 1,
                         PS_TRAJ_STEPS, "--keep_prob", "1", "--test_eval",
                         "false", "--display_step", str(10 * PS_TRAJ_STEPS),
                         "--save_model_secs", "100000", *extra)
            path, step = latest_checkpoint(run["logdir"])
            if step != PS_TRAJ_STEPS:
                raise AssertionError(f"{name}: final step {step}")
            final[name] = load_flat(path)
    finally:
        torch.backends.cudnn.deterministic = False
    worst = max(float(np.abs(final["mirror"][k] - final["full"][k]).max()
                      / max(float(np.abs(final["full"][k]).max()), 1e-30))
                for k in final["full"] if k.startswith("params/"))
    bitwise = all(np.array_equal(final["mirror"][k], final["full"][k])
                  for k in final["full"])
    say("ps", f"f32: one worker, {PS_TRAJ_STEPS} cycles with --ps_mirror vs "
              f"--ps_mirror=false, keep_prob 1: final ps params max "
              f"|diff|/scale {worst:.3e} (tolerance {PS_TRAJ_TOL}); bitwise "
              f"{'equal' if bitwise else 'different'}")
    if not worst <= PS_TRAJ_TOL:
        raise AssertionError("the mirror's trajectory leaves the full "
                             "pull's")
    return {"max_rel_diff": worst, "bitwise": bitwise}


def phase_ps_times(card: str, work: str, data_dir: str) -> dict:
    """Global steps/s, images/s over both workers and worker/0's per-cycle
    split, with the mirror on and off, on the f32 and the bf16 wire, in
    turns (on, off, off, on); the first turn of each configuration
    profiles PS_PROFILE_CYCLES of worker/0's cycles (its busy share),
    which stay out of its timed window; worker/1 is never profiled."""
    rows = {}
    for wire in PS_WIRE_ARGS:
        for i, mirror in enumerate((True, False, False, True)):
            name = f"{wire}-ps-turn-{i}"
            extra = () if mirror else ("--ps_mirror=false",)
            profile = (("--profile_dir", os.path.join(work, name, "trace"),
                        "--profile_steps", str(PS_PROFILE_CYCLES))
                       if i < 2 else ())
            run = ps_run(work, data_dir, name, wire, 2, PS_TIME_STEPS,
                         "--display_step", str(100 * PS_TIME_STEPS),
                         "--test_eval", "false", "--save_model_secs",
                         "100000", *extra, worker0=profile)
            s0, s1 = run["summaries"]
            split = {k: s0[f"step_{k}_s"] * 1e3
                     for k in ("pull", "upload", "grad", "download", "push")}
            row = {"global_steps_per_sec": s0["global_steps_per_sec"],
                   "images_per_sec": s0["images_per_sec"]
                   + s1["images_per_sec"],
                   "split_ms": split, "busy_share": s0["device_busy_share"],
                   "cycles": [s0["cycles"], s1["cycles"]]}
            rows.setdefault((wire, mirror), []).append(row)
            say("times", f"ps {wire} wire, mirror {'on ' if mirror else 'off'}"
                         f" run {i}: {row['global_steps_per_sec']:.2f} global "
                         f"steps/s, {row['images_per_sec']:.1f} images/s over "
                         f"2 workers ({s0['images_per_sec']:.1f} + "
                         f"{s1['images_per_sec']:.1f}); worker/0 per cycle: "
                         + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in split.items())
                         + f" (StepTimer, {s0['timed_cycles']} cycles)"
                         + ("" if row["busy_share"] is None else
                            f"; device busy share {row['busy_share']:.4f} "
                            f"over {PS_PROFILE_CYCLES} cycles "
                            f"(torch.profiler)") + f" | {card}")
    return rows


def phase_times(card: str, served: dict) -> dict:
    for tag, run in served.items():
        lat = run["latency_ms"]
        say("times", f"{tag} serving: request p50 {lat['p50']:.3f} ms, p99 "
                     f"{lat['p99']:.3f} ms over {int(lat['count'])} HTTP "
                     f"predicts (batcher histogram) | {card}")
    times = {}
    for tag, dtype in DTYPES.items():
        for shape in SHAPES:
            one = inputs(shape, dtype, seed=1, device="cpu")
            per_call = sum(t.numel() for t in one) * one[0].element_size()
            n_buf = max(1, min(64, math.ceil(2 * L2_BYTES / per_call)))
            bufs = [tuple(t.cuda() for t in inputs(shape, dtype, seed=i))
                    for i in range(n_buf)]
            reps = max(100, n_buf)
            row = {"ms": graph_ms(fused_dense_relu, bufs, reps),
                   "plain_ms": graph_ms(fused_dense_relu_reference, bufs,
                                        reps),
                   "library_ms": graph_ms(library_call, bufs, reps)}
            row["bound_ms"], row["bound_by"] = bound(shape, dtype)
            times[(tag, shape)] = row
            say("times", f"{tag} {shape}: kernel {row['ms'] * 1e3:.2f} us, "
                         f"plain {row['plain_ms'] * 1e3:.2f} us, addmm+relu_ "
                         f"{row['library_ms'] * 1e3:.2f} us, bound "
                         f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); "
                         f"{n_buf} rotating buffers | {card}")
            del bufs
    return times


def zero_args(name: str) -> tuple[str, ...]:
    level, overlap = ZERO[name]
    return ("--zero", str(level)) + (("--zero_overlap",) if overlap else ())


def zero_vs_dp_replays(tag: str, mesh, data) -> dict:
    """Phase 11 (a): 20 graph-replayed device steps of each ZeRO
    configuration against 20 of the replicated device step, each from the
    seed-0 init on the same draws (dropout on), cuDNN deterministic: the
    losses and the standard-layout state, optimizer slots included."""
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, (level, overlap) in ZERO.items():
            model = DeepCNN(compute_dtype=(torch.bfloat16 if tag == "bf16"
                                           else None), use_pallas=True)
            opt = train_state.adam(1e-3)
            state = train_state.create_train_state(model, opt, seed=0,
                                                   device="cuda")
            state = state._replace(step=state.step.cuda())
            if level:
                state = shard_state_zero(state, mesh, level)
                step_fn = make_zero_device_train_step(
                    model, opt, mesh, level, data, 128, keep_prob=0.75,
                    overlap=overlap)
            else:
                step_fn = make_device_dp_train_step(model, opt, mesh, data,
                                                    128, keep_prob=0.75)
            losses = {}
            for s in range(TRAJ_STEPS):
                state, m = step_fn(state, s, 1)
                losses[s] = float(m["loss"])
            if level:
                state = fetch_state_zero(state, model, mesh, level)
            runs[name] = (losses, flatten_pytree(state))
    finally:
        torch.backends.cudnn.deterministic = False
    dp_losses, dp_flat = runs["zero 0"]
    same = {}
    for name in list(ZERO)[1:]:
        losses, flat = runs[name]
        same[name] = (losses == dp_losses and sorted(flat) == sorted(dp_flat)
                      and all(np.array_equal(flat[k], dp_flat[k])
                              for k in dp_flat))
    say("zero", f"{tag}: {TRAJ_STEPS} graph-replayed steps vs the replicated "
                f"step's, keep_prob 0.75: loss {dp_losses[0]:.6f} -> "
                f"{dp_losses[TRAJ_STEPS - 1]:.6f}; losses and state (params, "
                f"optimizer slots, step) bitwise equal: {same}")
    if not all(same.values()):
        raise AssertionError(f"{tag}: a ZeRO step left the replicated "
                             f"step's trajectory ({same})")
    return same


def phase_zero(tag: str, work: str, data_dir: str, mesh, data,
               port: int) -> dict:
    """Phase 11 (a)-(c): replays against DP, the main path to accuracy
    with its launches, resumes across the two layouts."""
    out = {"bitwise": zero_vs_dp_replays(tag, mesh, data)}
    args = sync_args(port) + zero_args("zero 3 overlap")
    test_n = datasets.SYNTHETIC_TEST
    fused_dense.LAUNCHES = 0  # the main path's run starts here
    fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)
    main = TrainRun(os.path.join(work, f"{tag}-zero-main"), data_dir, tag,
                    True, "--training_iter", str(TRAIN_STEPS), *args,
                    mode="sync")
    launches = fused_dense.LAUNCHES  # ... and ends here
    by_variant = dict(fused_dense.LAUNCHES_BY_VARIANT)
    want = WARMUP_STEPS + forwards(0, TRAIN_STEPS, 100, test_n)
    res = main.result
    for line in main.out.splitlines():
        if line.startswith(("job: ", "test accuracy", "--zero")):
            say("zero", f"{tag}: {line}")
    acc = res.test_metrics["accuracy"]
    say("zero", f"{tag}: {TRAIN_STEPS} steps of --zero 3 --zero_overlap "
                f"--device_data --pallas, default keep_prob: test accuracy "
                f"{acc:.4f} (need >= {ACCURACY_MIN}); kernel launches "
                f"{launches} {by_variant} for {want} forward passes "
                f"({WARMUP_STEPS} warm-up steps, {TRAIN_STEPS} replays, "
                f"display evals, test eval)")
    if res.final_step != TRAIN_STEPS or not acc >= ACCURACY_MIN:
        raise AssertionError(f"{tag}: step {res.final_step}, test accuracy "
                             f"{acc}")
    if launches != want or by_variant != {"tma": want, "simt": 0}:
        raise AssertionError(f"{tag}: {launches} launches {by_variant} for "
                             f"{want} forward passes, all to be tma")

    # each layout's final checkpoint resumed by the other layout and by
    # its own, 10 steps; the pairs' checkpoints must be bitwise equal
    stop = TRAIN_STEPS + RESUME_STEPS
    resumed = {}
    torch.backends.cudnn.deterministic = True
    try:
        for src, names in ((f"{tag}-dev-main", ("zero 1", "zero 0")),
                           (f"{tag}-zero-main",
                            ("zero 0", "zero 3 overlap"))):
            finals = []
            for name in names:
                logdir = os.path.join(work, f"{src}-by-{name}".replace(" ",
                                                                       "-"))
                shutil.copytree(os.path.join(work, src), logdir)
                run = TrainRun(logdir, data_dir, tag, True, "--training_iter",
                               str(stop), "--test_eval", "false",
                               *sync_args(port), *zero_args(name),
                               mode="sync")
                if run.records("recovery_restore_step").get(TRAIN_STEPS) != \
                        TRAIN_STEPS or run.result.final_step != stop:
                    raise AssertionError(f"{tag}: {name} did not resume "
                                         f"{src} from step {TRAIN_STEPS}")
                finals.append(load_flat(os.path.join(logdir,
                                                     f"ckpt-{stop}.npz")))
            a, b = finals
            resumed[f"{src} by {' and '.join(names)}"] = (
                sorted(a) == sorted(b)
                and all(np.array_equal(a[k], b[k]) for k in a))
    finally:
        torch.backends.cudnn.deterministic = False
    say("zero", f"{tag}: checkpoints at step {TRAIN_STEPS} resumed to "
                f"{stop}, cuDNN deterministic; final states bitwise equal: "
                f"{resumed}")
    if not all(resumed.values()):
        raise AssertionError(f"{tag}: a resume across the layouts differs "
                             f"({resumed})")
    out.update(launches=launches, accuracy=acc, resumed=resumed)
    return out


def phase_zero_times(card: str, work: str, data_dir: str, port: int,
                     device: dict) -> dict:
    """Phase 11 (d): images/s/GPU of zero 0, 1, 3 and 3 overlapped in
    turns (0, 1, 3, 3o, 3o, 3, 1, 0), and each ZeRO configuration's busy
    share over a profiled chunk whose trace must hold the kernel once per
    step; zero 0's busy share is phase 8's."""
    rates = {}
    order = list(ZERO) + list(ZERO)[::-1]
    for tag in DTYPES:
        busy = {"zero 0": device[tag]["busy_share"]}
        for name in list(ZERO)[1:]:
            prof_dir = os.path.join(work, f"{tag}-zprof-{name}".replace(
                " ", "-"))
            prof = TrainRun(prof_dir, data_dir, tag, True, "--training_iter",
                            str(2 * CHUNK), "--display_step", str(20 * CHUNK),
                            "--test_eval", "false", "--profile_dir",
                            os.path.join(prof_dir, "trace"),
                            "--profile_steps", str(CHUNK), *sync_args(port),
                            *zero_args(name), mode="sync")
            on_device, idle = device_kernels(os.path.join(prof_dir, "trace",
                                                          "trace.json"))
            busy[name] = prof.result.device_busy_share
            say("zero", f"{tag} {name}: a profiled chunk of {CHUNK} replays "
                        f"ran the kernel {on_device} (by kernel name); busy "
                        f"share {busy[name]}; idle per step "
                        f"{idle['inside_us'] / CHUNK:.2f} us inside the "
                        f"graph, {idle['boundary_us'] / CHUNK:.2f} us at the "
                        f"boundaries")
            if on_device != {"tma": CHUNK, "simt": 0}:
                raise AssertionError(f"{tag} {name}: a chunk of {CHUNK} "
                                     f"replays ran the kernel {on_device}")
        for i, name in enumerate(order):
            run = TrainRun(os.path.join(work, f"{tag}-zturn-{i}"), data_dir,
                           tag, True, "--training_iter",
                           str(DEVICE_TIME_STEPS), "--display_step",
                           str(30 * CHUNK), "--test_eval", "false",
                           *sync_args(port), *zero_args(name), mode="sync")
            rates.setdefault((tag, name), []).append(
                run.result.images_per_sec_per_chip)
        for name in ZERO:
            per = rates[(tag, name)]
            mean = sum(per) / len(per)
            rates[(tag, name)] = {"images_per_sec": per,
                                  "ms_per_step": 128e3 / mean,
                                  "busy_share": busy[name]}
            say("times", f"{tag} device-resident --pallas {name:>14}: "
                         f"{', '.join(f'{r:.1f}' for r in per)} images/s/GPU"
                         f" (mean {mean:.1f}, {128e3 / mean:.4f} ms/step); "
                         f"device busy share "
                         f"{'not measured' if busy[name] is None else f'{busy[name]:.4f}'}"
                         f" (torch.profiler) | {card}")
    return rates


# ------------------------------------------------------------ phase 12: LM


def lm_args(seq_len: int, vocab: int) -> tuple[str, ...]:
    """The LM at bench.py's width (``LM_WIDTH``), ``seq_len`` by
    ``vocab``."""
    return ("--model", "lm", "--dataset", "lm", "--seq_len", str(seq_len),
            "--vocab_size", str(vocab),
            *(a for k, v in LM_WIDTH.items() for a in (f"--{k}", str(v))))


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    from CUDA events around the calls (each ends in its own work)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> float:
    """max |got - want| over max |want|: the error in units of the
    output's scale."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_lm_functions() -> dict:
    """12a: the flash attention and the streamed head against their plain
    versions under autograd, in float32 on the card at the LM's shapes."""
    g = torch.Generator().manual_seed(12)
    q, k, v, do = (torch.randn(LM_ATTN_SHAPE, generator=g).cuda()
                   for _ in range(4))

    def attn_grads(fn):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        return [out.detach()] + list(torch.autograd.grad(out, ts, do))

    def dense(*ts):
        return multi_head_attention(*ts, causal=True)

    def flash(*ts):
        return blockwise_attention(*ts, LM_ATTN_BLOCK, causal=True)

    want, got = attn_grads(dense), attn_grads(flash)
    errs = {n: rel_err(a, b) for n, a, b in
            zip(("out", "dq", "dk", "dv"), got, want)}
    del want, got
    times = {"flash_ms": cuda_ms(lambda: attn_grads(flash)),
             "dense_ms": cuda_ms(lambda: attn_grads(dense))}
    say("lm", f"flash attention vs dense under autograd, f32 "
              f"{LM_ATTN_SHAPE} block {LM_ATTN_BLOCK} causal: errors in "
              f"units of each output's max " + ", ".join(
                  f"{n} {e:.3e}" for n, e in errs.items())
              + f" (tolerance {LM_FN_TOL}); forward+backward "
              f"{times['flash_ms']:.3f} ms flash, {times['dense_ms']:.3f} "
              f"ms dense (CUDA events)")
    rows, d, vocab = LM_HEAD_SHAPE
    h = torch.randn((rows, d), generator=g).cuda()
    w = (torch.randn((d, vocab), generator=g) / d ** 0.5).cuda()
    b = (torch.randn((vocab,), generator=g) * 0.1).cuda()
    y = torch.randint(0, vocab, (rows,), generator=g).cuda()

    def head_grads(streamed):
        ts = [t.clone().requires_grad_() for t in (h, w, b)]
        if streamed:
            loss, acc = streamed_softmax_ce_head(*ts, y, LM_CE_BLOCK)
        else:
            logits = ops_nn.dense(*ts)
            loss = ops_nn.softmax_cross_entropy(logits, y)
            acc = ops_nn.accuracy(logits, y)
        return [loss.detach(), acc] + list(torch.autograd.grad(loss, ts))

    want, got = head_grads(False), head_grads(True)
    head_errs = {n: rel_err(a, bb) for n, a, bb in
                 zip(("loss", "acc", "dh", "dw", "db"), got, want)}
    times.update(streamed_ms=cuda_ms(lambda: head_grads(True)),
                 plain_head_ms=cuda_ms(lambda: head_grads(False)))
    say("lm", f"streamed head vs dense + softmax_cross_entropy + accuracy, "
              f"f32 {rows} rows, d {d}, V {vocab}, block {LM_CE_BLOCK}: "
              + ", ".join(f"{n} {e:.3e}" for n, e in head_errs.items())
              + f" (tolerance {LM_FN_TOL}); forward+backward "
              f"{times['streamed_ms']:.3f} ms streamed, "
              f"{times['plain_head_ms']:.3f} ms plain (CUDA events)")
    worst = max(*errs.values(), *head_errs.values())
    if not worst <= LM_FN_TOL:
        raise AssertionError(f"an LM autograd Function disagrees with its "
                             f"plain version: {errs} {head_errs}")
    return {"max_rel_err": worst, **times}


def lm_train_run(work: str, data_dir: str, name: str, seq_len: int,
                 vocab: int, batch: int, steps: int, *extra: str,
                 tag: str = "bf16"):
    """One LM ``train(FLAGS)`` run, the device's peak memory reset just
    before it: (run, the run's peak bytes above what earlier phases still
    held when it started)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = TrainRun(os.path.join(work, name), data_dir, tag, False,
                   *lm_args(seq_len, vocab), "--learning_rate", "0.001",
                   "--keep_prob", "1.0", "--batch_size", str(batch),
                   "--training_iter", str(steps), "--test_eval", "false",
                   *extra)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    say("lm", f"{name}: peak {peak / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held at its start")
    return run, peak


def lm_rate(run, seq_len: int, batch: int) -> tuple[float, float, dict]:
    """(tokens/s/GPU, ms/step, StepTimer split in ms) of a run's window
    after the warm-up step."""
    rate = run.result.images_per_sec_per_chip * seq_len
    last = run.result.final_step
    split = {k: run.records(f"step_{k}_s")[last] * 1e3
             for k in ("host_wait", "dispatch", "device")}
    return rate, batch * seq_len * 1e3 / rate, split


def phase_lm_train(card: str, work: str, data_dir: str) -> dict:
    """12b, 12c: lm_4k and lm_bigvocab train through train(FLAGS), with
    their rates, peaks and profiles, against the dense attention and the
    unstreamed head in peak memory."""
    out = {}
    # bench.py's LM phases draw from a handful of sequences; LM_SPLIT
    # keeps the 32k-vocab split's generation (an argsort per sequence)
    # out of the phase's time
    saved = datasets.LM_TRAIN, datasets.LM_TEST
    datasets.LM_TRAIN, datasets.LM_TEST = LM_SPLIT
    try:
        flash = ("--attn_block", str(LM_ATTN_BLOCK), "--bf16")
        traj, traj_peak = lm_train_run(work, data_dir, "lm4k-traj", *LM_4K,
                                       LM_4K_BATCH, LM_STEPS, *flash,
                                       "--display_step", "1")
        losses = traj.records("mini_batch_loss")
        seq = [losses[s] for s in range(LM_STEPS)]
        say("lm", f"lm_4k bf16 flash: {LM_STEPS} steps, loss per step "
                  f"{[round(x, 5) for x in seq]}; peak {traj_peak / 2**30:.3f}"
                  f" GiB (display eval every step)")
        if not (all(math.isfinite(x) for x in seq) and seq[-1] < seq[0]):
            raise AssertionError(f"lm_4k: the loss is not finite and "
                                 f"falling: {seq}")
        timed, peak = lm_train_run(work, data_dir, "lm4k-time", *LM_4K,
                                   LM_4K_BATCH, LM_STEPS, *flash,
                                   "--display_step", "1000")
        rate, ms, split = lm_rate(timed, LM_4K[0], LM_4K_BATCH)
        prof_dir = os.path.join(work, "lm4k-prof")
        prof, _ = lm_train_run(work, data_dir, "lm4k-prof", *LM_4K,
                               LM_4K_BATCH, 1 + LM_PROFILE_STEPS, *flash,
                               "--display_step", "1000", "--profile_dir",
                               os.path.join(prof_dir, "trace"),
                               "--profile_steps", str(LM_PROFILE_STEPS))
        tk = trace_kernels(os.path.join(prof_dir, "trace", "trace.json"),
                           LM_PROFILE_STEPS)
        busy = prof.result.device_busy_share
        dense, dense_peak = lm_train_run(work, data_dir, "lm4k-dense",
                                         *LM_4K, LM_4K_BATCH, LM_MEM_STEPS,
                                         "--bf16", "--display_step", "1000")
        say("times", f"lm_4k bf16 flash (batch {LM_4K_BATCH}, seq "
                     f"{LM_4K[0]}): "
                     f"{rate:.1f} tokens/s/GPU, {ms:.3f} ms/step over steps "
                     f"1-{LM_STEPS - 1}; per step " + ", ".join(
                         f"{k} {v:.3f} ms" for k, v in split.items())
                     + f" (StepTimer); peak {peak / 2**30:.3f} GiB; dense "
                     f"attention peak {dense_peak / 2**30:.3f} GiB "
                     f"({dense_peak / peak:.2f}x); busy share "
                     f"{'not measured' if busy is None else f'{busy:.4f}'}, "
                     f"{tk['kernels_per_step']:.1f} kernels, "
                     f"{tk['busy_us_per_step']:.1f} us busy and "
                     f"{tk['idle_us_per_step']:.1f} us idle between kernels "
                     f"per step over {LM_PROFILE_STEPS} steps "
                     f"(torch.profiler) | {card}")
        for kname, us in tk["top_us_per_step"]:
            say("times", f"lm_4k top kernel: {us:.1f} us/step {kname}")
        if not dense_peak >= 2 * peak:
            raise AssertionError(f"lm_4k: dense attention peaks at "
                                 f"{dense_peak} bytes, not 2x the flash "
                                 f"path's {peak}")
        out["lm_4k"] = {"tokens_per_sec": rate, "ms_per_step": ms,
                        "peak_bytes": peak, "dense_peak_bytes": dense_peak,
                        "busy_share": busy, **tk}

        both = ("--attn_block", str(LM_ATTN_BLOCK), "--ce_block",
                str(LM_CE_BLOCK), "--bf16")
        big, big_peak = lm_train_run(work, data_dir, "bigv-time", *LM_BIGV,
                                     LM_BIGV_BATCH, LM_BIGV_STEPS, *both,
                                     "--display_step", "1000")
        brate, bms, bsplit = lm_rate(big, LM_BIGV[0], LM_BIGV_BATCH)
        loss0 = big.records("mini_batch_loss")[0]
        unstreamed, un_peak = lm_train_run(
            work, data_dir, "bigv-dense-head", *LM_BIGV, LM_BIGV_BATCH,
            LM_MEM_STEPS, "--attn_block", str(LM_ATTN_BLOCK), "--ce_block",
            "0", "--bf16", "--display_step", "1000")
        say("times", f"lm_bigvocab bf16 flash + streamed head (batch "
                     f"{LM_BIGV_BATCH}, seq {LM_BIGV[0]}, V {LM_BIGV[1]}): "
                     f"{brate:.1f} "
                     f"tokens/s/GPU, {bms:.3f} ms/step over steps "
                     f"1-{LM_BIGV_STEPS - 1}; per step " + ", ".join(
                         f"{k} {v:.3f} ms" for k, v in bsplit.items())
                     + f" (StepTimer); step-0 loss {loss0:.5f}; peak "
                     f"{big_peak / 2**30:.3f} GiB; --ce_block 0 peak "
                     f"{un_peak / 2**30:.3f} GiB ({un_peak / big_peak:.2f}x)"
                     f" | {card}")
        if not math.isfinite(loss0) or not un_peak >= 2 * big_peak:
            raise AssertionError(f"lm_bigvocab: loss {loss0}, unstreamed "
                                 f"peak {un_peak} vs streamed {big_peak}")
        out["lm_bigvocab"] = {"tokens_per_sec": brate, "ms_per_step": bms,
                              "peak_bytes": big_peak,
                              "unstreamed_peak_bytes": un_peak}
    finally:
        datasets.LM_TRAIN, datasets.LM_TEST = saved
    return out


def phase_lm_recall(tag: str, work: str, data_dir: str) -> dict:
    """12d: the JAX test's recipe reaches the JAX package's accuracy less
    0.05; the final checkpoint restores and a second train resumes."""
    logdir = os.path.join(work, f"{tag}-recall")
    main = TrainRun(logdir, data_dir, tag, False, *RECALL_ARGS,
                    "--training_iter", str(RECALL_STEPS))
    acc = main.result.test_metrics["accuracy"]
    need = max(RECALL_JAX[tag] - 0.05, 3 / RECALL_VOCAB)
    say("lm", f"{tag}: recall recipe (V {RECALL_VOCAB}, S 32, d 64, 2 "
              f"heads, 2 blocks, adam 3e-3, batch 32) {RECALL_STEPS} steps: "
              f"test accuracy {acc:.4f} (need >= {need:.4f}: the JAX "
              f"package's {RECALL_JAX[tag]} less 0.05); "
              f"{main.result.images_per_sec * 32:.1f} tokens/s")
    if main.result.final_step != RECALL_STEPS or not acc >= need:
        raise AssertionError(f"{tag}: the LM did not learn the recall task "
                             f"({acc})")
    model = TransformerLM(vocab_size=RECALL_VOCAB, seq_len=32, d_model=64,
                          num_heads=2, num_blocks=2,
                          compute_dtype=torch.bfloat16 if tag == "bf16"
                          else None)
    template = train_state.create_train_state(model, train_state.adam(3e-3))
    restored = restore_with_fallback(logdir, template)
    if restored is None or restored[1] != RECALL_STEPS:
        raise AssertionError(f"{tag}: the LM's final checkpoint did not "
                             f"restore")
    stop = RECALL_STEPS + RESUME_STEPS
    again = TrainRun(logdir, data_dir, tag, False, *RECALL_ARGS,
                     "--training_iter", str(stop))
    resumed = again.records("recovery_restore_step").get(RECALL_STEPS)
    acc2 = again.result.test_metrics["accuracy"]
    say("lm", f"{tag}: restored step {restored[1]}; resumed from step "
              f"{resumed} to {again.result.final_step}, test accuracy "
              f"{acc2:.4f}")
    if resumed != RECALL_STEPS or again.result.final_step != stop or \
            not acc2 >= need:
        raise AssertionError(f"{tag}: the LM resume did not continue")
    return {"accuracy": acc, "resumed_accuracy": acc2}


def _post_status(url: str, obj: dict) -> tuple[int, dict]:
    try:
        return 200, _post(url, obj)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def greedy_check(module, prompts, tokens, logits, tol: float) -> dict:
    """Decoded tokens (and, when given, their logits) against a full-
    prefix forward of ``module`` on the card at each position. A token
    that differs where the recompute's top-2 margin is within ``tol`` of
    the logits' scale is a near tie, counted and not failed."""
    p = prompts.shape[1]
    n = tokens.shape[1] - p
    full = torch.zeros((len(tokens), module.seq_len), dtype=torch.long)
    full[:, :p + n] = torch.from_numpy(tokens)
    with torch.inference_mode():
        ref = module(full.cuda())[:, p - 1:p + n - 1].float().cpu().numpy()
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=-1)[..., -2:]
    tie = (top2[..., 1] - top2[..., 0]) <= tol * scale
    wrong = ref.argmax(-1) != tokens[:, p:]
    out = {"mismatch": int((wrong & ~tie).sum()),
           "near_tie": int(tie.sum()), "tie_mismatch": int((wrong & tie).sum()),
           "positions": int(wrong.size)}
    if logits is not None:
        out["logit_err"] = float(np.abs(logits - ref).max()) / scale
        out["bitwise_rows"] = int(np.all(logits == ref, axis=-1).sum())
    return out


def phase_lm_serve(tag: str, card: str, work: str) -> dict:
    """12e: serve a seeded lm_4k checkpoint over HTTP /v1/generate."""
    seq_len, vocab = LM_4K
    model = TransformerLM(vocab_size=vocab, seq_len=seq_len,
                          **LM_WIDTH).init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(7).integers(
        0, vocab, (LM_SERVE_REQUESTS, LM_PROMPT)).astype(np.int32)
    logdir = os.path.join(work, f"{tag}-lm-serve")
    save_checkpoint(logdir, {"params": params_to_numpy(model),
                             "step": np.int32(1)}, 1)
    flags.define_flags()
    flags.FLAGS._reset()
    flags.FLAGS._parse(
        ["--logdir", logdir, *lm_args(seq_len, vocab), "--serve_max_batch",
         "8", "--serve_port", "0", "--serve_reload_secs", "0",
         "--serve_timeout_ms", "120000", "--serve_max_new_tokens",
         str(LM_NEW)] + (["--bf16"] if tag == "bf16" else []))
    engine, client, _watcher, metrics = build_serving_stack(flags.FLAGS)
    batcher = client.generate_batcher
    server = InferenceServer(engine, client, port=0).start_background()
    url = server.address + "/v1/generate"
    outs = [None] * LM_SERVE_REQUESTS
    try:
        _post(url, {"prompt": prompts[0].tolist(), "max_new_tokens": LM_NEW})
        torch.cuda.synchronize()
        batcher.latency.reset()
        batches0 = batcher.stats.as_dict()["batches"]

        def worker(t):
            for i in range(t, LM_SERVE_REQUESTS, N_THREADS):
                outs[i] = _post(url, {"prompt": prompts[i].tolist(),
                                      "max_new_tokens": LM_NEW})["tokens"]

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(N_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        lat = batcher.latency.summary()
        batches = batcher.stats.as_dict()["batches"] - batches0
        bad = _post_status(url, {"prompt": [1, vocab], "max_new_tokens": 4})
        seeded = {"prompt": prompts[1].tolist(), "max_new_tokens": LM_NEW,
                  "temperature": 1.0, "seed": 5}
        first, again = _post(url, seeded), _post(url, seeded)
    finally:
        server.close()
        batcher.close()
        client.predict_batcher.close()
        metrics.logger.close()
    tokens = np.asarray(outs, dtype=np.int64)
    module = engine.current()[0]
    tol = LM_SERVE_TOL[tag]
    http = greedy_check(module, prompts, tokens, None, tol)
    direct = {"mismatch": 0, "near_tie": 0, "tie_mismatch": 0,
              "positions": 0, "logit_err": 0.0, "bitwise_rows": 0}
    for i in range(0, LM_SERVE_REQUESTS, 8):
        got = engine.generate(prompts[i:i + 8], LM_NEW)
        c = greedy_check(module, prompts[i:i + 8],
                         got["tokens"].astype(np.int64), got["logits"], tol)
        for key in direct:
            direct[key] = (max(direct[key], c[key]) if key == "logit_err"
                           else direct[key] + c[key])
    split = decode_split(module, prompts[:8])
    say("lm", f"{tag} serving lm_4k: {LM_SERVE_REQUESTS} HTTP generates "
              f"(prompt {LM_PROMPT}, {LM_NEW} new) from {N_THREADS} threads "
              f"in {wall:.3f} s, {batches} batches; greedy tokens vs the "
              f"full-prefix argmax: {http}; direct decode at batch 8 vs the "
              f"recompute: {direct} (logit tolerance {tol} of the scale; "
              f"bitwise: {direct['bitwise_rows'] == direct['positions']}); "
              f"out-of-vocab prompt -> {bad[0]}; seeded sample repeats: "
              f"{first['tokens'] == again['tokens']}")
    say("times", f"{tag} serving lm_4k: request p50 {lat['p50']:.3f} ms, p99 "
                 f"{lat['p99']:.3f} ms over {int(lat['count'])} HTTP "
                 f"generates (batcher histogram); at batch 8 prefill "
                 f"{split['prefill_ms']:.3f} ms, decode "
                 f"{split['decode_ms_per_step']:.3f} ms/step, "
                 f"{split['decode_tokens_per_sec']:.1f} decode tokens/s "
                 f"(synchronized host clock) | {card}")
    if tokens.shape != (LM_SERVE_REQUESTS, LM_PROMPT + LM_NEW) or \
            http["mismatch"] or direct["mismatch"] or \
            not direct["logit_err"] <= tol:
        raise AssertionError(f"{tag}: served tokens or logits disagree with "
                             f"the full-prefix recompute: {http} {direct}")
    if bad[0] != 400 or first["tokens"] != again["tokens"]:
        raise AssertionError(f"{tag}: out-of-vocab -> {bad}, seeded sample "
                             f"{first['tokens']} then {again['tokens']}")
    return {"latency_ms": lat, "http": http, "direct": direct, **split}


def decode_split(module, prompts) -> dict:
    """Prefill and per-step decode time of one generate at the prompts'
    batch, each call ended by a synchronize (the host reads the logits
    right after either way); the second of two runs."""
    from distributed_tensorflow_tpu_torch.serving import decode as dec

    acc = {"prefill": 0.0, "step": 0.0, "steps": 0}

    def timed(fn, key):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            acc[key] += time.perf_counter() - t0
            acc["steps"] += key == "step"
            return out
        return call

    prefill = timed(dec.make_prefill(module), "prefill")
    step = timed(dec.make_decode_step(module), "step")
    for _ in range(2):
        acc.update(prefill=0.0, step=0.0, steps=0)
        dec.generate(module, prompts, LM_NEW, prefill_fn=prefill,
                     step_fn=step)
    return {"prefill_ms": acc["prefill"] * 1e3,
            "decode_ms_per_step": acc["step"] * 1e3 / acc["steps"],
            "decode_tokens_per_sec": len(prompts) * acc["steps"]
            / acc["step"]}


def phase_lm(card: str, work: str, data_dir: str) -> dict:
    """Phase 12, the causal LM; ``fused_dense_relu`` must not launch on
    its paths (12f)."""
    t0 = time.perf_counter()
    fns = phase_lm_functions()
    fused_dense.LAUNCHES = 0  # the LM paths' runs start here
    trained = phase_lm_train(card, work, data_dir)
    recall = {tag: phase_lm_recall(tag, work, data_dir) for tag in DTYPES}
    served = {tag: phase_lm_serve(tag, card, work) for tag in DTYPES}
    launches = fused_dense.LAUNCHES  # ... and end here
    say("lm", f"fused_dense_relu launches over the LM paths: {launches}; "
              f"phase 12 took {time.perf_counter() - t0:.1f} s")
    if launches:
        raise AssertionError("the LM paths launched fused_dense_relu")
    return {"functions": fns, "train": trained, "recall": recall,
            "serve": served, "launches": launches}


def main() -> int:
    card = phase_device()
    phase_build()
    worst = phase_kernel_vs_plain()
    served = {tag: phase_serve(tag) for tag in DTYPES}
    grad_worst = phase_train_grad()
    with tempfile.TemporaryDirectory() as work:
        data_dir = os.path.join(work, "empty")
        os.makedirs(data_dir)
        trained = {tag: phase_train(tag, work, data_dir) for tag in DTYPES}
        host_rates = phase_train_times(card, work, data_dir)
        port = free_port()
        maybe_initialize_distributed(
            ClusterSpec({"worker": [f"127.0.0.1:{port}"]}), 0, "cuda")
        try:
            mesh = make_mesh("cuda")
            data = put_device_data(read_data_sets(data_dir).train, "cuda")
            resident = {tag: phase_device_resident(tag, work, data_dir, mesh,
                                                   data, port)
                        for tag in DTYPES}
            phase_device_times(card, work, data_dir, port, host_rates,
                               resident)
            cifar = put_device_data(
                read_data_sets(data_dir, dataset="cifar10").train, "cuda")
            for tag in DTYPES:
                phase_resnet(tag, work, data_dir, mesh, cifar)
            phase_resnet_times(card, work, data_dir, port)
            del cifar
            zeroed = {tag: phase_zero(tag, work, data_dir, mesh, data, port)
                      for tag in DTYPES}
            phase_zero_times(card, work, data_dir, port, resident)
        finally:
            dist.destroy_process_group()
        ps = {tag: phase_ps(tag, work, data_dir) for tag in DTYPES}
        phase_ps_mirror_vs_full(work, data_dir)
        phase_ps_times(card, work, data_dir)
        lm = phase_lm(card, work, data_dir)
    times = phase_times(card, served)
    kernels = []
    for tag in DTYPES:
        t = times[(tag, SERVE_SHAPE)]
        by_path = {"serve": served[tag]["launches"],
                   "train": trained[tag]["launches"],
                   "device_resident": resident[tag]["launches"],
                   "ps_worker0": ps[tag]["launches"],
                   "zero3_overlap": zeroed[tag]["launches"],
                   "lm_train_and_serve": lm["launches"]}
        kernels.append({
            "name": f"fused_dense_relu[{tag}]", "route": "cuda",
            "variant": "tma", "source": KERNEL_SRC, "replaces": TPU_KERNEL,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(worst[tag], grad_worst[tag]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": list(SERVE_SHAPE)})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
