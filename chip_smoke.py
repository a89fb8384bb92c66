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
   after phase 16;
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
   f32 and with ``--bf16 --ps_wire bf16``), every worker reading one
   ``--data_dir``, as the reference's do: the synthetic digits written
   once as an MNIST-format (IDX) split. Two workers must reach test
   accuracy 0.98 within 400 global steps with the mirror cycle, while
   the ps holds no CUDA context (not in ``nvidia-smi``'s compute apps,
   no ``/dev/nvidia<N>`` open); worker/0's kernel launches must equal
   its cycles, display evals and test-eval batches, all "tma"; the
   final checkpoint, beside the background writer's cadenced ones, must
   evaluate through ``--eval_only`` to the printed accuracy and pass
   ``checkpoint.inspect --verify``; one worker's 20 mirror cycles must
   land the ps within 1e-5 of each leaf's scale of 20 full-pull cycles
   (keep_prob 1, cuDNN deterministic); then global steps/s, images/s
   over both workers and worker/0's per-cycle split (pull, upload,
   grad, download, push) with the mirror on, then off, on either wire,
   and the device's busy share over 20 of worker/0's cycles;
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
   (b)-(e);
13. the LM on every train path the JAX package gives it on one chip, on a
   fresh one-rank NCCL group through ``train(FLAGS, mode="sync")``: (a)
   one Switch MoE layer (``ops/moe.py``) at the MoE LM's shapes (T = 16
   x 128 tokens, d 128, 8 experts, m 512, cf 1.25, inputs whose top-2
   router probabilities are at least 1e-3 apart) on the card against the
   CPU, expert ids and ``dropped_frac`` equal, the output, ``lb_loss``
   and the gradients of h and every leaf within 1e-5 (f32, TF32 off) and
   2e-2 (bf16) of each one's scale, then the layer's time and its
   dispatch and combine einsums against its expert GEMMs (CUDA events);
   (b) the repo's MoE LM (``bench.py``'s ``ep_device_phase``: vocab 64,
   seq 128, d 128, 4 heads, 2 blocks, 8 experts, bf16, adam 1e-3, batch
   16, 2048 train sequences, chunk 10; the test split cut to 16
   sequences, one routing group) host-fed and ``--device_data`` (a CUDA
   graph a step), 100 steps each with the loss falling and ``moe_lb``
   >= 0.99; 20 replays against 20 eager device steps, metrics and state
   bitwise; the device run's checkpoint restored and resumed; the two
   paths' tokens/s/GPU in turns (host, device, device, host), their busy
   shares and top kernels; (c) ``lm_4k`` (phase 12's configuration)
   ``--device_data`` for 20 steps beside 12b's host-fed run, and the
   recall recipe device-resident to the JAX package's accuracy less 0.05
   with both paths' rates in turns; (d) ``--zero 3 --zero_overlap
   --device_data`` on the MoE LM: 20 replays bitwise equal to the
   replicated step's (one rank: the collectives are copies), 100 steps
   through ``train``, and its final checkpoint resumed by a replicated
   run; (e) ``fused_dense_relu`` must not launch over (a)-(d);
14. continuous serving of a seeded lm_4k checkpoint (bf16) through the
   paged-KV slot scheduler: (a) the slot step (``decode.make_slot_step``)
   at 12 slots, page 16, live slots at mixed positions up to 4095 and two
   free slots on the scratch page, on the card against its eager CPU run
   in f32 and bf16 (logits within 1e-4 / 2e-2 of their scale, the written
   pool rows within the same, every other row untouched); 20 replays of
   ``EngineSlotBackend``'s CUDA graph against 20 eager slot steps on the
   card, logits and pools bitwise, one capture; a capture under
   ``torch.use_deterministic_algorithms`` (``index_put_``'s sorting path
   with the free slots' duplicate scratch writes) within the tolerance;
   the step's time eager and replayed; (b) ``build_serving_stack
   --serve_scheduler continuous --serve_slots 12``: 32 HTTP
   ``/v1/generate`` requests of 8 (prompt 1-64, new tokens 1-256) shapes
   from 8 threads, each equal to the whole-batch ``engine.generate`` of
   its prompt but at near ties (the first differing position's top-2
   margin within 2e-2 of the logits' scale), then after the drain the
   page ledger, no page in use, one graph capture, every request's phases
   summing to its wall time, and ``/metrics``' ``tail``, ``hbm.kv_pages``
   and ``continuous`` blocks; (c) ``POST /admin/reload`` of a new
   checkpoint while 4 requests of 256 new tokens are in flight: they
   finish on the old weights (equal to its whole-batch generate), a
   request sent after the reload gets the new checkpoint's tokens, and
   the graph is captured again; (d) whole-batch (``--serve_max_batch 4``,
   four dense 4096-token rows) against continuous (``--serve_slots 12
   --serve_kv_pages 1024 --serve_kv_page 16``) at the same KV token
   budget, 96 requests (prompt 64, 32 new tokens, every 10th 256) from 16
   closed-loop clients an arm, in turns: generated tokens/s, request
   p50/p99, the tail block's queue_wait p99, KV pages high water; then
   the slot step's time an iteration, its graph replay's device time and
   the card's busy share over 20 profiled iterations. No bar is set on
   them; (e) ``fused_dense_relu`` must not launch over (b)-(d);
15. the model axis (``--model_axis 2``) on one card: two ranks on cuda:0,
   each a spawned process that joins a gloo group as a library caller
   and trains through ``train(FLAGS, mode="sync")`` (NCCL refuses two
   ranks of one communicator on one device; the phase's first line
   prints what it says): (a) deep_cnn ``--pallas`` at phase 5's recipe
   (adam 1e-3, batch 128, dropout on) in f32 and bf16, 20 steps against
   20 one-rank steps from one init and one batch stream within phase
   5's bars, the kernel launched once per forward pass on each rank on
   its own contiguous (M, 3136) x (3136, 512) column shard, every time
   as "tma"; (b) the dense LM at lm_4k (flash attention, batch 8) for 5
   steps against one rank, f32 within 1e-4 and bf16 within 2e-2 of
   max(1, loss), no kernel launch; (c) the f32 grid's sharded set at
   step 20 through ``checkpoint.inspect --verify``, then it and the
   one-rank run's monolithic file each resumed for 5 steps by the grid
   and by one rank, the two within phase 5's f32 bar; (d) ms/step and
   busy share of (a) and (b) on each rank, printed as gloo-staged, not a
   TP time; (e) after phase 6, the kernel's times at the column shards'
   shapes (M 128 and 1000, N 512 and 256), which phases 3 and 6 include;
16. sequence parallelism (``--seq_parallel --model_axis 2``) on one card,
   two spawned ranks on cuda:0 over gloo as in phase 15: (a) ring
   attention alone at lm_4k's attention shapes, (8, 4096, 4, 64) split 2
   ways, in f32 and bf16, causal and not, each rank's output and q/k/v
   gradients against one rank's flash (block 512) and dense attention of
   the whole sequence within 1e-4 (f32) and 2e-2 (bf16) of each one's
   scale, the bytes the ring sent against ``sp_comm_rows`` (whose
   backward prices the float32 dk/dv at k's width, so in bf16 it is
   checked against the float32 count), and a forward and backward of the
   ring beside one rank's flash (gloo-staged); (b) the LM at lm_4k
   through ``train(FLAGS, mode="sync")`` for 10 steps in f32 and bf16
   against a one-rank flash run from one init on one batch stream, f32
   within 1e-4 and bf16 within 1e-2 of max(1, loss), with each rank's
   peak memory beside the one-rank run's; (c) lm_bigvocab with
   ``--ce_block 512`` (bf16) for 3 steps, the same; (d) the
   MiniTransformer at its registry widths (d 128, 4 heads, 2 blocks) on
   2,560 synthetic digits at phase 5's recipe (dropout on) for 20 steps
   in f32 and bf16 against one rank, within phase 5's bars;
   ``fused_dense_relu`` must not launch over (a)-(d).

Any failed phase raises, so the script exits non-zero. f32 runs in full
f32: TF32 is turned off for cuDNN and cuBLAS.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import multiprocessing
import os
import re
import shutil
import socket
import struct
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
from distributed_tensorflow_tpu_torch.ops.moe import switch_moe
from distributed_tensorflow_tpu_torch.ops.attention import (
    blockwise_attention,
    multi_head_attention,
    ring_attention,
)
from distributed_tensorflow_tpu_torch.ops.nn import streamed_softmax_ce_head
from distributed_tensorflow_tpu_torch.ops.fused_dense import (
    fused_dense_relu,
    fused_dense_relu_reference,
)
from distributed_tensorflow_tpu_torch.parallel import (
    MeshSpec,
    PSClient,
    fetch_state_zero,
    make_mesh,
    shard_state_zero,
    sp_comm_rows,
)
from distributed_tensorflow_tpu_torch.parallel import mesh as mesh_mod
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
    _PROFILE_MARGIN_S,
    PROFILED_STEPS,
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
# phase 15's column shards of wd1: N = 1024/2 and 1024/4 at the training
# and test-eval batches
TP_SHAPES = [(128, 3136, 512), (1000, 3136, 512), (128, 3136, 256),
             (1000, 3136, 256)]
SHAPES = [(1, 3136, 1024), (8, 3136, 1024), (128, 3136, 1024),
          (256, 3136, 1024), (1000, 3136, 1024), (130, 257, 70), *TP_SHAPES]
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
# each leaf's scale; the timing runs, one of each configuration, take
# PS_TIME_STEPS global steps with a profiled window of PS_PROFILE_CYCLES
# of worker/0's cycles
PS_STEPS, PS_TRAJ_STEPS, PS_TIME_STEPS, PS_PROFILE_CYCLES = 400, 20, 100, 20

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

# phase 13: the LM on the device-resident (graph-replayed) and ZeRO
# paths. The MoE LM is bench.py's ep_device_phase configuration
# (bench.py:126-134, 613-616; the JAX package's own MoE config): vocab
# 64, seq 128, d 128, 4 heads, 2 blocks, 8 experts, bf16, adam 1e-3,
# batch 16, a split of 2048 sequences, chunk 10. Its test split is cut to
# 16 sequences: the LM's eval batch of 2**18 tokens would be ONE routing
# group of 65,536 tokens at the default 512, whose (T, E, C) dispatch
# tensor holds 5.4e9 entries (the JAX package has the same rule); 16
# sequences are one group of 2048 tokens, a training batch's
MOE_ARGS = ("--model", "lm", "--dataset", "lm", "--seq_len", "128",
            "--vocab_size", "64", "--d_model", "128", "--num_heads", "4",
            "--num_blocks", "2", "--moe_experts", "8", "--batch_size", "16",
            "--keep_prob", "1.0")
MOE_KW = {"vocab_size": 64, "seq_len": 128, "d_model": 128, "num_heads": 4,
          "num_blocks": 2, "moe_experts": 8}
MOE_SPLIT, MOE_BATCH, MOE_CHUNK = (2048, 16), 16, 10
MOE_STEPS, MOE_RESUME, MOE_TIME_STEPS, MOE_PROFILE = 100, 10, 200, 10
MOE_LB_MIN = 0.99  # the JAX test's floor for moe_lb (tests/test_moe.py)
# 13a: one Switch layer at the config's shapes (T = 16 x 128 tokens, d
# 128, E 8, m 512, cf 1.25) on the card against the CPU: f32 (TF32 off)
# a reordered float32 sum, within 1e-5 of each output's scale; bf16
# rounds the einsums' outputs in cuBLAS and on the CPU, 2e-2
MOE_LAYER = {"batch": 16, "seq": 128, "d": 128, "experts": 8, "cf": 1.25}
MOE_LAYER_TOL = {"f32": 1e-5, "bf16": 2e-2}
MOE_MARGIN = 1e-3  # every token's top-2 router probabilities this far apart
# 13c: lm_4k device-resident in chunks of 5 (the first chunk, the
# warm-up and the capture, stays out of the window of LM_STEPS)
LM4K_CHUNK = 5

# phase 14: continuous serving of an lm_4k checkpoint (bf16, seeded). 14a
# holds the slot step on the card against the CPU at 12 slots, page 16,
# live slots at mixed positions (their pages mapped, the free slots 2 and
# 6 on the scratch page), in f32 and bf16, then 20 graph replays against
# 20 eager steps. 14b serves 32 requests of 8 (prompt, new tokens) shapes
# over HTTP from N_THREADS threads through 12 slots; 14c reloads a new
# checkpoint under 4 in-flight requests (prompt 1024, 256 new tokens,
# 1279 iterations, so they outlast the restore); 14d runs
# whole-batch (4 dense rows of 4096 tokens) against continuous (1024
# pages of 16: the same 16,384-token KV budget) on the JAX bench's
# long-tail mix (prompt 64, 32 new tokens, every 10th request 256) from
# 16 closed-loop clients, 96 requests an arm, in turns
CONT_DEVICE = "cuda"
CONT_SLOTS, CONT_PAGE, CONT_STEP_PAGES = 12, 16, 1024
CONT_STEP_T = (0, 5, 0, 4076, 100, 2000, 0, 17, 511, 3000, 63, 1024)
CONT_FREE = (2, 6)
CONT_STEP_TOL = {"f32": 1e-4, "bf16": 2e-2}
CONT_REPLAYS = 20
CONT_REQUESTS, CONT_MAX_NEW = 32, 256
CONT_SHAPES = ((1, 256), (64, 1), (7, 100), (33, 17), (64, 256), (2, 64),
               (50, 200), (16, 32))
CONT_RELOAD_INFLIGHT, CONT_RELOAD_PROMPT = 4, 1024
CONT_WHOLE_BATCH, CONT_KV_PAGES = 4, 1024
CONT_BENCH_REQUESTS, CONT_BENCH_CLIENTS = 96, 16
CONT_BENCH_SHORT, CONT_BENCH_LONG = 32, 256
CONT_PROFILE_ITERS = 20

# phase 15: the model axis on one card, two ranks on cuda:0 over gloo. (a)
# deep_cnn --pallas at phase 5's recipe, TP_STEPS steps against one rank
# (phase 5's bars, TRAJ_TOL); (b) the LM at lm_4k with the flash
# attention, TP_LM_STEPS steps, f32 within 1e-4 and bf16 within 2e-2 of
# max(1, loss); (c) the f32 grid's sharded set and the one-rank file
# resumed for TP_RESUME steps by the grid and by one rank; (d) timed
# runs without the profiler for the rate, and runs with TP_PROFILE
# (TP_LM_PROFILE) profiled steps for the busy share
TP_WAYS = 2
TP_STEPS, TP_RESUME, TP_LM_STEPS, TP_TIME_STEPS = 20, 5, 5, 40
TP_PROFILE, TP_LM_PROFILE = 10, 2
TP_LM_TOL = {"f32": 1e-4, "bf16": 2e-2}
TP_JOIN_S, TP_NCCL_S = 600, 120  # a rank not done by then is stuck

# phase 16: sequence parallelism (--seq_parallel --model_axis 2) on one
# card, two ranks on cuda:0 over gloo. (a) ring attention alone at
# lm_4k's attention shapes (B 8, S 4096, H 4, Dh 64) split 2 ways, f32
# and bf16, causal and not, against one rank's flash (block 512) and
# dense attention: the output and the q/k/v gradients within 1e-4 (f32)
# and 2e-2 (bf16) of each one's scale, the ring's bytes against
# sp_comm_rows; (b) the LM at lm_4k for SP_LM_STEPS steps against a
# one-rank flash run from one init on one batch stream, f32 within 1e-4
# and bf16 within 1e-2 of max(1, loss), and each rank's peak memory
# beside the one-rank run's; (c) lm_bigvocab (ce_block 512, bf16) for
# SP_BIGV_STEPS steps, the same; (d) the MiniTransformer at its registry
# widths on SP_DIGITS synthetic digits, SP_CLS_STEPS steps at phase 5's
# recipe against one rank, within phase 5's bars
SP_WAYS = TP_WAYS
SP_ATTN_SHAPE = (8, 4096, 4, 64)
SP_ATTN_TOL = {"f32": 1e-4, "bf16": 2e-2}
SP_LM_TOL = {"f32": 1e-4, "bf16": 1e-2}
SP_LM_STEPS, SP_BIGV_STEPS, SP_CLS_STEPS = 10, 3, 20
SP_DIGITS = (2560, 512)  # (d)'s synthetic train and test digits
SP_JOIN_S = 600  # a rank not done by then is stuck

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


def write_ps_split(work: str, data_dir: str) -> str:
    """Phase 10's ``--data_dir``: the synthetic split this process renders
    from the empty ``data_dir``, written once as MNIST's IDX files (uint8
    pixels), which every worker of every ps run reads; a worker
    subprocess then loads it in milliseconds instead of rendering
    20,000 digits of its own."""
    out = os.path.join(work, "ps-idx")
    os.makedirs(out)
    ds = read_data_sets(data_dir, one_hot=False)
    for stem, split in (("train", ds.train), ("t10k", ds.test)):
        for kind, arr in (("images-idx3", np.round(
                np.asarray(split.images).reshape(-1, 28, 28) * 255)),
                          ("labels-idx1", np.asarray(split.labels))):
            with open(os.path.join(out, f"{stem}-{kind}-ubyte"), "wb") as f:
                f.write(bytes([0, 0, 0x08, arr.ndim]))
                f.write(struct.pack(f">{arr.ndim}i", *arr.shape))
                f.write(arr.astype(np.uint8).tobytes())
    return out


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
    split, with the mirror on, then off, on the f32 and the bf16 wire;
    each run profiles PS_PROFILE_CYCLES of worker/0's cycles (its busy
    share), which stay out of its timed window; worker/1 is never
    profiled."""
    rows = {}
    for wire in PS_WIRE_ARGS:
        for i, mirror in enumerate((True, False)):
            name = f"{wire}-ps-turn-{i}"
            extra = () if mirror else ("--ps_mirror=false",)
            profile = ("--profile_dir", os.path.join(work, name, "trace"),
                       "--profile_steps", str(PS_PROFILE_CYCLES))
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


# --------------------------------------------- phase 13: the LM, complete

MOE_LEAVES = ("router", "w1", "b1", "w2", "b2")


def lm_sync_args(port: int) -> tuple[str, ...]:
    """Rank 0 of phase 13's one-rank group, served on ``port``."""
    return ("--mode", "sync", "--worker_hosts", f"127.0.0.1:{port}",
            "--task_index", "0")


def moe_layer_inputs(seed: int):
    """(h (B, S, d), params, cotangent) of one Switch layer from numpy,
    every token's top-2 router probabilities at least ``MOE_MARGIN``
    apart, so the card and the CPU must route every token alike."""
    c = MOE_LAYER
    d, e, m = c["d"], c["experts"], 4 * c["d"]
    rng = np.random.default_rng(seed)
    params = {"router": rng.normal(0, d ** -0.5, (d, e)),
              "w1": rng.normal(0, d ** -0.5, (e, d, m)),
              "b1": rng.normal(0, 0.1, (e, m)),
              "w2": rng.normal(0, m ** -0.5, (e, m, d)),
              "b2": rng.normal(0, 0.1, (e, d))}
    h = rng.normal(0, 1, (c["batch"] * c["seq"], d))
    for _ in range(100):
        z = h @ params["router"]
        p = np.exp(z - z.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        top2 = np.sort(p, -1)[:, -2:]
        close = top2[:, 1] - top2[:, 0] < MOE_MARGIN
        if not close.any():
            break
        h[close] = rng.normal(0, 1, (int(close.sum()), d))
    else:
        raise AssertionError("could not draw well-separated routes")
    shape = (c["batch"], c["seq"], d)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (as_t(h.reshape(shape)), {k: as_t(v) for k, v in params.items()},
            as_t(rng.normal(0, 1, shape)))


def moe_layer_run(h, params, ct, tag: str, device: str) -> dict:
    """``switch_moe`` on ``device``: the output, ``lb_loss``,
    ``dropped_frac``, the expert ids and the gradients of sum(y * ct) +
    0.3 lb_loss with respect to h and every leaf, on the CPU."""
    cd = torch.bfloat16 if tag == "bf16" else None
    th = h.to(device).requires_grad_()
    tp = {k: v.to(device).requires_grad_() for k, v in params.items()}
    y, aux = switch_moe(th, tp, capacity_factor=MOE_LAYER["cf"],
                        compute_dtype=cd)
    obj = (y.float() * ct.to(device)).sum() + 0.3 * aux["lb_loss"]
    grads = torch.autograd.grad(obj, [th] + [tp[k] for k in MOE_LEAVES])
    with torch.no_grad():
        ids = torch.softmax(th.reshape(-1, th.shape[-1]).float()
                            @ tp["router"].float(), -1).argmax(-1)
    out = {"y": y, "lb_loss": aux["lb_loss"], "dh": grads[0],
           "dropped_frac": aux["dropped_frac"], "ids": ids}
    out.update({f"d{k}": g for k, g in zip(MOE_LEAVES, grads[1:])})
    return {k: v.detach().float().cpu() if k != "ids" else v.cpu()
            for k, v in out.items()}


def phase_moe_layer(card: str) -> dict:
    """13a: ``switch_moe`` on the card against its CPU result at the MoE
    LM's layer shapes, in f32 (TF32 off) and bf16; then the layer's time
    and its einsums' times in bf16 (CUDA events)."""
    h, params, ct = moe_layer_inputs(13)
    c = MOE_LAYER
    t, d, e, m = c["batch"] * c["seq"], c["d"], c["experts"], 4 * c["d"]
    out = {}
    for tag in DTYPES:
        want = moe_layer_run(h, params, ct, tag, "cpu")
        got = moe_layer_run(h, params, ct, tag, "cuda")
        same_ids = bool(torch.equal(got["ids"], want["ids"]))
        dropped = (float(got["dropped_frac"]), float(want["dropped_frac"]))
        errs = {k: rel_err(got[k], want[k]) for k in got
                if k not in ("ids", "dropped_frac")}
        tol = MOE_LAYER_TOL[tag]
        say("moe", f"{tag}: switch_moe on the card vs the CPU, T {t}, d {d}, "
                   f"E {e}, m {m}, cf {c['cf']}: expert ids equal "
                   f"{same_ids}; dropped_frac {dropped[0]:.6f} (CPU "
                   f"{dropped[1]:.6f}); errors in units of each output's "
                   f"max " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
                   + f" (tolerance {tol})")
        if not (same_ids and dropped[0] == dropped[1]
                and max(errs.values()) <= tol):
            raise AssertionError(f"{tag}: switch_moe on the card disagrees "
                                 f"with the CPU: ids {same_ids}, dropped "
                                 f"{dropped}, {errs}")
        out[tag] = {"max_rel_err": max(errs.values()),
                    "dropped_frac": dropped[0]}
    # the layer in bf16, and the dispatch/combine einsums against the
    # expert GEMMs at its shapes (C = 320)
    bf = torch.bfloat16
    th, tp = h.cuda(), {k: v.cuda() for k, v in params.items()}

    def layer():
        x = th.clone().requires_grad_()
        y, aux = switch_moe(x, {k: v.requires_grad_() for k, v in tp.items()},
                            capacity_factor=c["cf"], compute_dtype=bf)
        return torch.autograd.grad(y.float().sum() + aux["lb_loss"], x)

    cap = math.ceil(c["cf"] * t / e)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=bf)

    slot, hf, xe, he, ye = (rnd(t, e, cap), rnd(t, d), rnd(e, cap, d),
                            rnd(e, cap, m), rnd(e, cap, d))
    w1, w2 = rnd(e, d, m), rnd(e, m, d)
    times = {
        "layer_fwd_bwd_ms": cuda_ms(layer, reps=20),
        "dispatch_ms": cuda_ms(lambda: torch.einsum("tec,td->ecd", slot, hf),
                               reps=50),
        "expert_gemms_ms": cuda_ms(lambda: (
            torch.einsum("ecd,edm->ecm", xe, w1),
            torch.einsum("ecm,emd->ecd", he, w2)), reps=50),
        "combine_ms": cuda_ms(lambda: torch.einsum("tec,ecd->td", slot, ye),
                              reps=50)}
    flops = {"dispatch_ms": 2 * t * e * cap * d,
             "expert_gemms_ms": 4 * e * cap * d * m,
             "combine_ms": 2 * t * e * cap * d}
    say("times", f"bf16 switch_moe layer (T {t}, d {d}, E {e}, C {cap}, m "
                 f"{m}): forward+backward {times['layer_fwd_bwd_ms']:.4f} ms; "
                 f"forward einsums: " + ", ".join(
                     f"{k.removesuffix('_ms')} {times[k]:.4f} ms "
                     f"({f / 1e9:.3f} GFLOP, "
                     f"{f / times[k] / 1e9:.1f} TFLOP/s)"
                     for k, f in flops.items()) + f" (CUDA events) | {card}")
    out["times"] = times
    return out


def moe_replays(mesh, data) -> dict:
    """13b, 13d: 20 device steps of the MoE LM replayed from a CUDA graph
    against 20 eager device steps, and 20 replays of ``--zero 3
    --zero_overlap`` against the replicated replays, each from the
    seed-0 init on the same draws: the metrics (loss, accuracy, moe_lb)
    and the standard-layout state, bitwise."""
    runs = {}
    for name in ("graph", "eager", "zero 3 overlap"):
        model = TransformerLM(**MOE_KW, compute_dtype=torch.bfloat16)
        opt = train_state.adam(1e-3)
        state = train_state.create_train_state(model, opt, seed=0,
                                               device="cuda")
        state = state._replace(step=state.step.cuda())
        if name == "zero 3 overlap":
            state = shard_state_zero(state, mesh, 3)
            step_fn = make_zero_device_train_step(
                model, opt, mesh, 3, data, MOE_BATCH, keep_prob=1.0,
                overlap=True)
        else:
            step_fn = make_device_dp_train_step(
                model, opt, mesh, data, MOE_BATCH, keep_prob=1.0,
                graph=name == "graph")
        metrics = []
        for s in range(TRAJ_STEPS):
            state, m = step_fn(state, s, 1)
            metrics.append({k: float(v) for k, v in m.items()})
        if name == "zero 3 overlap":
            state = fetch_state_zero(state, model, mesh, 3)
        runs[name] = (metrics, flatten_pytree(state))

    def same(a, b):
        (ma, fa), (mb, fb) = runs[a], runs[b]
        return ma == mb and sorted(fa) == sorted(fb) and all(
            np.array_equal(fa[k], fb[k]) for k in fa)

    out = {"graph_vs_eager": same("graph", "eager"),
           "zero_vs_replicated": same("zero 3 overlap", "graph")}
    first, last = runs["graph"][0][0], runs["graph"][0][-1]
    say("moe", f"bf16 MoE LM: {TRAJ_STEPS} device steps replayed from a CUDA "
               f"graph vs eager, and --zero 3 --zero_overlap replays vs the "
               f"replicated replays: loss {first['loss']:.6f} -> "
               f"{last['loss']:.6f}, moe_lb {last['moe_lb']:.6f}; metrics "
               f"and state (params, adam slots, step) bitwise equal: {out}")
    if not all(out.values()):
        raise AssertionError(f"MoE LM replays differ: {out}")
    return out


def moe_run(work: str, data_dir: str, name: str, port: int, steps: int,
            *extra: str) -> TrainRun:
    """The MoE LM through ``train(FLAGS, mode="sync")`` in ``work/name``."""
    return TrainRun(os.path.join(work, name), data_dir, "bf16", False,
                    *MOE_ARGS, "--training_iter", str(steps),
                    *lm_sync_args(port), *extra, mode="sync")


def path_times(card: str, work: str, label: str, make_run, seq_len: int,
               batch: int, steps: int, profile: int, first: dict) -> dict:
    """tokens/s/GPU of the host-fed and the device-resident path in turns
    (host, device, device, host), ``make_run(path, name, steps, *extra)``
    building each run in ``work/name``; then each path's busy share,
    kernels and top kernels over ``profile`` steps (at least one chunk)
    after its first ``first[path]`` steps (the first step or chunk carries
    the one-time costs)."""
    stem = label.replace(" ", "-")
    rates = {"host": [], "device": []}
    for i, path in enumerate(("host", "device", "device", "host")):
        run = make_run(path, f"{stem}-turn-{i}", steps, "--display_step",
                       str(10 * steps), "--test_eval", "false")
        rates[path].append(run.result.images_per_sec_per_chip * seq_len)
    out = {}
    for path in ("host", "device"):
        trace = os.path.join(work, f"{stem}-prof-{path}-trace")
        # the loop traces whole chunks: at least one on the device path
        window = max(profile, first[path]) if path == "device" else profile
        run = make_run(path, f"{stem}-prof-{path}", first[path] + window,
                       "--display_step", str(10 * steps), "--test_eval",
                       "false", "--profile_dir", trace, "--profile_steps",
                       str(profile))
        tk = trace_kernels(os.path.join(trace, "trace.json"), window)
        busy = run.result.device_busy_share
        per = rates[path]
        mean = sum(per) / len(per)
        out[path] = {"tokens_per_sec": per, "ms_per_step":
                     batch * seq_len * 1e3 / mean, "busy_share": busy, **tk}
        name = "host-fed" if path == "host" else "device-resident"
        say("times", f"{label} {name}: "
                     f"{', '.join(f'{r:.1f}' for r in per)} tokens/s/GPU "
                     f"(mean {mean:.1f}, {out[path]['ms_per_step']:.4f} "
                     f"ms/step, batch {batch} x {seq_len}); busy share "
                     f"{'not measured' if busy is None else f'{busy:.4f}'}, "
                     f"{tk['kernels_per_step']:.1f} kernels, "
                     f"{tk['busy_us_per_step']:.1f} us busy and "
                     f"{tk['idle_us_per_step']:.1f} us idle between kernels "
                     f"per step over {window} steps (torch.profiler) | "
                     f"{card}")
        for kname, us in tk["top_us_per_step"]:
            say("times", f"{label} {name} top kernel: {us:.1f} us/step "
                         f"{kname}")
    return out


def phase_moe_lm(card: str, work: str, data_dir: str, port: int,
                 mesh) -> dict:
    """13b, 13d: the MoE LM host-fed and device-resident through
    ``train``, its checkpoint restored and resumed, the ZeRO run resumed
    by a replicated one, and the two paths' rates in turns."""
    saved = datasets.LM_TRAIN, datasets.LM_TEST
    datasets.LM_TRAIN, datasets.LM_TEST = MOE_SPLIT
    try:
        split = read_data_sets(data_dir, dataset="lm",
                               seq_len=MOE_KW["seq_len"],
                               vocab_size=MOE_KW["vocab_size"]).train
        data = put_device_data(split, "cuda")
        out = {"replays": moe_replays(mesh, data)}
        del data
        dev = ("--device_data", "--device_chunk", str(MOE_CHUNK))
        zero3 = ("--zero", "3", "--zero_overlap")
        for path, extra in (("host", ()), ("device", dev),
                            ("zero", dev + zero3)):
            run = moe_run(work, data_dir, f"moe-{path}", port, MOE_STEPS,
                          "--display_step", str(MOE_CHUNK), *extra)
            losses = run.records("mini_batch_loss")
            seq = [losses[s] for s in sorted(losses)]
            lb = run.result.train_metrics["moe_lb"]
            acc = run.result.test_metrics["accuracy"]
            say("moe", f"bf16 MoE LM {path} ({' '.join(extra) or 'host-fed'})"
                       f": {MOE_STEPS} steps, display loss "
                       f"{[round(x, 4) for x in seq]}; moe_lb {lb:.5f} (need "
                       f">= {MOE_LB_MIN}); test accuracy {acc:.4f} over "
                       f"{MOE_SPLIT[1]} sequences")
            if run.result.final_step != MOE_STEPS or not (
                    all(math.isfinite(x) for x in seq) and seq[-1] < seq[0]
                    and lb >= MOE_LB_MIN):
                raise AssertionError(f"MoE LM {path}: step "
                                     f"{run.result.final_step}, losses {seq}, "
                                     f"moe_lb {lb}")
            out[path] = {"losses": seq, "moe_lb": lb, "accuracy": acc}
        # the device run's checkpoint restored and resumed by itself, the
        # ZeRO run's by a replicated run
        template = train_state.create_train_state(
            TransformerLM(**MOE_KW, compute_dtype=torch.bfloat16),
            train_state.adam(1e-3))
        restored = restore_with_fallback(os.path.join(work, "moe-device"),
                                         template)
        shutil.copytree(os.path.join(work, "moe-zero"),
                        os.path.join(work, "moe-zero-by-dp"))
        stop = MOE_STEPS + MOE_RESUME
        resumed = {}
        for name in ("moe-device", "moe-zero-by-dp"):
            again = moe_run(work, data_dir, name, port, stop, *dev)
            resumed[name] = (again.records("recovery_restore_step").get(
                MOE_STEPS), again.result.final_step)
        say("moe", f"bf16 MoE LM: the device run's checkpoint restored at "
                   f"step {restored and restored[1]}; resumed (from step, to "
                   f"step): {resumed} (the ZeRO run's by a replicated run)")
        if restored is None or restored[1] != MOE_STEPS or any(
                r != (MOE_STEPS, stop) for r in resumed.values()):
            raise AssertionError(f"MoE LM resume: {restored and restored[1]} "
                                 f"{resumed}")

        def make_run(path, name, steps, *extra):
            return moe_run(work, data_dir, name, port, steps,
                           *(dev if path == "device" else ()), *extra)

        out["times"] = path_times(card, work, "bf16 MoE LM", make_run,
                                  MOE_KW["seq_len"], MOE_BATCH,
                                  MOE_TIME_STEPS, MOE_PROFILE,
                                  {"host": 1, "device": MOE_CHUNK})
    finally:
        datasets.LM_TRAIN, datasets.LM_TEST = saved
    return out


def phase_lm_device(card: str, work: str, data_dir: str, port: int,
                    host_4k: dict) -> dict:
    """13c: lm_4k device-resident (the flash attention's Function inside
    the captured step) beside phase 12b's host-fed run; the recall recipe
    device-resident to the JAX package's accuracy less 0.05, and its two
    paths' rates in turns (a dispatch-bound step)."""
    out = {}
    saved = datasets.LM_TRAIN, datasets.LM_TEST
    datasets.LM_TRAIN, datasets.LM_TEST = LM_SPLIT
    try:
        args = (*lm_args(*LM_4K), "--attn_block", str(LM_ATTN_BLOCK),
                "--batch_size", str(LM_4K_BATCH), "--keep_prob", "1.0",
                "--test_eval", "false", "--display_step", "1000",
                *lm_sync_args(port), "--device_data", "--device_chunk",
                str(LM4K_CHUNK))
        timed = TrainRun(os.path.join(work, "lm4k-dev"), data_dir, "bf16",
                         False, "--training_iter", str(LM_STEPS), *args,
                         mode="sync")
        rate = timed.result.images_per_sec_per_chip * LM_4K[0]
        loss0 = timed.records("mini_batch_loss")[0]
        trace = os.path.join(work, "lm4k-dev-prof-trace")
        prof = TrainRun(os.path.join(work, "lm4k-dev-prof"), data_dir,
                        "bf16", False, "--training_iter",
                        str(LM4K_CHUNK + LM_PROFILE_STEPS), *args,
                        "--profile_dir", trace, "--profile_steps",
                        str(LM_PROFILE_STEPS), mode="sync")
        tk = trace_kernels(os.path.join(trace, "trace.json"),
                           LM_PROFILE_STEPS)
        busy = prof.result.device_busy_share
        ms = LM_4K_BATCH * LM_4K[0] * 1e3 / rate
        say("times", f"lm_4k bf16 flash device-resident (--device_data, "
                     f"chunk {LM4K_CHUNK}, one CUDA graph a step): "
                     f"{rate:.1f} tokens/s/GPU, {ms:.3f} ms/step over steps "
                     f"{LM4K_CHUNK}-{LM_STEPS - 1}; step-0 loss {loss0:.5f};"
                     f" busy share "
                     f"{'not measured' if busy is None else f'{busy:.4f}'}, "
                     f"{tk['kernels_per_step']:.1f} kernels, "
                     f"{tk['idle_us_per_step']:.1f} us idle per step; host-fed"
                     f" (12b) {host_4k['tokens_per_sec']:.1f} tokens/s/GPU, "
                     f"{host_4k['ms_per_step']:.3f} ms/step, busy share "
                     f"{host_4k['busy_share']} | {card}")
        if timed.result.final_step != LM_STEPS or not math.isfinite(loss0):
            raise AssertionError(f"lm_4k device-resident: step "
                                 f"{timed.result.final_step}, loss {loss0}")
        out["lm_4k"] = {"tokens_per_sec": rate, "ms_per_step": ms,
                        "busy_share": busy, **tk}
    finally:
        datasets.LM_TRAIN, datasets.LM_TEST = saved

    def make_run(path, name, steps, *extra):
        return TrainRun(os.path.join(work, name), data_dir, "f32", False,
                        *RECALL_ARGS, "--training_iter", str(steps),
                        *lm_sync_args(port),
                        *(("--device_data",) if path == "device" else ()),
                        *extra, mode="sync")

    learned = make_run("device", "recall-dev", RECALL_STEPS)
    acc = learned.result.test_metrics["accuracy"]
    need = max(RECALL_JAX["f32"] - 0.05, 3 / RECALL_VOCAB)
    say("lm", f"f32 recall recipe device-resident ({RECALL_STEPS} steps, "
              f"chunk 50): test accuracy {acc:.4f} (need >= {need:.4f})")
    if learned.result.final_step != RECALL_STEPS or not acc >= need:
        raise AssertionError(f"recall device-resident: accuracy {acc}")
    out["recall"] = {"accuracy": acc, **path_times(
        card, work, "f32 recall recipe", make_run, 32, 32, RECALL_STEPS, 10,
        {"host": 1, "device": 50})}
    return out


def phase_lm_complete(card: str, work: str, data_dir: str, port: int,
                      lm: dict) -> dict:
    """Phase 13 on a one-rank NCCL group; ``fused_dense_relu`` must not
    launch over (a)-(d) (13e)."""
    t0 = time.perf_counter()
    fused_dense.LAUNCHES = 0  # the paths' runs start here
    mesh = make_mesh("cuda")
    layer = phase_moe_layer(card)
    moe = phase_moe_lm(card, work, data_dir, port, mesh)
    device = phase_lm_device(card, work, data_dir, port, lm["train"]["lm_4k"])
    launches = fused_dense.LAUNCHES  # ... and end here
    say("lm", f"fused_dense_relu launches over phase 13's paths: {launches}; "
              f"phase 13 took {time.perf_counter() - t0:.1f} s")
    if launches:
        raise AssertionError("phase 13's paths launched fused_dense_relu")
    return {"layer": layer, "moe": moe, "device": device,
            "launches": launches}


# ------------------------------- phase 14: continuous serving of lm_4k

def cont_model(dtype_name: str, seed: int = 0):
    """An lm_4k model, seeded; ``dtype_name`` picks its compute dtype."""
    seq_len, vocab = LM_4K
    cd = torch.bfloat16 if dtype_name == "bf16" else None
    return TransformerLM(vocab_size=vocab, seq_len=seq_len, compute_dtype=cd,
                         **LM_WIDTH).init(torch.Generator().manual_seed(seed))


def cont_checkpoint(logdir: str, step: int, seed: int) -> None:
    save_checkpoint(logdir, {"params": params_to_numpy(cont_model("f32",
                                                                  seed)),
                             "step": np.int32(step)}, step)


def slot_feed(step: int, seed: int):
    """Phase 14a's inputs at iteration ``step``: CONT_SLOTS slots, the
    live ones at CONT_STEP_T plus ``step``, each on its own pages (mapped
    up to that position), the free ones (CONT_FREE) on the scratch page
    at position 0 with token 0, as the scheduler leaves them."""
    seq_len, vocab = LM_4K
    per_slot = seq_len // CONT_PAGE
    table = np.zeros((CONT_SLOTS, per_slot), np.int32)
    t = np.zeros(CONT_SLOTS, np.int32)
    tok = np.random.default_rng(seed + step).integers(
        0, vocab, CONT_SLOTS).astype(np.int32)
    page = 1
    for i, t0 in enumerate(CONT_STEP_T):
        if i in CONT_FREE:
            tok[i] = 0
            continue
        t[i] = min(t0 + step, seq_len - 1)
        need = (t0 + CONT_REPLAYS - 1) // CONT_PAGE + 1
        table[i, :need] = np.arange(page, page + need)
        page += need
    assert page - 1 <= CONT_STEP_PAGES
    return table, tok, t


def cont_engine(dtype_name: str, logdir: str):
    from distributed_tensorflow_tpu_torch.serving.engine import (
        InferenceEngine,
    )

    return InferenceEngine(cont_model(dtype_name), logdir,
                           device=CONT_DEVICE, max_batch=4)


def phase_slot_step(card: str, work: str) -> dict:
    """14a: the slot step on the card against its eager CPU run, f32 and
    bf16; 20 replays of the backend's CUDA graph against 20 eager steps
    on the card, and a capture under deterministic algorithms; the step's
    time eager and replayed."""
    from distributed_tensorflow_tpu_torch.serving import decode as dec
    from distributed_tensorflow_tpu_torch.serving.continuous import (
        EngineSlotBackend,
    )

    logdir = os.path.join(work, "cont-step")
    cont_checkpoint(logdir, 1, seed=0)
    out = {}
    live = [i for i in range(CONT_SLOTS) if i not in CONT_FREE]
    for tag in DTYPES:
        tol = CONT_STEP_TOL[tag]
        model = cont_model(tag)
        step_fn = dec.make_slot_step(model, CONT_PAGE)
        table, tok, t = slot_feed(0, seed=11)
        g = torch.Generator().manual_seed(3)
        cpu_pools = tuple(tuple(
            (torch.randn(p.shape, generator=g) * 0.5).to(p.dtype)
            for p in pair) for pair in dec.make_slot_pools(
                model, CONT_PAGE, CONT_STEP_PAGES))
        dev_pools = tuple(tuple(p.to(CONT_DEVICE) for p in pair)
                          for pair in cpu_pools)
        dev_model = copy.deepcopy(model).to(CONT_DEVICE)
        args = [torch.from_numpy(a) for a in (table, tok, t)]
        with torch.no_grad():
            want = step_fn(model, cpu_pools, *args)
            got = step_fn(dev_model, dev_pools,
                          *(a.to(CONT_DEVICE) for a in args)).cpu()
        logit_err = rel_err(got[live], want[live])
        rows = torch.from_numpy(table[live, t[live] // CONT_PAGE]).long()
        offs = torch.from_numpy(t[live] % CONT_PAGE).long()
        pool_err, pool_bitwise, untouched = 0.0, True, True
        for cpu_pair, dev_pair in zip(cpu_pools, dev_pools):
            for c, d in zip(cpu_pair, dev_pair):
                d = d.cpu()
                pool_err = max(pool_err, rel_err(d[rows, offs], c[rows, offs]))
                pool_bitwise &= bool(torch.equal(d[rows, offs], c[rows, offs]))
                mask = torch.ones(c.shape[:2], dtype=torch.bool)
                mask[rows, offs] = False
                mask[0, 0] = False  # the free slots' scratch writes
                untouched &= bool(torch.equal(d[mask], c[mask]))
        say("continuous", f"14a {tag} slot step on the card vs its eager CPU "
                          f"run ({CONT_SLOTS} slots, page {CONT_PAGE}, t "
                          f"{list(CONT_STEP_T)}, free {list(CONT_FREE)}): "
                          f"logits {logit_err:.3e} of scale, written pool "
                          f"rows {pool_err:.3e} (bitwise {pool_bitwise}), "
                          f"other rows untouched {untouched} (tolerance "
                          f"{tol})")
        if not (logit_err <= tol and pool_err <= tol and untouched):
            raise AssertionError(f"{tag}: the slot step on the card "
                                 f"disagrees with the CPU")
        # the backend's graph against eager steps of the same module on
        # fresh pools on the card, and a capture under deterministic
        # algorithms (index_put_'s sorting path, with the free slots'
        # duplicate scratch writes)
        engine = cont_engine(tag, logdir)
        on_card = torch.device(CONT_DEVICE).type == "cuda"
        backends = {
            name: EngineSlotBackend(engine, n_slots=CONT_SLOTS,
                                    page_size=CONT_PAGE,
                                    num_pages=CONT_STEP_PAGES)
            for name in ("graph", "deterministic")}
        eager_module = engine.current()[0]
        eager_pools = dec.make_slot_pools(model, CONT_PAGE, CONT_STEP_PAGES,
                                          device=CONT_DEVICE)

        def eager_step(*feed):
            with torch.no_grad():
                return step_fn(eager_module, eager_pools, *(
                    torch.from_numpy(a).to(CONT_DEVICE)
                    for a in feed)).cpu().numpy()

        steppers = {"eager": eager_step,
                    **{name: be.step for name, be in backends.items()}}
        logits = {name: [] for name in steppers}
        ms = {}
        for name, stepper in steppers.items():
            if name == "deterministic":
                torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for i in range(CONT_REPLAYS):
                    logits[name].append(stepper(*slot_feed(i, seed=11)))
                    if i == 1:  # the capture is behind us
                        t1 = time.perf_counter()
                ms[name] = (time.perf_counter() - t1) * 1e3 / (
                    CONT_REPLAYS - 2)
            finally:
                torch.use_deterministic_algorithms(False)
        eager = np.stack(logits["eager"])
        replay_bitwise = bool(np.array_equal(np.stack(logits["graph"]),
                                             eager))
        pools_bitwise = all(
            torch.equal(a, b) for pa, pb in zip(eager_pools,
                                                backends["graph"].pools)
            for a, b in zip(pa, pb))
        det = np.stack(logits["deterministic"])[:, live]
        det_err = float(np.abs(det - eager[:, live]).max()
                        / np.abs(eager[:, live]).max())
        det_bitwise = bool(np.array_equal(det, eager[:, live]))
        captures = {n: b.captures for n, b in backends.items()}
        say("continuous", f"14a {tag}: {CONT_REPLAYS} graph replays vs "
                          f"{CONT_REPLAYS} eager steps on the card: logits "
                          f"bitwise {replay_bitwise}, pools bitwise "
                          f"{pools_bitwise}; captured under deterministic "
                          f"algorithms: live logits {det_err:.3e} of scale "
                          f"(bitwise {det_bitwise}); captures {captures}")
        say("times", f"14a {tag} slot step ({CONT_SLOTS} slots, "
                     f"{LM_4K[0]}-token capacity): eager "
                     f"{ms['eager']:.4f} ms, graph {ms['graph']:.4f} ms an "
                     f"iteration, host clock with the logits' readback | "
                     f"{card}")
        if on_card and not (replay_bitwise and pools_bitwise
                            and captures["graph"] == 1):
            raise AssertionError(f"{tag}: graph replays differ from eager "
                                 f"steps on the card")
        if not det_err <= tol:
            raise AssertionError(f"{tag}: the step captured under "
                                 f"deterministic algorithms disagrees")
        out[tag] = {"logit_err": logit_err, "pool_err": pool_err,
                    "pool_bitwise": pool_bitwise,
                    "replay_bitwise": replay_bitwise,
                    "det_err": det_err, "det_bitwise": det_bitwise,
                    "eager_ms": ms["eager"], "graph_ms": ms["graph"]}
        del backends, engine, dev_pools, dev_model, eager_pools
    return out


def cont_stack(logdir: str, *extra: str):
    """(engine, client, metrics, server) of ``build_serving_stack`` over
    the lm_4k checkpoint in ``logdir``, bf16, serving on an ephemeral
    port."""
    flags.define_flags()
    flags.FLAGS._reset()
    flags.FLAGS._parse(
        ["--logdir", logdir, *lm_args(*LM_4K), "--bf16", "--serve_port",
         "0", "--serve_reload_secs", "0", "--serve_timeout_ms", "600000",
         "--serve_max_new_tokens", str(CONT_MAX_NEW), *extra])
    engine, client, _watcher, metrics = build_serving_stack(flags.FLAGS)
    server = InferenceServer(engine, client, port=0).start_background()
    return engine, client, metrics, server


def cont_close(client, metrics, server) -> None:
    server.close()
    client.generate_batcher.close()
    client.predict_batcher.close()
    metrics.logger.close()


def tie_check(got: list, prompts: list, ref: dict, tol: float) -> dict:
    """Continuous tokens against whole-batch ``generate`` output ``ref``
    for the same prompts: a request whose tokens first differ at a
    position where the reference's top-2 margin is within ``tol`` of its
    logits' scale is a near tie, counted and not failed."""
    out = {"equal": 0, "near_tie": 0, "mismatch": 0}
    for i, (toks, prompt) in enumerate(zip(got, prompts)):
        p = len(prompt)
        want = ref["tokens"][i]
        diff = np.flatnonzero(np.asarray(toks)[p:] != want[p:])
        if not diff.size:
            out["equal"] += 1
            continue
        row = ref["logits"][i, diff[0]]
        top2 = np.sort(row)[-2:]
        tie = (top2[1] - top2[0]) <= tol * float(np.abs(ref["logits"][i])
                                                  .max())
        out["near_tie" if tie else "mismatch"] += 1
    return out


def post_all(url: str, bodies: list, threads: int) -> tuple[list, list]:
    """POST every body from ``threads`` closed-loop clients; returns the
    responses and each request's client-side latency (s), by index."""
    outs, lat = [None] * len(bodies), [0.0] * len(bodies)
    nxt = iter(range(len(bodies)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t0 = time.perf_counter()
            outs[i] = _post(url, bodies[i])
            lat[i] = time.perf_counter() - t0

    pool = [threading.Thread(target=client) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=900)
    if any(o is None for o in outs):
        raise AssertionError("a closed-loop client did not finish")
    return outs, lat


def phase_cont_serve(card: str, work: str) -> dict:
    """14b and 14c: HTTP generates through the continuous scheduler, then
    a hot reload under traffic."""
    from distributed_tensorflow_tpu_torch.serving import decode as dec
    from distributed_tensorflow_tpu_torch.serving import reqtrace

    logdir = os.path.join(work, "cont-serve")
    cont_checkpoint(logdir, 1, seed=0)
    tol = LM_SERVE_TOL["bf16"]
    engine, client, metrics, server = cont_stack(
        logdir, "--serve_scheduler", "continuous", "--serve_slots",
        str(CONT_SLOTS))
    batcher = client.generate_batcher
    backend = batcher.scheduler.backend
    url = server.address + "/v1/generate"
    rng = np.random.default_rng(17)
    vocab = LM_4K[1]
    shapes = [CONT_SHAPES[i % len(CONT_SHAPES)] for i in range(CONT_REQUESTS)]
    prompts = [rng.integers(0, vocab, p).astype(np.int32) for p, _ in shapes]
    try:
        t0 = time.perf_counter()
        outs, _lat = post_all(url, [
            {"prompt": pr.tolist(), "max_new_tokens": n}
            for pr, (_, n) in zip(prompts, shapes)], N_THREADS)
        wall = time.perf_counter() - t0
        snap = batcher.scheduler.snapshot()
        captures = backend.captures
        plane = reqtrace.get_plane()
        audit = [s for s in plane.audit_snapshot()
                 if s["route"] == "generate"]
        sums = max(abs(sum(s["phases_ms"].values()) - s["total_ms"])
                   for s in audit if s["disposition"] == "ok")
        with urllib.request.urlopen(server.address + "/metrics",
                                    timeout=60) as r:
            m = json.loads(r.read())
        blocks = {"tail": m["tail"] is not None,
                  "kv_pages": (m["hbm"] or {}).get("kv_pages") is not None,
                  "continuous": m["generate"].get("continuous") is not None}
        # whole-batch generate of the same prompts, one call a shape
        check = {"equal": 0, "near_tie": 0, "mismatch": 0}
        for shape in CONT_SHAPES:
            idx = [i for i, s in enumerate(shapes) if s == shape]
            ref = engine.generate(np.stack([prompts[i] for i in idx]),
                                  shape[1])
            c = tie_check([outs[i]["tokens"] for i in idx],
                          [prompts[i] for i in idx], ref, tol)
            for k in check:
                check[k] += c[k]
        say("continuous", f"14b {CONT_REQUESTS} HTTP generates (prompt, new "
                          f"tokens in {CONT_SHAPES}) from {N_THREADS} "
                          f"threads through {CONT_SLOTS} slots in "
                          f"{wall:.3f} s, {snap['iterations']} iterations, "
                          f"slot occupancy {snap['slot_occupancy']}; vs "
                          f"whole-batch generate: {check}; page ledger "
                          f"{snap['page_ledger_ok']}, pages in use after "
                          f"the drain {snap['kv_pages']['pages_in_use']}, "
                          f"high water {snap['kv_pages']['pages_high_water']}"
                          f"; graph captures {captures}; phases vs wall "
                          f"max {sums:.4f} ms over {len(audit)} requests; "
                          f"/metrics blocks {blocks}")
        if check["mismatch"] or not snap["page_ledger_ok"] or \
                snap["kv_pages"]["pages_in_use"] or \
                captures != int(backend.graph) or \
                sums > 0.05 or not all(blocks.values()) or \
                len(audit) != CONT_REQUESTS:
            raise AssertionError("14b: continuous serving failed a check")
        # 14c: a hot reload while requests are in flight
        old_module = engine.current()[0]
        cont_checkpoint(logdir, 2, seed=1)
        rprompts = [rng.integers(0, vocab, CONT_RELOAD_PROMPT).astype(
            np.int32) for _ in range(CONT_RELOAD_INFLIGHT + 1)]
        results = [None] * len(rprompts)

        def go(i):
            results[i] = _post(url, {"prompt": rprompts[i].tolist(),
                                     "max_new_tokens": CONT_MAX_NEW})

        admitted0 = batcher.stats.as_dict()["admitted"]
        inflight = [threading.Thread(target=go, args=(i,))
                    for i in range(CONT_RELOAD_INFLIGHT)]
        for t in inflight:
            t.start()
        deadline = time.monotonic() + 120
        while (batcher.stats.as_dict()["admitted"] - admitted0
               < CONT_RELOAD_INFLIGHT
               or batcher.stats.as_dict()["queue_depth"]) and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        reload = _post(server.address + "/admin/reload", {})
        it_swap = batcher.scheduler.snapshot()["iterations"]
        late = threading.Thread(target=go, args=(CONT_RELOAD_INFLIGHT,))
        late.start()
        for t in inflight + [late]:
            t.join(timeout=600)
        ids = {r["request_id"] for r in results[:-1]}
        retired = [s["iter_retire"] for s in reqtrace.get_plane()
                   .audit_snapshot() if s["request_id"] in ids]
        spanned = len(retired) == len(ids) and min(retired) > it_swap
        old = dec.generate(old_module, np.stack(
            rprompts[:CONT_RELOAD_INFLIGHT]), CONT_MAX_NEW)
        new = engine.generate(rprompts[-1][None], CONT_MAX_NEW)
        c_old = tie_check([r["tokens"] for r in results[:-1]],
                          rprompts[:-1], old, tol)
        c_new = tie_check([results[-1]["tokens"]], rprompts[-1:], new, tol)
        differ = results[-1]["tokens"] != dec.generate(
            old_module, rprompts[-1][None], CONT_MAX_NEW)["tokens"][0].tolist()
        say("continuous", f"14c reload with {CONT_RELOAD_INFLIGHT} requests "
                          f"of {CONT_MAX_NEW} new tokens in flight (swapped "
                          f"by iteration {it_swap}, they retired at "
                          f"{sorted(retired)}): {reload}; "
                          f"in-flight vs the old checkpoint's whole-batch "
                          f"generate {c_old}; the request after the drain vs "
                          f"the new checkpoint's {c_new} (differs from the "
                          f"old's: {differ}); captures {backend.captures}, "
                          f"pinned step {backend.params_step}")
        if not (reload["reloaded"] and reload["params_step"] == 2) or \
                not spanned or c_old["mismatch"] or c_new["mismatch"] or not differ or \
                backend.captures != 2 * int(backend.graph) or \
                backend.params_step != 2:
            raise AssertionError("14c: the hot reload under traffic failed")
    finally:
        cont_close(client, metrics, server)
    return {"wall_s": wall, "check": check, "snapshot": snap,
            "reload_old": c_old, "reload_new": c_new}


def bench_bodies() -> list:
    """14d's long-tail mix: prompt 64, 32 new tokens, every 10th request
    256 (the 8:1 long-to-short ratio of the JAX bench's continuous
    cell)."""
    rng = np.random.default_rng(23)
    return [{"prompt": rng.integers(0, LM_4K[1], LM_PROMPT).tolist(),
             "max_new_tokens": (CONT_BENCH_LONG if i % 10 == 9
                                else CONT_BENCH_SHORT)}
            for i in range(CONT_BENCH_REQUESTS)]


def phase_cont_bench(card: str, work: str) -> dict:
    """14d: whole-batch against continuous at an equal KV token budget,
    closed loop, in turns; then the slot step's graph time and the card's
    busy share over profiled iterations. No bar."""
    from distributed_tensorflow_tpu_torch.serving import reqtrace
    from distributed_tensorflow_tpu_torch.utils.profiling import busy_share

    logdir = os.path.join(work, "cont-bench")
    cont_checkpoint(logdir, 1, seed=0)
    bodies = bench_bodies()
    new_tokens = sum(b["max_new_tokens"] for b in bodies)
    arms = {
        "whole_batch": cont_stack(logdir, "--serve_max_batch",
                                  str(CONT_WHOLE_BATCH)),
        "continuous": cont_stack(logdir, "--serve_scheduler", "continuous",
                                 "--serve_slots", str(CONT_SLOTS),
                                 "--serve_kv_pages", str(CONT_KV_PAGES),
                                 "--serve_kv_page", str(CONT_PAGE))}
    rows = {name: [] for name in arms}
    try:
        for name, (_e, _c, _m, server) in arms.items():  # warm-up
            post_all(server.address + "/v1/generate", bodies[:4], 4)
        for name in ("whole_batch", "continuous", "continuous",
                     "whole_batch"):
            _engine, client, _metrics, server = arms[name]
            plane = reqtrace.configure_from_flags(flags.FLAGS)
            t0 = time.perf_counter()
            _outs, lat = post_all(server.address + "/v1/generate", bodies,
                                  CONT_BENCH_CLIENTS)
            wall = time.perf_counter() - t0
            tail = plane.tail_report()["routes"]["generate"]
            qw = max(e["phases"]["queue_wait"]["p99_ms"]
                     for e in tail.values())
            lat_ms = np.asarray(lat) * 1e3
            row = {"tokens_per_s": new_tokens / wall,
                   "p50_ms": float(np.percentile(lat_ms, 50)),
                   "p99_ms": float(np.percentile(lat_ms, 99)),
                   "queue_wait_p99_ms": qw, "wall_s": wall}
            sched = getattr(client.generate_batcher, "scheduler", None)
            row["kv_pages_high_water"] = (
                sched.snapshot()["kv_pages"]["pages_high_water"]
                if sched is not None else None)
            rows[name].append(row)
            say("times", f"14d {name}: {CONT_BENCH_REQUESTS} requests "
                         f"from {CONT_BENCH_CLIENTS} closed-loop clients in "
                         f"{wall:.3f} s: {row['tokens_per_s']:.1f} generated "
                         f"tokens/s, request p50 {row['p50_ms']:.3f} ms, p99 "
                         f"{row['p99_ms']:.3f} ms, queue_wait p99 {qw:.3f} "
                         f"ms (tail block), KV pages high water "
                         f"{row['kv_pages_high_water']} | {card}")
        # the slot step alone: 12 live slots at the mixed positions
        backend = arms["continuous"][1].generate_batcher.scheduler.backend
        feed = slot_feed(0, seed=29)
        step_ms = []
        for _ in range(CONT_PROFILE_ITERS):
            t0 = time.perf_counter()
            backend.step(*feed)
            step_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms = None
        if torch.device(CONT_DEVICE).type == "cuda":
            device_ms = cuda_ms(lambda: backend._graph.replay(),
                                reps=CONT_PROFILE_ITERS)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(_PROFILE_MARGIN_S)  # the loop's margins, same reason
            with torch.profiler.record_function(PROFILED_STEPS):
                for _ in range(CONT_PROFILE_ITERS):
                    backend.step(*feed)
                torch.cuda.synchronize(CONT_DEVICE)
            time.sleep(_PROFILE_MARGIN_S)
        busy = busy_share(prof.events(), window=PROFILED_STEPS)
        trace = os.path.join(work, "cont-step-trace.json")
        prof.export_chrome_trace(trace)
        tk = trace_kernels(trace, CONT_PROFILE_ITERS)
        say("times", f"14d continuous slot step ({CONT_SLOTS} slots, "
                     f"{CONT_KV_PAGES} pages of {CONT_PAGE}): "
                     f"{np.mean(step_ms):.4f} ms an iteration on the host "
                     f"clock with the readback, graph replay "
                     f"{device_ms if device_ms is None else round(device_ms, 4)}"
                     f" ms on the card (CUDA events), busy share "
                     f"{busy} over {CONT_PROFILE_ITERS} profiled iterations; "
                     f"{tk['kernels_per_step']:.1f} kernels, "
                     f"{tk['busy_us_per_step']:.1f} us of them and "
                     f"{tk['idle_us_per_step']:.1f} us idle between them an "
                     f"iteration; top kernels (us an iteration) "
                     f"{[(n, round(t, 1)) for n, t in tk['top_us_per_step']]}"
                     f" | {card}")
    finally:
        for _engine, client, metrics, server in arms.values():
            cont_close(client, metrics, server)
    return {"arms": rows, "step_ms": float(np.mean(step_ms)),
            "device_ms": device_ms, "busy_share": busy, **tk}


def phase_continuous(card: str, work: str) -> dict:
    """Phase 14; ``fused_dense_relu`` must not launch over 14b-14d."""
    t0 = time.perf_counter()
    step = phase_slot_step(card, work)
    fused_dense.LAUNCHES = 0  # the continuous serving paths start here
    served = phase_cont_serve(card, work)
    bench = phase_cont_bench(card, work)
    launches = fused_dense.LAUNCHES  # ... and end here
    say("continuous", f"fused_dense_relu launches over phase 14's paths: "
                      f"{launches}; phase 14 took "
                      f"{time.perf_counter() - t0:.1f} s")
    if launches:
        raise AssertionError("phase 14's paths launched fused_dense_relu")
    return {"step": step, "serve": served, "bench": bench,
            "launches": launches}


# ----------------------------- phase 15: the model axis on one card

def tp_args(rank: int, port: int) -> tuple[str, ...]:
    """A rank of the 1 x TP_WAYS grid on this card."""
    hosts = ",".join([f"127.0.0.1:{port}"] * TP_WAYS)
    return ("--mode", "sync", "--model_axis", str(TP_WAYS), "--worker_hosts",
            hosts, "--task_index", str(rank))


def _nccl_rank(rank: int, port: int, work: str) -> None:
    """One of two ranks of an NCCL group on cuda:0; writes what the
    group's first collective did to ``nccl{rank}.txt``."""
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=TP_WAYS)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        said = f"all_reduce returned {t.tolist()}"
    except Exception as e:  # noqa: BLE001 — what NCCL says is the result
        said = f"{type(e).__name__}: {e}"
    with open(os.path.join(work, f"nccl{rank}.txt"), "w") as f:
        f.write(said)


def spawn_ranks(target, *args, timeout: float) -> None:
    """``target(rank, *args)`` in TP_WAYS spawned processes on this card;
    every one must exit 0 within ``timeout`` seconds (a straggler is
    killed, and the phase fails)."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args))
             for rank in range(TP_WAYS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * TP_WAYS:
        raise AssertionError(f"{target.__name__} ranks exited {codes}")


def nccl_refusal(work: str) -> str:
    """What NCCL says when two ranks of one communicator share the card
    (the phase's first line: why its group is gloo)."""
    outs = [os.path.join(work, f"nccl{r}.txt") for r in range(TP_WAYS)]
    try:
        spawn_ranks(_nccl_rank, free_port(), work, timeout=TP_NCCL_S)
    except AssertionError as e:
        return f"the NCCL ranks did not finish ({e})"
    said = [open(p).read().strip() if os.path.exists(p) else "" for p in outs]
    # NCCL's own reason is the last line of its error
    return " | ".join(s.splitlines()[-1][:300] if s else "nothing"
                      for s in said)


def tp_cnn_args(steps: int, display: int) -> tuple[str, ...]:
    """Phase 5's recipe (adam 1e-3, batch 128, dropout on) with
    ``--pallas``."""
    return ("--training_iter", str(steps), "--display_step", str(display),
            "--test_eval", "false")


def tp_lm_args(steps: int, display: int) -> tuple[str, ...]:
    """The dense LM at lm_4k with the flash attention, batch 8."""
    return (*lm_args(*LM_4K), "--attn_block", str(LM_ATTN_BLOCK),
            "--learning_rate", "0.001", "--keep_prob", "1.0",
            "--batch_size", str(LM_4K_BATCH), "--training_iter", str(steps),
            "--display_step", str(display), "--test_eval", "false")


def tp_rank(rank: int, port: int, work: str, data_dir: str) -> None:
    """One rank of phase 15, a spawned process: joins the gloo group as a
    library caller, then trains through ``train(FLAGS, mode="sync")``
    with ``--model_axis 2``: (a) deep_cnn ``--pallas`` in f32 and bf16,
    the kernel's calls recorded by shape; (b) the LM at lm_4k; (c) the f32
    grid's sharded set and phase 15's one-rank monolithic file, each
    resumed by the grid; (d) timed and profiled runs. Writes what it saw
    to ``tp-rank{rank}.json``."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=TP_WAYS)
    grid = tp_args(rank, port)
    calls = []
    kernel = cnn.fused_dense_relu

    def recorded(x, w, b):
        calls.append([*x.shape, *w.shape, w.is_contiguous(),
                      w.data_ptr() % 16 == 0, w.data_ptr() != 0])
        return kernel(x, w, b)

    cnn.fused_dense_relu = recorded
    out = {}

    def logdir(name):
        return os.path.join(work, name)

    for tag in DTYPES:
        del calls[:]
        fused_dense.LAUNCHES = 0  # the main path's run starts here
        fused_dense.LAUNCHES_BY_VARIANT.update(tma=0, simt=0)
        run = TrainRun(logdir(f"tp-grid-{tag}"), data_dir, tag, True,
                       *tp_cnn_args(TP_STEPS, 1), *grid, mode="sync")
        out[f"cnn-{tag}"] = {
            "launches": fused_dense.LAUNCHES,  # ... and ends here
            "by_variant": dict(fused_dense.LAUNCHES_BY_VARIANT),
            "calls": sorted({json.dumps(c) for c in calls}),
            "n_calls": len(calls),
            "losses": run.records("mini_batch_loss") if rank == 0 else {},
            "final_step": run.result.final_step}
    saved = datasets.LM_TRAIN, datasets.LM_TEST
    datasets.LM_TRAIN, datasets.LM_TEST = LM_SPLIT
    try:
        for tag in DTYPES:
            fused_dense.LAUNCHES = 0
            run = TrainRun(logdir(f"tp-lm-{tag}"), data_dir, tag, False,
                           *tp_lm_args(TP_LM_STEPS, 1), *grid, mode="sync")
            out[f"lm-{tag}"] = {
                "launches": fused_dense.LAUNCHES,
                "losses": run.records("mini_batch_loss") if rank == 0
                else {}, "final_step": run.result.final_step}
        for tag in DTYPES:
            out[f"lm-time-{tag}"] = tp_timed(
                logdir, data_dir, tag, False, grid, rank, "lm",
                tp_lm_args(TP_LM_STEPS, 1000),
                tp_lm_args(TP_LM_PROFILE + 1, 1000), TP_LM_PROFILE)
    finally:
        datasets.LM_TRAIN, datasets.LM_TEST = saved
    # (c) the grid resumes its own sharded set and the one-rank file
    for src in ("tp-grid-f32", "tp-one-f32"):
        dst = logdir(f"{src}-by-grid")
        if rank == 0:
            shutil.copytree(logdir(src), dst)
        dist.barrier()
        run = TrainRun(dst, data_dir, "f32", True,
                       *tp_cnn_args(TP_STEPS + TP_RESUME, 1), *grid,
                       mode="sync")
        out[f"resume-{src}"] = {
            "losses": run.records("mini_batch_loss") if rank == 0 else {},
            "restored": run.records("recovery_restore_step") if rank == 0
            else {}, "final_step": run.result.final_step}
    for tag in DTYPES:
        out[f"time-{tag}"] = tp_timed(
            logdir, data_dir, tag, True, grid, rank, "cnn",
            tp_cnn_args(TP_TIME_STEPS, 10 * TP_TIME_STEPS),
            tp_cnn_args(2 * TP_PROFILE, 10 * TP_TIME_STEPS), TP_PROFILE)
    cnn.fused_dense_relu = kernel
    with open(os.path.join(work, f"tp-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def tp_timed(logdir, data_dir: str, tag: str, pallas: bool, grid, rank: int,
             name: str, timed_args, profiled_args, profile_steps: int):
    """A rank's rate over a run's steps after the first, with no
    profiler, and the busy share of a second run's profiled steps (the
    profiler's own cost stays out of the rate; its run's rate beside
    it)."""
    timed = TrainRun(logdir(f"tp-{name}-time-{tag}-{rank}"), data_dir, tag,
                     pallas, *timed_args, *grid, mode="sync")
    prof = TrainRun(logdir(f"tp-{name}-prof-{tag}-{rank}"), data_dir, tag,
                    pallas, *profiled_args, *grid, "--profile_dir",
                    logdir(f"tp-{name}-trace-{tag}-{rank}"),
                    "--profile_steps", str(profile_steps), mode="sync")
    return {"images_per_sec": timed.result.images_per_sec,
            "profiled_images_per_sec": prof.result.images_per_sec,
            "busy": prof.result.device_busy_share}


def tp_close(got: dict, want: dict, tol: float, what: str,
             phase: str = "model axis") -> float:
    """max |got - want| / max(1, |want|) over the steps of ``want``, which
    must be ``got``'s steps; raises past ``tol``."""
    got = {int(k): v for k, v in got.items()}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: steps {sorted(got)} against "
                             f"{sorted(want)}")
    worst = max(rel_diffs(got, want))
    say(phase, f"{what}: max |diff|/max(1,|loss|) {worst:.3e} "
                      f"(tolerance {tol}); losses {[round(want[s], 5) for s in sorted(want)]}")
    if not worst <= tol:
        raise AssertionError(f"{what}: the model axis leaves the one-rank "
                             f"run")
    return worst


def phase_model_axis(card: str, work: str, data_dir: str) -> dict:
    """Phase 15: two ranks on this card (gloo: see the first line),
    against one-rank runs in this process; parity only, the times are
    gloo-staged."""
    t0 = time.perf_counter()
    say("model axis", f"two ranks share cuda:0, so the grid's group is "
                      f"gloo; NCCL with two ranks on this card says: "
                      f"{nccl_refusal(work)}")
    one = {}
    for tag in DTYPES:
        run = TrainRun(os.path.join(work, f"tp-one-{tag}"), data_dir, tag,
                       True, *tp_cnn_args(TP_STEPS, 1))
        one[f"cnn-{tag}"] = run.records("mini_batch_loss")
    saved = datasets.LM_TRAIN, datasets.LM_TEST
    datasets.LM_TRAIN, datasets.LM_TEST = LM_SPLIT
    try:
        for tag in DTYPES:
            run = TrainRun(os.path.join(work, f"tp-one-lm-{tag}"), data_dir,
                           tag, False, *tp_lm_args(TP_LM_STEPS, 1))
            one[f"lm-{tag}"] = run.records("mini_batch_loss")
    finally:
        datasets.LM_TRAIN, datasets.LM_TEST = saved
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spawn_ranks(tp_rank, free_port(), work, data_dir, timeout=TP_JOIN_S)
    ranks = [json.load(open(os.path.join(work, f"tp-rank{r}.json")))
             for r in range(TP_WAYS)]
    out = {"launches": {}}
    # (a) deep_cnn --pallas: losses, launches, the kernel on the shard
    forwards = 2 * TP_STEPS  # a train step and a display eval a step
    for tag in DTYPES:
        tp_close(ranks[0][f"cnn-{tag}"]["losses"], one[f"cnn-{tag}"],
                 TRAJ_TOL[tag], f"(a) deep_cnn --pallas {tag}, {TP_STEPS} "
                 f"steps, 1x{TP_WAYS} grid vs one rank, dropout on")
        for r, got in enumerate(ranks):
            g = got[f"cnn-{tag}"]
            calls = [json.loads(c) for c in g["calls"]]
            say("model axis", f"(a) {tag} rank {r}: kernel launches "
                              f"{g['launches']} {g['by_variant']} for "
                              f"{forwards} forward passes; calls (M, K, K, "
                              f"N, contiguous, 16-byte aligned, own storage)"
                              f" {calls}")
            if g["launches"] != forwards or g["n_calls"] != forwards or \
                    g["by_variant"] != {"tma": forwards, "simt": 0}:
                raise AssertionError(f"{tag} rank {r}: the kernel must "
                                     f"launch once per forward pass, as "
                                     f"tma")
            if any(c[3] != 1024 // TP_WAYS or not all(c[4:]) for c in calls):
                raise AssertionError(f"{tag} rank {r}: the kernel ran off "
                                     f"this rank's contiguous column shard")
        out["launches"][tag] = sum(g[f"cnn-{tag}"]["launches"]
                                   for g in ranks)
    # (b) the LM at lm_4k
    for tag in DTYPES:
        tp_close(ranks[0][f"lm-{tag}"]["losses"], one[f"lm-{tag}"],
                 TP_LM_TOL[tag], f"(b) LM lm_4k flash {tag}, "
                 f"{TP_LM_STEPS} steps, 1x{TP_WAYS} grid vs one rank")
        if any(g[f"lm-{tag}"]["launches"] for g in ranks):
            raise AssertionError("the LM's model axis launched the kernel")
    # (c) the sharded set: inspect reads it; resumes across the layouts
    grid_dir = os.path.join(work, "tp-grid-f32")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ckpt_inspect.main(["--logdir", grid_dir, "--verify"])
    shards = sorted(n for n in os.listdir(grid_dir) if ".shard" in n)
    say("model axis", f"(c) the grid's set at step {TP_STEPS}: {shards}; "
                      f"checkpoint.inspect --verify exit {rc}: "
                      f"{buf.getvalue().strip().splitlines()[:2]}")
    if rc != 0 or len(shards) != TP_WAYS:
        raise AssertionError("the grid's sharded set does not verify")
    stop = TP_STEPS + TP_RESUME
    for src in ("tp-grid-f32", "tp-one-f32"):
        dst = os.path.join(work, f"{src}-by-one")
        shutil.copytree(os.path.join(work, src), dst)
        run = TrainRun(dst, data_dir, "f32", True, *tp_cnn_args(stop, 1))
        by_grid = ranks[0][f"resume-{src}"]
        if by_grid["restored"].get(str(TP_STEPS)) != TP_STEPS or \
                run.records("recovery_restore_step").get(TP_STEPS) != \
                TP_STEPS:
            raise AssertionError(f"{src}: a resume did not restore step "
                                 f"{TP_STEPS}")
        resumed = {s: v for s, v in run.records("mini_batch_loss").items()
                   if s >= TP_STEPS}
        tp_close({s: v for s, v in by_grid["losses"].items()
                  if int(s) >= TP_STEPS}, resumed, TRAJ_TOL["f32"],
                 f"(c) {src}'s checkpoint resumed by the grid vs by one "
                 f"rank, steps {TP_STEPS}-{stop - 1}")
    # (d) times, gloo-staged
    for tag in DTYPES:
        for r, got in enumerate(ranks):
            for path, t, unit in (("deep_cnn --pallas", got[f"time-{tag}"],
                                   128), ("LM lm_4k", got[f"lm-time-{tag}"],
                                          LM_4K_BATCH)):
                busy = t["busy"]
                say("model axis", f"(d) {path} {tag} rank {r}: "
                                  f"{unit * 1e3 / t['images_per_sec']:.4f} "
                                  f"ms/step ("
                                  f"{unit * 1e3 / t['profiled_images_per_sec']:.4f}"
                                  f" in the profiled run), busy share "
                                  f"{'not measured' if busy is None else f'{busy:.4f}'}"
                                  f" — gloo-staged, not a TP time (two "
                                  f"ranks share one card, collectives "
                                  f"through the host) | {card}")
    say("model axis", f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------- phase 16: sequence parallelism on one card

def sp_lm_args(seq_len: int, vocab: int, steps: int, *extra: str
               ) -> tuple[str, ...]:
    """The LM at bench.py's width, ``seq_len`` by ``vocab``: adam 1e-3,
    dropout off, a display eval every step, no test eval."""
    batch = LM_4K_BATCH if (seq_len, vocab) == LM_4K else LM_BIGV_BATCH
    return (*lm_args(seq_len, vocab), "--learning_rate", "0.001",
            "--keep_prob", "1.0", "--batch_size", str(batch),
            "--training_iter", str(steps), "--display_step", "1",
            "--test_eval", "false", *extra)


def sp_cls_args() -> tuple[str, ...]:
    """The MiniTransformer at its registry widths (d 128, 4 heads, 2
    blocks) at phase 5's recipe."""
    return ("--model", "transformer", "--training_iter", str(SP_CLS_STEPS),
            "--display_step", "1", "--test_eval", "false")


@contextlib.contextmanager
def small_splits():
    """The LM's splits cut to LM_SPLIT and the digits' to SP_DIGITS."""
    saved = (datasets.LM_TRAIN, datasets.LM_TEST, datasets.SYNTHETIC_TRAIN,
             datasets.SYNTHETIC_TEST)
    (datasets.LM_TRAIN, datasets.LM_TEST), (
        datasets.SYNTHETIC_TRAIN, datasets.SYNTHETIC_TEST) = LM_SPLIT, \
        SP_DIGITS
    try:
        yield
    finally:
        (datasets.LM_TRAIN, datasets.LM_TEST, datasets.SYNTHETIC_TRAIN,
         datasets.SYNTHETIC_TEST) = saved


def peak_run(make_run):
    """(run, its peak device bytes above what this process held when it
    started)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run = make_run()
    torch.cuda.synchronize()
    return run, torch.cuda.max_memory_allocated() - held


def sp_ring_check(mesh, tag: str, causal: bool) -> dict:
    """(a) on one rank: ring attention on this rank's token block of
    seeded q/k/v at SP_ATTN_SHAPE against the flash and dense attention
    of the whole sequence (this rank's rows of their output and
    gradients), the bytes the ring sent, and the times of a forward and
    backward of the ring and of one rank's flash."""
    dtype = DTYPES[tag]
    g = torch.Generator().manual_seed(16)
    q, k, v, do = (torch.randn(SP_ATTN_SHAPE, generator=g).to("cuda", dtype)
                   for _ in range(4))
    block = SP_ATTN_SHAPE[1] // mesh.model
    cols = slice(mesh.model_index * block, (mesh.model_index + 1) * block)

    fwd_sent = []  # the ring's bytes after each forward

    def grads(fn, ts, cot):
        ts = [t.clone().requires_grad_() for t in ts]
        out = fn(*ts)
        fwd_sent.append(mesh_mod.RING_BYTES)
        return [out.detach()] + list(torch.autograd.grad(out, ts, cot))

    def ring():
        return grads(lambda *ts: ring_attention(*ts, mesh, causal=causal),
                     [t[:, cols] for t in (q, k, v)], do[:, cols])

    def flash():
        return grads(lambda *ts: blockwise_attention(*ts, LM_ATTN_BLOCK,
                                                     causal=causal),
                     (q, k, v), do)

    mesh_mod.RING_BYTES = 0
    got = ring()
    fwd_bytes, bwd_bytes = fwd_sent[0], mesh_mod.RING_BYTES - fwd_sent[0]
    errs = {}
    for name, fn in (("flash", flash), ("dense", lambda: grads(
            lambda *ts: multi_head_attention(*ts, causal=causal),
            (q, k, v), do))):
        want = [t[:, cols] for t in fn()]
        errs[name] = {n: rel_err(a, b) for n, a, b in
                      zip(("out", "dq", "dk", "dv"), got, want)}
        del want
        torch.cuda.empty_cache()
    kv = block * SP_ATTN_SHAPE[0] * SP_ATTN_SHAPE[2] * SP_ATTN_SHAPE[3]
    rows = sp_comm_rows(kv * q.element_size(), mesh.model, 1)
    # the dk/dv accumulators travel in float32 whatever k's dtype
    want_bwd = mesh.model * 2 * kv * (q.element_size() + 4)
    return {"errs": errs, "fwd_bytes": fwd_bytes,
            "bwd_bytes": bwd_bytes, "rows": [r["bytes"] for r in rows],
            "want_bwd": want_bwd, "ring_ms": cuda_ms(ring),
            "flash_ms": cuda_ms(flash)}


def sp_rank(rank: int, port: int, work: str, data_dir: str) -> None:
    """One rank of phase 16, a spawned process: joins the gloo group as a
    library caller, runs (a) ring attention alone, then trains through
    ``train(FLAGS, mode="sync")`` with ``--seq_parallel --model_axis 2``:
    (b) the LM at lm_4k in f32 and bf16, (c) lm_bigvocab, (d) the
    MiniTransformer; each run's display losses, this rank's peak memory
    and the wd1 kernel's launches. Writes ``sp-rank{rank}.json``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=SP_WAYS)
    grid = (*tp_args(rank, port), "--seq_parallel")
    fused_dense.LAUNCHES = 0  # the main path's runs start here
    mesh = make_mesh("cuda", MeshSpec(model=SP_WAYS))
    out = {"attn": {f"{tag}-{'causal' if c else 'full'}":
                    sp_ring_check(mesh, tag, c)
                    for tag in DTYPES for c in (False, True)}}
    torch.cuda.empty_cache()

    def run(name, tag, *args):
        r, peak = peak_run(lambda: TrainRun(
            os.path.join(work, f"sp-{name}-{tag}"), data_dir, tag, False,
            *args, *grid, mode="sync"))
        out[f"{name}-{tag}"] = {
            "losses": r.records("mini_batch_loss") if rank == 0 else {},
            "peak": peak, "final_step": r.result.final_step}

    with small_splits():
        for tag in DTYPES:
            run("lm4k", tag, *sp_lm_args(*LM_4K, SP_LM_STEPS))
        run("bigv", "bf16", *sp_lm_args(*LM_BIGV, SP_BIGV_STEPS,
                                        "--ce_block", str(LM_CE_BLOCK)))
        for tag in DTYPES:
            run("cls", tag, *sp_cls_args())
    out["launches"] = fused_dense.LAUNCHES  # ... and end here
    with open(os.path.join(work, f"sp-rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_seq_parallel(card: str, work: str, data_dir: str) -> dict:
    """Phase 16: two ranks on this card (gloo, as phase 15), against
    one-rank runs in this process; parity and memory, the times are
    gloo-staged."""
    t0 = time.perf_counter()
    one = {}

    def single(name, tag, *args):
        r, peak = peak_run(lambda: TrainRun(
            os.path.join(work, f"sp-one-{name}-{tag}"), data_dir, tag,
            False, *args))
        one[f"{name}-{tag}"] = {"losses": r.records("mini_batch_loss"),
                                "peak": peak}

    flash = ("--attn_block", str(LM_ATTN_BLOCK))
    with small_splits():
        for tag in DTYPES:
            single("lm4k", tag, *sp_lm_args(*LM_4K, SP_LM_STEPS, *flash))
        single("bigv", "bf16", *sp_lm_args(*LM_BIGV, SP_BIGV_STEPS, *flash,
                                           "--ce_block", str(LM_CE_BLOCK)))
        for tag in DTYPES:
            single("cls", tag, *sp_cls_args())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    spawn_ranks(sp_rank, free_port(), work, data_dir, timeout=SP_JOIN_S)
    ranks = [json.load(open(os.path.join(work, f"sp-rank{r}.json")))
             for r in range(SP_WAYS)]
    # (a) the ring alone
    for case, tol_tag in ((c, c.split("-")[0]) for c in ranks[0]["attn"]):
        for r, got in enumerate(ranks):
            a = got["attn"][case]
            say("seq parallel", f"(a) ring attention {case} "
                                f"{SP_ATTN_SHAPE} 2 ways, rank {r}: errors "
                                f"in units of each output's max, vs flash "
                                + ", ".join(f"{n} {e:.3e}" for n, e in
                                            a["errs"]["flash"].items())
                                + "; vs dense " + ", ".join(
                                    f"{n} {e:.3e}" for n, e in
                                    a["errs"]["dense"].items())
                                + f" (tolerance {SP_ATTN_TOL[tol_tag]}); "
                                f"bytes sent forward {a['fwd_bytes']} "
                                f"backward {a['bwd_bytes']}, sp_comm_rows "
                                f"{a['rows']} (backward with float32 dk/dv "
                                f"{a['want_bwd']}); forward+backward "
                                f"{a['ring_ms']:.3f} ms ring (gloo-staged), "
                                f"{a['flash_ms']:.3f} ms one rank's flash "
                                f"over the whole sequence (CUDA events) | "
                                f"{card}")
            worst = max(e for d in a["errs"].values() for e in d.values())
            if not worst <= SP_ATTN_TOL[tol_tag]:
                raise AssertionError(f"ring attention {case} rank {r} "
                                     f"leaves its plain versions")
            if a["fwd_bytes"] != a["rows"][0] or \
                    a["bwd_bytes"] != a["want_bwd"] or (
                    tol_tag == "f32" and a["bwd_bytes"] != a["rows"][1]):
                raise AssertionError(f"ring attention {case} rank {r}: "
                                     f"its bytes are not sp_comm_rows'")
    # (b)-(d) training against one rank, with each rank's peak memory
    for name, tags, tol, what in (
            ("lm4k", DTYPES, SP_LM_TOL, f"(b) LM lm_4k, {SP_LM_STEPS} "
                                        f"steps, vs one rank's flash"),
            ("bigv", ("bf16",), SP_LM_TOL, f"(c) LM lm_bigvocab "
                                           f"--ce_block {LM_CE_BLOCK}, "
                                           f"{SP_BIGV_STEPS} steps, vs one "
                                           f"rank's flash"),
            ("cls", DTYPES, TRAJ_TOL, f"(d) MiniTransformer, "
                                      f"{SP_CLS_STEPS} steps, dropout on, "
                                      f"vs one rank")):
        for tag in tags:
            key = f"{name}-{tag}"
            tp_close(ranks[0][key]["losses"], one[key]["losses"], tol[tag],
                     f"{what}, {tag}, 1x{SP_WAYS} SP grid",
                     phase="seq parallel")
            say("seq parallel", f"{what}, {tag}: peak memory "
                                + ", ".join(f"rank {r} {g[key]['peak'] / 2**30:.3f} GiB"
                                            for r, g in enumerate(ranks))
                                + f" against one rank's "
                                f"{one[key]['peak'] / 2**30:.3f} GiB | "
                                f"{card}")
    launches = [g["launches"] for g in ranks]
    say("seq parallel", f"fused_dense_relu launches over (a)-(d): "
                        f"{launches} (the path runs no wd1 layer)")
    if any(launches):
        raise AssertionError("the SP path launched the wd1 kernel")
    say("seq parallel", f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return {"launches": sum(launches)}


def phase_model_axis_kernel(card: str, times: dict) -> None:
    """(e): the kernel at the column shards' shapes, from phase 6."""
    for tag in DTYPES:
        for shape in TP_SHAPES:
            row = times[(tag, shape)]
            say("model axis", f"(e) {tag} {shape}: kernel "
                              f"{row['ms'] * 1e3:.2f} us, plain "
                              f"{row['plain_ms'] * 1e3:.2f} us, addmm+relu_ "
                              f"{row['library_ms'] * 1e3:.2f} us, bound "
                              f"{row['bound_ms'] * 1e3:.2f} us "
                              f"({row['bound_by']}) | {card}")


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
        ps_data = write_ps_split(work, data_dir)
        ps = {tag: phase_ps(tag, work, ps_data) for tag in DTYPES}
        phase_ps_mirror_vs_full(work, ps_data)
        phase_ps_times(card, work, ps_data)
        lm = phase_lm(card, work, data_dir)
        port = free_port()
        maybe_initialize_distributed(
            ClusterSpec({"worker": [f"127.0.0.1:{port}"]}), 0, "cuda")
        try:
            complete = phase_lm_complete(card, work, data_dir, port, lm)
        finally:
            dist.destroy_process_group()
        cont = phase_continuous(card, work)
        tp = phase_model_axis(card, work, data_dir)
        sp = phase_seq_parallel(card, work, data_dir)
    times = phase_times(card, served)
    phase_model_axis_kernel(card, times)
    kernels = []
    for tag in DTYPES:
        t = times[(tag, SERVE_SHAPE)]
        by_path = {"serve": served[tag]["launches"],
                   "train": trained[tag]["launches"],
                   "device_resident": resident[tag]["launches"],
                   "ps_worker0": ps[tag]["launches"],
                   "zero3_overlap": zeroed[tag]["launches"],
                   "lm_train_and_serve": lm["launches"],
                   "lm_device_moe_zero": complete["launches"],
                   "lm_continuous_serve": cont["launches"],
                   "model_axis_two_ranks": tp["launches"][tag],
                   "seq_parallel_two_ranks": sp["launches"]}
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
