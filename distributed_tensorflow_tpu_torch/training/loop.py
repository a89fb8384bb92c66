"""The training loop: the reference's hot-loop semantics on the card.

The counterpart of ``distributed_tensorflow_tpu/training/loop.py``'s
``train``, the local and sync branches of ``_train_once``,
``_train_device_resident``, ``_train_zero`` and ``_train_zero_device``
(here ``_ZeroSession`` over the shared loops), ``_HostCoordinator``,
``evaluate_only`` and ``build_model_for``. Reference loop
(``MNISTDist.py:172-188``): while not stopped and ``step <
training_iter``, draw a minibatch; every
``display_step`` print job/task, step and the minibatch loss and accuracy,
evaluated *before* the update with dropout off (``:179-182``); then run one
optimizer step. Termination is on the shared global step. On exit:
``sv.stop()`` and "Optimization Finished!" (``:192-193``).

Host-fed batches are assembled on a host thread into pinned memory and
copied to the card asynchronously (``data/pipeline.py``). With
``--device_data`` the split lives on the device and each step draws its
batch there; on a card a step is one CUDA graph replay
(``training/device_step.py``). Local mode is one process on one device.
Sync mode is one process per device in the ``torch.distributed`` group
the caller joined (``cluster.maybe_initialize_distributed``; the entry
point does), with the gradients averaged every step (``parallel/``);
more than one process agree on a stop every ``--coord_steps`` steps.
``--zero 1|3`` shards the sync run's optimizer state (and at level 3 its
parameters) over the ranks (``parallel/zero.py``); the standard-layout
state then exists only as the host copy that a collective fetch makes at
the steps every rank agrees on (``_ZeroSession``). ``--model_axis m``
makes the group a data x m grid whose rows split the model
(``parallel/tensor_parallel.py``, ``_TPSession``): every checkpoint is
then a coordinated one, each rank writing its own slices. With
``--seq_parallel`` the rows split the sequence instead
(``parallel/sequence_parallel.py``, ``_SPSession``): every rank holds a
token block of its row's batch and the whole replicated state, which the
chief saves and evaluates alone.
``--fault_spec`` is armed at the start of ``train`` and
``evaluate_only``.
"""

from __future__ import annotations

import json
import math
import secrets
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.checkpoint import (
    background_save_from_flags,
    checkpoint_keys,
    latest_checkpoint,
    max_to_keep_from_flags,
    restore_with_fallback,
)
from distributed_tensorflow_tpu_torch.cluster import ClusterSpec
from distributed_tensorflow_tpu_torch.flags import (
    seq_parallel_error,
    training_entry_error,
)
from distributed_tensorflow_tpu_torch.data import (
    batch_iterator,
    prefetch_to_device,
    put_device_data,
    read_data_sets,
)
from distributed_tensorflow_tpu_torch.models import get_model
from distributed_tensorflow_tpu_torch.ops.augment import make_augment
from distributed_tensorflow_tpu_torch.parallel import (
    local_batch_size,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    replicate_state,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    GridMesh,
    MeshSpec,
)
from distributed_tensorflow_tpu_torch.parallel.sequence_parallel import (
    make_sp_eval_step,
    make_sp_train_step,
    reshape_for_sp,
    stage_batch_sp,
)
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    _check_divisibility,
    has_tp_specs,
    make_tp_eval_step,
    make_tp_train_step,
    shard_state_tp,
    tp_clip_transform,
    tp_param_specs,
)
from distributed_tensorflow_tpu_torch.parallel.zero import (
    _check_level,
    fetch_state_zero,
    make_zero_eval_step,
    make_zero_train_step,
    shard_state_zero,
    zero_clip_transform,
)
from distributed_tensorflow_tpu_torch.training.device_step import (
    DeviceTrainStep,
    ZeroDeviceTrainStep,
)
from distributed_tensorflow_tpu_torch.training.schedules import (
    schedule_from_flags,
)
from distributed_tensorflow_tpu_torch.training.supervisor import (
    Supervisor,
    _adopt,
)
from distributed_tensorflow_tpu_torch.training.train_state import (
    clip_by_global_norm,
    create_train_state,
    evaluate,
    get_optimizer,
    make_eval_step,
    make_train_step,
    params_of,
    state_of,
)
from distributed_tensorflow_tpu_torch.utils import faults
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger
from distributed_tensorflow_tpu_torch.utils.pytree import _BF16_TAG
from distributed_tensorflow_tpu_torch.utils.profiling import (
    Throughput,
    busy_share,
    collective_sync_cadence,
)
from distributed_tensorflow_tpu_torch.utils.telemetry import StepTimer


@dataclass
class TrainResult:
    """What a run ends with. ``images_per_sec`` covers the steps after the
    first (warm-up) step or chunk up to the end of the loop, the device
    drained, over the global batch of all ``n_chips`` ranks (for the LM
    an "image" is one sequence: times ``seq_len`` for tokens/s);
    ``device_busy_share`` is the profiled window's (``--profile_dir``),
    None without one or when the trace holds no device time."""

    final_step: int
    train_metrics: dict[str, float]
    test_metrics: dict[str, float] | None
    images_per_sec: float
    device_busy_share: float | None = None
    images_per_sec_per_chip: float = 0.0
    n_chips: int = 1


def build_model_for(FLAGS, meta: dict):
    """The model the flags describe, for a dataset with ``meta``'s shape:
    ``deep_cnn`` (``--pallas`` runs its wd1 layer through the CUDA
    kernel), ``mlp`` (``--hidden_units`` wide), a CIFAR ResNet, the
    row-sequence ``transformer``, or, for token data (``--dataset lm``)
    and only for it, the causal ``lm`` (``--attn_block``, ``--ce_block``
    and ``--remat`` shape its memory; ``--moe_experts``,
    ``--moe_capacity`` and ``--moe_aux`` make its blocks Switch MoE).
    ``--expert_parallel`` raises NotImplementedError."""
    if FLAGS.expert_parallel:
        raise NotImplementedError(
            "--expert_parallel (MoE experts sharded over the mesh's model "
            "axis) is not yet ported to distributed_tensorflow_tpu_torch "
            "(ROADMAP queue 1: the model axis on torch.distributed, then "
            "EP); the MoE LM trains without it (--moe_experts E)")
    compute_dtype = torch.bfloat16 if FLAGS.bf16 else None
    if meta.get("kind") == "lm":
        # token data feeds only the causal LM, and the LM only token data
        if FLAGS.model != "lm":
            raise ValueError(
                f"--dataset lm produces token sequences; --model "
                f"{FLAGS.model!r} is an image model. Use --model lm.")
        return get_model(
            "lm", vocab_size=meta["vocab_size"], seq_len=meta["seq_len"],
            d_model=FLAGS.d_model, num_heads=FLAGS.num_heads,
            num_blocks=FLAGS.num_blocks, compute_dtype=compute_dtype,
            attn_block=FLAGS.attn_block if FLAGS.attn_block > 0 else None,
            remat=bool(FLAGS.remat),
            ce_block=FLAGS.ce_block if FLAGS.ce_block > 0 else None,
            moe_experts=FLAGS.moe_experts, moe_capacity=FLAGS.moe_capacity,
            moe_aux=FLAGS.moe_aux)
    if FLAGS.model == "lm":
        raise ValueError("--model lm consumes token sequences; use "
                         "--dataset lm")
    kwargs = {}
    if FLAGS.model == "deep_cnn":
        kwargs["use_pallas"] = bool(FLAGS.pallas)
    if FLAGS.model == "mlp":
        kwargs["hidden_units"] = FLAGS.hidden_units
    if FLAGS.model == "transformer":
        kwargs.update(d_model=FLAGS.d_model, num_heads=FLAGS.num_heads,
                      num_blocks=FLAGS.num_blocks, remat=bool(FLAGS.remat))
    return get_model(
        FLAGS.model,
        image_size=meta["image_size"],
        channels=meta["channels"],
        num_classes=meta["num_classes"],
        compute_dtype=compute_dtype,
        **kwargs,
    )


def augment_for(FLAGS, meta: dict):
    """``--augment``'s transform for the dataset, or None: crop after
    ``--augment_pad`` of zero padding, and a horizontal flip only for
    3-channel natural images (a mirrored digit is another glyph)."""
    if not FLAGS.augment:
        return None
    if meta.get("kind") == "lm":
        raise ValueError("--augment crops/flips images; token sequences "
                         "(--dataset lm) have no image layout to augment")
    return make_augment(meta, pad=FLAGS.augment_pad,
                        flip=meta["channels"] == 3)


def _full_f32_on(device: torch.device) -> torch.device:
    """``device``, checked; f32 means f32 on the card: cuDNN and cuBLAS
    would take TF32 for f32 by default, and the JAX package runs at
    `highest` precision."""
    from distributed_tensorflow_tpu_torch.serving.engine import (
        resolve_device,
    )

    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log_recovery(sv, logger, step: int) -> None:
    """Where this run's state came from, once per run; a fresh init logs
    restore_step=-1."""
    rep = sv.restore_report
    logger.scalars(step, {
        "recovery_restore_step": float(rep.step) if rep else -1.0,
        "recovery_fallback_depth": float(rep.fallback_depth) if rep else 0.0,
        "recovery_quarantined": float(len(rep.quarantined)) if rep else 0.0,
        "recovery_time_s": round(rep.time_s, 4) if rep else 0.0,
    })


def train(FLAGS, mode: str = "local") -> TrainResult:
    """Run a full training job. "local": one process on ``--device``
    (``cuda`` unless the caller asks for the CPU). "sync": this process
    is rank ``--task_index`` of the ``--worker_hosts`` group, which the
    caller has joined (``cluster.maybe_initialize_distributed``), on its
    own ``--device``. Other modes raise."""
    if mode not in ("local", "sync"):
        raise ValueError(
            f"train runs mode 'local' or 'sync', not {mode!r}; the ps "
            f"topology's roles run in parallel.ps_emulation "
            f"(run_parameter_server, run_worker)")
    _configure_faults(FLAGS)
    err = seq_parallel_error(FLAGS, mode)
    if err is not None:
        raise ValueError(err)
    return _train_once(FLAGS, mode)


def _configure_faults(FLAGS) -> None:
    """Arm ``--fault_spec`` (or DTT_FAULT_SPEC) for this run, after
    refusing what the training entry cannot run
    (``flags.training_entry_error``)."""
    err = training_entry_error(FLAGS)
    if err is not None:
        raise ValueError(err)
    faults.configure_from_flags(FLAGS)


def _sync_mesh(FLAGS, device: torch.device, model_axis: int = 1):
    """The mesh of the group the caller joined (a data x ``model_axis``
    grid when ``model_axis`` > 1), checked against the flags."""
    mesh = make_mesh(device, MeshSpec(data=-1, model=model_axis))
    workers = ClusterSpec.from_flags(FLAGS).num_tasks("worker")
    if (mesh.rank, mesh.world_size) != (FLAGS.task_index, workers):
        raise ValueError(
            f"the process group has this process as rank {mesh.rank} of "
            f"{mesh.world_size}; the flags say --task_index="
            f"{FLAGS.task_index} of {workers} --worker_hosts")
    return mesh


class _Session:
    """What both training loops share: the supervisor (chief = task 0),
    the metrics logger, the meters, the periodic eval, and the stop
    signal (the coordinator's vote when more than one process runs)."""

    # the reference's display line from task 0 only (a grid's rows are
    # one model, whose display metrics every rank holds)
    chief_displays = False

    def __init__(self, FLAGS, model, ds, mesh):
        n_chips = mesh.world_size if mesh is not None else 1
        # a tensor-parallel model evaluates through every rank's shards
        self.collective = (isinstance(mesh, GridMesh)
                           and not FLAGS.seq_parallel)
        self.sv = Supervisor(is_chief=(FLAGS.task_index == 0),
                             logdir=FLAGS.logdir,
                             save_model_secs=FLAGS.save_model_secs,
                             max_to_keep=max_to_keep_from_flags(FLAGS),
                             background=background_save_from_flags(FLAGS),
                             sharded_spanning=bool(FLAGS.sharded_checkpoint))
        self.logger = MetricsLogger(FLAGS.logdir if self.sv.is_chief
                                    else None,
                                    job_name=FLAGS.job_name or "worker",
                                    task_index=FLAGS.task_index)
        self.meter = Throughput(FLAGS.batch_size, n_chips)
        self.stimer = StepTimer()
        self.periodic_eval = _periodic_test_eval(FLAGS, self.sv, model, ds,
                                                 self.logger,
                                                 collective=self.collective)
        self.mesh = mesh
        self.sync_every = (collective_sync_cadence(mesh.backend, n_chips)
                           if mesh is not None else 0)
        self.coord = (_HostCoordinator(self.sv, FLAGS.coord_steps, mesh)
                      if n_chips > 1 else None)
        self.should_stop = (self.coord.should_stop if self.coord is not None
                            else self.sv.should_stop)

    def start(self, box):
        """(state, step) to train from: the restored or fresh state, rank
        0's on every rank."""
        state, step = box.state, box.step
        if self.mesh is not None:
            state = replicate_state(self.mesh, state)
            step = int(state.step)
            box.update(state, step)
        _log_recovery(self.sv, self.logger, step)
        self.periodic_eval.prime(step)
        return state, step

    def publish(self, box, state, step: int) -> None:
        """Hand the supervisor the state to save on exit."""
        box.update(state, step)

    def after_step(self, state, step: int) -> None:
        self.periodic_eval(state, step)
        if self.coord is not None:
            self.coord.tick(step)
        self.sv.maybe_checkpoint(state, step)

    def finish(self, state, step: int):
        """The state the end-of-run evaluation reads."""
        return state

    def display(self, step: int, metrics: dict) -> dict:
        shown = {k: float(v) for k, v in metrics.items()}
        if self.chief_displays and not self.sv.is_chief:
            return shown
        self.logger.log_display(step, shown["loss"], shown["accuracy"])
        self.logger.scalars(step, {"images_per_sec": self.meter.images_per_sec,
                                   **self.stimer.scalars()})
        self.logger.flush()
        return shown

    def close(self, step: int, images_per_sec: float) -> None:
        # the run's steady state: the window after the warm-up
        self.logger.scalars(step, {"images_per_sec": images_per_sec,
                                   **self.stimer.scalars()})


class _TPSession(_Session):
    """The session of a ``--model_axis`` run. The restored or fresh full
    state is rank 0's on every rank, then cut to each rank's shards
    (``shard_state_tp``); from there no rank holds the state whole, so a
    checkpoint is a coordinated one, entered by every rank at a step the
    vote agreed on: the chief's cadence bit routes every rank into
    ``Supervisor.checkpoint_coordinated`` with the vote's attempt token.
    The periodic and final evaluations run on every rank (the forward's
    collectives), the chief alone prints and logs, and the reference's
    display line comes from task 0 only."""

    chief_displays = True

    def start(self, box):
        state, step = super().start(box)
        state = shard_state_tp(state, self.mesh)
        box.update(state, step)
        return state, step

    def after_step(self, state, step: int) -> None:
        self.periodic_eval(state, step)
        self.coord.tick(step)
        if self.coord.cadence_due():
            self.sv.checkpoint_coordinated(state, step,
                                           attempt=self.coord.token)


class _SPSession(_Session):
    """The session of a ``--seq_parallel`` run. The state is replicated,
    rank 0's on every rank, so the chief saves it in the one-process
    format and evaluates the splits alone on the dense twin (the
    blockwise one at long context); the display eval is the SP step's,
    on every rank, and its line comes from task 0 only."""

    chief_displays = True


class _ZeroSession(_Session):
    """The session of a ``--zero`` run. The live state is this rank's
    ``ZeroState``; the standard layout, which the supervisor saves, exists
    only as the host copy that ``fetch_state_zero`` makes, and that fetch
    is a collective. So it runs only at steps every rank agrees on: a
    display step, an ``--eval_step`` boundary crossed, the end, an agreed
    stop, and a ``--coord_steps`` vote that found the chief's checkpoint
    cadence due (one rank alone: its own cadence). Each fetch hands the
    copy to the supervisor, then the chief's periodic eval and cadenced
    save read it. A hard kill loses the steps since the last fetch."""

    def __init__(self, FLAGS, model, ds, mesh, level: int):
        super().__init__(FLAGS, model, ds, mesh)
        self.model, self.level = model, level
        self.display_step = FLAGS.display_step
        self.eval_every = max(0, FLAGS.eval_step)
        self.training_iter = FLAGS.training_iter
        self.box = None
        self.fetched_at = None
        self.prev = None

    def start(self, box):
        """Rank 0's restored or fresh standard state on every rank, cut
        into this rank's chunks."""
        state, step = super().start(box)
        self.box, self.prev = box, step
        state = shard_state_zero(state, self.mesh, self.level)
        self._fetch(state, step)  # the box holds a host copy from here
        return state, step

    def _fetch(self, state, step: int):
        host = fetch_state_zero(state, self.model, self.mesh, self.level)
        self.box.update(host, step)
        self.fetched_at = step
        return host

    def publish(self, box, state, step: int) -> None:
        """Nothing between agreed boundaries: ``after_step`` publishes."""

    def after_step(self, state, step: int) -> None:
        if self.coord is not None:
            self.coord.tick(step)
            due = self.coord.cadence_due()
        else:
            due = self.sv.checkpointer.cadence_due()
        prev, self.prev = self.prev, step
        crossed_eval = (self.eval_every
                        and prev // self.eval_every != step // self.eval_every)
        if (step % self.display_step == 0 or crossed_eval or due
                or step >= self.training_iter or self.should_stop()):
            host = self._fetch(state, step)
            self.periodic_eval(state, step)  # the module's params are current
            self.sv.maybe_checkpoint(host, step)

    def finish(self, state, step: int):
        if self.fetched_at != step:
            self._fetch(state, step)
        return state


def _zero_fns(FLAGS, model, opt, mesh, level: int, accum: int, augment):
    """--zero's clip, host-fed step and display eval over ``mesh``."""
    level = _check_level(level)
    if mesh.world_size == 1:
        print(f"--zero={level} on a 1-chip mesh: the data axis has nothing "
              f"to shard over — identical math to replicated DP, no memory "
              f"or comm saving (legal, but pointless)")
    clip = (zero_clip_transform(FLAGS.clip_norm, mesh)
            if FLAGS.clip_norm > 0 else None)
    step_fn = make_zero_train_step(
        model, opt, mesh, level, keep_prob=FLAGS.keep_prob,
        grad_transform=clip, accum_steps=accum, augment_fn=augment,
        overlap=FLAGS.zero_overlap, bucket_mb=FLAGS.zero_bucket_mb)
    zeval = make_zero_eval_step(model, mesh, level)
    return clip, step_fn, (lambda state, batch:
                           zeval(state.params, batch, state.model_state))


def _train_once(FLAGS, mode: str = "local") -> TrainResult:
    level = FLAGS.zero
    if level and mode != "sync":
        # a --mode=auto run of one worker lands here as "local"
        raise ValueError(
            f"--zero={level} requires sync mode (a torch.distributed group "
            f"to shard over); got mode={mode!r}. Use --mode=sync with "
            f"--worker_hosts (one worker makes a group of one)")
    model_axis = max(1, FLAGS.model_axis)
    if model_axis > 1 and mode != "sync":
        raise ValueError(
            f"--model_axis={model_axis} requires sync mode (a device mesh); "
            f"got mode={mode!r}. Use --mode=sync."
        )
    if model_axis > 1 and (level or FLAGS.device_data or FLAGS.moe_experts):
        raise ValueError(
            f"--model_axis={model_axis} does not compose with --zero, "
            f"--device_data or --moe_experts in this build (ROADMAP "
            f"queue 1)")
    device = _full_f32_on(FLAGS.device)
    mesh = (_sync_mesh(FLAGS, device, model_axis) if mode == "sync"
            else None)
    n_chips = mesh.world_size if mesh is not None else 1
    # every process draws its own minibatches (MNISTDist.py:167,178);
    # the ranks of one model group read the same ones
    data_seed = FLAGS.seed + (0 if mesh is None else
                              getattr(mesh, "data_index", mesh.rank))
    ds = read_data_sets(FLAGS.data_dir, one_hot=True, dataset=FLAGS.dataset,
                        seed=data_seed,
                        validation_size=FLAGS.validation_size,
                        seq_len=FLAGS.seq_len, vocab_size=FLAGS.vocab_size)
    model = build_model_for(FLAGS, ds.meta)
    opt = get_optimizer(FLAGS.optimizer, schedule_from_flags(FLAGS),
                        weight_decay=FLAGS.weight_decay)
    state = create_train_state(model, opt, seed=FLAGS.seed, device=device)
    clip = clip_by_global_norm(FLAGS.clip_norm) if FLAGS.clip_norm > 0 \
        else None
    augment = augment_for(FLAGS, ds.meta)
    accum = max(1, FLAGS.accum_steps)
    if FLAGS.seq_parallel:
        # the batch splits over the data ways; a row reads one slice
        feed_batch = FLAGS.batch_size // mesh.data
    elif model_axis > 1:
        feed_batch = FLAGS.batch_size // _check_tp(FLAGS, state, mesh, accum)
    elif mesh is not None:
        feed_batch = local_batch_size(FLAGS.batch_size, mesh)
    else:
        feed_batch = FLAGS.batch_size
    if FLAGS.seq_parallel:
        # sequence parallelism (+DP over the grid's columns):
        # parallel/sequence_parallel.py
        step_fn, eval_fn, model = _sp_fns(FLAGS, model, opt, mesh, clip,
                                          accum)
    elif model_axis > 1:
        # tensor parallelism (+DP over the grid's columns):
        # parallel/tensor_parallel.py
        clip = (tp_clip_transform(FLAGS.clip_norm, state.params, mesh)
                if FLAGS.clip_norm > 0 else None)
        step_fn = make_tp_train_step(model, opt, mesh,
                                     keep_prob=FLAGS.keep_prob,
                                     grad_transform=clip, accum_steps=accum,
                                     augment_fn=augment)
        tp_eval = make_tp_eval_step(model, mesh)
        eval_fn = lambda state, batch: tp_eval(  # noqa: E731
            batch, state.model_state)
    elif level:
        clip, step_fn, eval_fn = _zero_fns(FLAGS, model, opt, mesh, level,
                                           accum, augment)
    elif mesh is not None:
        step_fn = make_dp_train_step(model, opt, mesh,
                                     keep_prob=FLAGS.keep_prob,
                                     grad_transform=clip, accum_steps=accum,
                                     augment_fn=augment)
        dp_eval = make_dp_eval_step(model, mesh)
        eval_fn = lambda state, batch: dp_eval(  # noqa: E731
            batch, state.model_state)
    else:
        step_fn = make_train_step(model, opt, keep_prob=FLAGS.keep_prob,
                                  grad_transform=clip, accum_steps=accum,
                                  augment_fn=augment)
        local_eval = make_eval_step(model)
        eval_fn = lambda state, batch: local_eval(  # noqa: E731
            batch, state.model_state)
    if feed_batch % accum:
        raise ValueError(f"each process's batch of {feed_batch} (of "
                         f"--batch_size={FLAGS.batch_size}) must be "
                         f"divisible by --accum_steps={accum}")
    if level:
        run = _ZeroSession(FLAGS, model, ds, mesh, level)
    elif FLAGS.seq_parallel:
        run = _SPSession(FLAGS, model, ds, mesh)
    elif model_axis > 1:
        run = _TPSession(FLAGS, model, ds, mesh)
    else:
        run = _Session(FLAGS, model, ds, mesh)
    if FLAGS.device_data:
        if accum > 1:
            raise ValueError("--accum_steps splits host-fed batches; a "
                             "--device_data step draws one batch")
        kwargs = dict(keep_prob=FLAGS.keep_prob, grad_transform=clip,
                      augment_fn=augment)
        if level:
            make_step = lambda data: ZeroDeviceTrainStep(  # noqa: E731
                model, opt, mesh, level, data, feed_batch,
                overlap=FLAGS.zero_overlap, bucket_mb=FLAGS.zero_bucket_mb,
                **kwargs)
        else:
            make_step = lambda data: DeviceTrainStep(  # noqa: E731
                model, opt, data, feed_batch, mesh=mesh, **kwargs)
        return _train_device_resident(FLAGS, device, ds, model, state, run,
                                      eval_fn, feed_batch, make_step)
    with run.sv.managed(state) as box:
        state, step = run.start(box)
        batches = prefetch_to_device(
            batch_iterator(ds.train, feed_batch, raw=FLAGS.raw_input),
            size=2, device=device)

        def iterate(state, step: int):
            """One step on the next prefetched batch, which the display
            eval also reads (MNISTDist.py:178-182)."""
            t0 = time.perf_counter()
            batch = next(batches)
            run.stimer.add("host_wait", time.perf_counter() - t0)
            shown = None
            if step % FLAGS.display_step == 0:
                # the float() readback is where this waits for the card
                shown = run.display(step, eval_fn(state, batch))
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            run.stimer.add("dispatch", time.perf_counter() - t0)
            return state, 1, shown

        try:
            out = _loop(FLAGS, run, device, box, state, step, iterate,
                        window=FLAGS.profile_steps)
        finally:
            batches.close()
    return _finish(FLAGS, run, model, ds, *out)


def _sp_fns(FLAGS, model, opt, mesh, clip, accum: int):
    """--seq_parallel's host-fed step and display eval over ``mesh``, and
    the model the chief evaluates the splits with. The step runs the
    model's SP twin (``seq_axis``, ring attention), on the same parameter
    tensors. The splits' evaluation runs the dense model, which at 1024
    tokens or more is rebuilt with flash attention so that no rank forms
    the (S, S) scores. Each function cuts this rank's tile from the
    batch its row read."""
    from distributed_tensorflow_tpu_torch.models import TransformerLM

    is_lm = isinstance(model, TransformerLM)
    sp_model = model.twin(seq_axis=MODEL_AXIS)
    if is_lm and model.seq_len >= 1024:
        block = next((b for b in (512, 256, 128, 64)
                      if model.seq_len % b == 0), None)
        if block is not None:
            model = model.twin(attn_block=block)
    step = make_sp_train_step(sp_model, opt, mesh, keep_prob=FLAGS.keep_prob,
                              grad_transform=clip, accum_steps=accum)
    sp_eval = make_sp_eval_step(sp_model, mesh)

    def tile(batch):
        x, y = batch
        if not is_lm:
            x = reshape_for_sp(sp_model, x)
        return stage_batch_sp(mesh, (x, y), per_token_targets=is_lm)

    return ((lambda state, batch: step(state, tile(batch))),
            (lambda state, batch: sp_eval(tile(batch), state.model_state)),
            model)


def _check_tp(FLAGS, state, mesh, accum: int) -> int:
    """The model-axis run's checks, before any state is placed: the
    model has a split rule, the model axis divides its split dims, the
    global batch and its microbatches split over the data ways. Returns
    the data ways."""
    if not has_tp_specs(state.params):
        raise ValueError(
            f"--model_axis={mesh.model} but model {FLAGS.model!r} has no "
            f"tensor-parallel sharding rule — every parameter would "
            f"replicate and the extra devices would do redundant work. "
            f"Use --model_axis=1 (data parallelism) for this model."
        )
    _check_divisibility(state.params, tp_param_specs(state.params), mesh)
    data_ways = mesh.data
    if FLAGS.batch_size % data_ways:
        raise ValueError(
            f"--batch_size={FLAGS.batch_size} must be divisible by the "
            f"{data_ways}-way data axis"
        )
    if accum > 1 and (FLAGS.batch_size // accum) % data_ways:
        raise ValueError(
            f"each of the {accum} microbatches "
            f"({FLAGS.batch_size // accum} examples) must split over "
            f"the {data_ways}-way data axis"
        )
    return data_ways


def _train_device_resident(FLAGS, device, ds, model, state, run, eval_fn,
                           feed_batch: int, make_step) -> TrainResult:
    """--device_data training: the train split on the device, each step
    drawing its batch there, ``length`` steps per host iteration (one
    CUDA graph replay each on a card); ``make_step(data)`` builds the
    step (replicated, or ZeRO's under ``--zero``). Per training step no
    batch crosses from the host; per display step one host batch is
    staged for the reference's display eval (dropout off, before the
    update, ``MNISTDist.py:179-182``)."""
    data = put_device_data(ds.train, device)
    chunk = max(1, math.gcd(FLAGS.display_step, max(1, FLAGS.device_chunk)))
    if chunk != FLAGS.device_chunk:
        print(f"--device_chunk={FLAGS.device_chunk} clamped to {chunk} so "
              f"chunks land on --display_step={FLAGS.display_step} "
              f"boundaries")
    step_fn = make_step(data)

    def iterate(state, step: int):
        """The display eval on one host batch at a display step, then a
        chunk of device steps."""
        shown = None
        if step % FLAGS.display_step == 0:
            t0 = time.perf_counter()
            batch = tuple(torch.from_numpy(a).to(device)
                          for a in ds.train.next_batch(feed_batch))
            run.stimer.add("host_wait", time.perf_counter() - t0)
            shown = run.display(step, eval_fn(state, batch))
        # realign to display boundaries after a resume from an arbitrary
        # step, then cap at the remaining budget
        to_boundary = -step % FLAGS.display_step or chunk
        length = min(chunk, to_boundary, FLAGS.training_iter - step)
        t0 = time.perf_counter()
        state, _ = step_fn(state, step, length)
        run.stimer.add("dispatch", time.perf_counter() - t0)
        return state, length, shown

    with run.sv.managed(state) as box:
        state, step = run.start(box)
        # the learning-rate schedule reads the step inside the step
        state = state._replace(step=state.step.to(device))
        run.publish(box, state, step)
        out = _loop(FLAGS, run, device, box, state, step, iterate,
                    window=max(FLAGS.profile_steps, chunk))
    return _finish(FLAGS, run, model, ds, *out)


def _loop(FLAGS, run, device, box, state, step: int, iterate, window: int):
    """The loop both input paths share: ``iterate(state, step)`` runs one
    host iteration (the display eval at a display step, then its train
    steps) and returns (state, steps taken, display metrics or None).
    The first iteration carries one-time costs (cuDNN's algorithm search,
    module loads, a CUDA graph's warm-up and capture) and stays out of
    the throughput window and the breakdown; ``--profile_dir`` traces
    ``window`` steps after it. Returns (state, step, last display
    metrics, images/s, busy share)."""
    meter, stimer = run.meter, run.stimer
    last_display, busy, profiler = {}, None, None
    profile_done = not FLAGS.profile_dir
    warm = False
    try:
        meter.reset()
        while not run.should_stop() and step < FLAGS.training_iter:
            if warm and not profile_done and profiler is None:
                profiler = _start_profiler(device)
                profile_stop_at = step + window
            state, length, shown = iterate(state, step)
            step += length
            # the step changed the parameters in place: publish the new
            # state before anything else can raise, so the final save
            # never pairs step-N+1 params with a step-N optimizer
            run.publish(box, state, step)
            if shown is not None:
                last_display = shown
            meter.step(length * FLAGS.batch_size)
            stimer.steps(length)
            if run.sync_every:
                _sync(device)
            if not warm:
                _sync(device)
                meter.reset()
                stimer.reset()
                warm = True
            if profiler is not None and step >= profile_stop_at:
                busy = _stop_profiler(profiler, device, FLAGS.profile_dir)
                profiler, profile_done = None, True
            run.after_step(state, step)
        t0 = time.perf_counter()
        _sync(device)
        stimer.add("device", time.perf_counter() - t0)
        images_per_sec = meter.images_per_sec
        run.close(step, images_per_sec)
        state = run.finish(state, step)
    finally:
        if profiler is not None:
            profiler.stop()
    return state, step, last_display, images_per_sec, busy


def _finish(FLAGS, run, model, ds, state, step, last_display,
            images_per_sec, busy) -> TrainResult:
    test_metrics = _final_test_eval(FLAGS, run.sv, run.periodic_eval, model,
                                    state, ds, run.logger, step,
                                    run.meter.n_chips,
                                    collective=run.collective)
    print("Optimization Finished!")
    run.logger.close()
    return TrainResult(final_step=step, train_metrics=last_display,
                       test_metrics=test_metrics,
                       images_per_sec=images_per_sec,
                       device_busy_share=busy,
                       images_per_sec_per_chip=(images_per_sec
                                                / run.meter.n_chips),
                       n_chips=run.meter.n_chips)


class _HostCoordinator:
    """Cadenced agreement of the processes on a stop.

    A stop (SIGTERM on one process, say) must take effect at the same
    step on every process: one that left the loop alone would leave the
    rest waiting in the next collective. Every ``every`` steps (crossing
    semantics, ``step // every``, so a loop that advances by chunks still
    votes once per boundary) the processes ``all_gather`` their
    supervisors' stop flags and checkpoint-cadence bits (only the chief's
    can be set); any stop stops everyone, and the chief's final save
    lands at the agreed step. Between boundaries ``should_stop`` reads
    the cached result; ``cadence_due`` is the vote's cadence bit on the
    step of a vote and False between votes, so a ``--zero`` run enters
    its collective fetch, and a ``--model_axis`` run its coordinated
    save, for the chief's cadence on every rank at once. ``token`` is
    the vote's third column, rank 0's random draw as 8 hex digits: the
    sharded checkpoint's per-attempt nonce, agreed here so the save
    itself stays collective-free. The JAX package's vote also carries
    elastic-membership and straggler columns; their modules are not
    ported."""

    def __init__(self, sv, every: int, mesh):
        self._sv = sv
        self._every = max(1, every)
        self._mesh = mesh
        # NCCL moves device tensors, gloo host ones
        self._device = mesh.device if mesh.backend == "nccl" else "cpu"
        self._stop = False
        self._cadence = False
        self._boundary = None
        self.token = None

    def should_stop(self) -> bool:
        return self._stop

    def cadence_due(self) -> bool:
        return self._cadence

    def tick(self, step: int) -> None:
        """Call once per loop iteration, after ``step`` advanced; every
        process must call it with the same step sequence."""
        boundary = step // self._every
        self._cadence = False
        if boundary == self._boundary:
            return
        self._boundary = boundary
        mine = torch.tensor([int(self._sv.should_stop()),
                             int(self._sv.checkpointer.cadence_due()),
                             secrets.randbits(31)],
                            dtype=torch.int32, device=self._device)
        votes = [torch.empty_like(mine) for _ in range(self._mesh.world_size)]
        dist.all_gather(votes, mine, group=self._mesh.group)
        votes = torch.stack(votes).cpu()
        self._stop = bool(votes[:, 0].max())
        self._cadence = bool(votes[:, 1].max())
        self.token = format(int(votes[0, 2]), "08x")


# Idle host time at each end of a profiled window on a card. The tracer
# keeps only the device records whose timestamps, moved onto the host's
# clock, fall inside the window, and on an H100 that move can be
# milliseconds off: the first kernels of a window went missing
# (profile_window_probe.py). The work between the margins is one host
# event, PROFILED_STEPS, and the busy share is taken over it.
_PROFILE_MARGIN_S = 0.1
PROFILED_STEPS = "profiled steps"


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=activities)
    prof.start()
    if device.type == "cuda":
        time.sleep(_PROFILE_MARGIN_S)
    prof.profiled_steps = record_function(PROFILED_STEPS)
    prof.profiled_steps.__enter__()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str):
    """End the window with the device drained, write the Chrome trace
    into ``profile_dir`` and return the device's busy share over the
    profiled steps."""
    import os

    _sync(device)
    prof.profiled_steps.__exit__(None, None, None)
    if device.type == "cuda":
        time.sleep(_PROFILE_MARGIN_S)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    events = prof.events()
    share = busy_share(events, window=PROFILED_STEPS)
    print(f"profile: {len(events)} events in "
          f"{profile_dir}/trace.json; device busy share "
          f"{'not measured' if share is None else f'{share:.4f}'}")
    table = prof.key_averages()
    print(table.table(sort_by="self_cpu_time_total", row_limit=12))
    if device.type == "cuda":
        print(table.table(sort_by="self_device_time_total", row_limit=8))
    return share


def evaluate_only(FLAGS) -> dict[str, float]:
    """--eval_only: restore the latest checkpoint's params from
    ``--logdir`` and evaluate the full test split, no training. Only
    what evaluation needs is read: the params, and for a stateful model
    (the ResNet) its ``model_state``, the batch-norm running stats; any
    optimizer layout restores. A stateful model's checkpoint without
    stored stats is refused rather than evaluated with untrained ones."""
    _configure_faults(FLAGS)
    device = _full_f32_on(FLAGS.device)
    found = latest_checkpoint(FLAGS.logdir)
    if found is None:
        raise FileNotFoundError(
            f"--eval_only: no checkpoint found in --logdir={FLAGS.logdir!r}")
    ds = read_data_sets(FLAGS.data_dir, one_hot=True, dataset=FLAGS.dataset,
                        seed=FLAGS.seed, seq_len=FLAGS.seq_len,
                        vocab_size=FLAGS.vocab_size)
    model = build_model_for(FLAGS, ds.meta).to(device)
    template = {"params": params_of(model), "step": 0}
    model_state = state_of(model)
    if model_state != ():
        if not any(k.removeprefix(_BF16_TAG).startswith("model_state/")
                   for k in checkpoint_keys(found[0])):
            raise ValueError(
                f"--eval_only: checkpoint {found[0]} has no model_state "
                f"but model {FLAGS.model!r} is stateful (batch-norm) — "
                f"evaluating with untrained statistics would be silently "
                f"wrong")
        template["model_state"] = model_state
    blob, step, _ = restore_with_fallback(FLAGS.logdir, template)
    _adopt(template, blob)
    m = evaluate(model, ds.test, batch_size=_eval_batch_for(model, ds.meta),
                 model_state=model_state)
    print(f"step: {step} test accuracy: {m['accuracy']} "
          f"test loss: {m['loss']}")
    print(json.dumps({"step": step, "test_accuracy": m["accuracy"],
                      "test_loss": m["loss"], "dataset": FLAGS.dataset,
                      "data_source": ds.source}))
    return m


def _eval_batch_for(model, meta: dict) -> int:
    """Full-split evaluation batch size: 1000 examples for images; for
    token sequences as many as keep a batch near 2**18 tokens (1000
    sequences of 4k tokens would be gigabytes of activations and
    logits)."""
    if meta.get("kind") == "lm":
        return max(1, (1 << 18) // int(model.seq_len))
    return 1000


def _periodic_test_eval(FLAGS, sv, model, ds, logger,
                        collective: bool = False):
    """(state, step) -> None: full held-out evaluation every
    ``--eval_step`` steps (once per boundary crossed), on the chief only
    (``collective``: on every rank, whose forward passes are collectives,
    the chief alone printing and logging). With ``--validation_size`` it
    runs on the validation split, and the test split is left to the
    final eval."""
    every = FLAGS.eval_step
    if every <= 0:
        noop = lambda state, step: None  # noqa: E731
        noop.prime = lambda step: None
        noop.last_result = lambda: None
        return noop
    val = ds.validation
    use_validation = val is not None and val.num_examples > 0
    split, name = (val, "validation") if use_validation else (ds.test, "test")
    box = {"done": 0, "last": None}

    def maybe_eval(state, step: int):
        if step // every <= box["done"]:
            return
        box["done"] = step // every
        if not (sv.is_chief or collective):
            return
        m = evaluate(model, split,
                     model_state=state.model_state,
                     batch_size=_eval_batch_for(model, ds.meta))
        if not use_validation:
            # the end-of-run eval may reuse a result on the test split
            box["last"] = (step, m)
        if not sv.is_chief:
            return
        print(f"step: {step} {name} accuracy: {m['accuracy']} "
              f"{name} loss: {m['loss']}")
        logger.scalars(step, {f"{name}_accuracy": m["accuracy"],
                              f"{name}_loss": m["loss"]})

    def prime(step: int):
        # a resumed run counts boundaries from the restored step
        box["done"] = step // every

    maybe_eval.prime = prime
    maybe_eval.last_result = lambda: box["last"]
    return maybe_eval


def _final_test_eval(FLAGS, sv, periodic_eval, model, state, ds, logger,
                     step, n_chips: int = 1, collective: bool = False):
    """End-of-run test evaluation on the chief; reuses the periodic eval's
    result when it already covered the final step. In a run of more than
    one process the others return None: they evaluate (only when
    ``collective``: a tensor-parallel forward needs every rank), print
    and log nothing."""
    others = n_chips > 1 and not sv.is_chief
    if not FLAGS.test_eval or (others and not collective):
        return None
    last = periodic_eval.last_result()
    if last is not None and last[0] == step:
        test_metrics = last[1]  # scalars already logged at this step
    else:
        test_metrics = evaluate(model, ds.test,
                                model_state=state.model_state,
                                batch_size=_eval_batch_for(model, ds.meta))
        if not others:
            logger.scalars(step, {"test_accuracy": test_metrics["accuracy"],
                                  "test_loss": test_metrics["loss"]})
    if others:
        return None
    print("test accuracy: ", test_metrics["accuracy"],
          "test loss: ", test_metrics["loss"])
    return test_metrics
