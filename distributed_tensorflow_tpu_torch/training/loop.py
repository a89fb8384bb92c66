"""The training loop: the reference's hot-loop semantics on the card.

The counterpart of ``distributed_tensorflow_tpu/training/loop.py``'s
``train``, the local branch of ``_train_once``, ``evaluate_only`` and
``build_model_for``. Reference loop (``MNISTDist.py:172-188``): while not
stopped and ``step < training_iter``, draw a minibatch; every
``display_step`` print job/task, step and the minibatch loss and accuracy,
evaluated *before* the update with dropout off (``:179-182``); then run one
optimizer step. Termination is on the shared global step. On exit:
``sv.stop()`` and "Optimization Finished!" (``:192-193``).

Batches are assembled on a host thread into pinned memory and copied to
the card asynchronously (``data/pipeline.py``). Only the local mode is
ported: one process, one device.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

import torch

from distributed_tensorflow_tpu_torch.checkpoint import (
    latest_checkpoint,
    max_to_keep_from_flags,
    restore_with_fallback,
)
from distributed_tensorflow_tpu_torch.data import (
    batch_iterator,
    prefetch_to_device,
    read_data_sets,
)
from distributed_tensorflow_tpu_torch.models import get_model
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
)
from distributed_tensorflow_tpu_torch.utils.metrics import MetricsLogger
from distributed_tensorflow_tpu_torch.utils.profiling import (
    Throughput,
    busy_share,
)
from distributed_tensorflow_tpu_torch.utils.telemetry import StepTimer


@dataclass
class TrainResult:
    """What a run ends with. ``images_per_sec`` covers the steps after the
    first (warm-up) step up to the end of the loop, the device drained;
    ``device_busy_share`` is the profiled window's (``--profile_dir``),
    None without one or when the trace holds no device time."""

    final_step: int
    train_metrics: dict[str, float]
    test_metrics: dict[str, float] | None
    images_per_sec: float
    device_busy_share: float | None = None


def build_model_for(FLAGS, meta: dict):
    """The model the flags describe, for a dataset with ``meta``'s image
    size, channels and classes. Only ``deep_cnn`` is ported."""
    if meta.get("kind") == "lm" or FLAGS.model != "deep_cnn":
        raise NotImplementedError(
            f"--model {FLAGS.model} (dataset kind {meta.get('kind', 'image')})"
            f" is not yet ported to distributed_tensorflow_tpu_torch; only "
            f"deep_cnn is")
    return get_model(
        "deep_cnn",
        image_size=meta["image_size"],
        channels=meta["channels"],
        num_classes=meta["num_classes"],
        compute_dtype=torch.bfloat16 if FLAGS.bf16 else None,
        use_pallas=bool(FLAGS.pallas),
    )


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
    """Run a full training job. Only "local" (one process, one device:
    ``--device``, which is ``cuda`` unless the caller asks for the CPU) is
    ported; other modes raise."""
    if mode != "local":
        raise NotImplementedError(
            f"mode {mode!r} is not yet ported to "
            f"distributed_tensorflow_tpu_torch; only local is")
    return _train_once(FLAGS, mode)


def _train_once(FLAGS, mode: str = "local") -> TrainResult:
    device = _full_f32_on(FLAGS.device)
    ds = read_data_sets(FLAGS.data_dir, one_hot=True, dataset=FLAGS.dataset,
                        seed=FLAGS.seed,
                        validation_size=FLAGS.validation_size)
    model = build_model_for(FLAGS, ds.meta)
    opt = get_optimizer(FLAGS.optimizer, schedule_from_flags(FLAGS),
                        weight_decay=FLAGS.weight_decay)
    state = create_train_state(model, opt, seed=FLAGS.seed, device=device)
    clip = clip_by_global_norm(FLAGS.clip_norm) if FLAGS.clip_norm > 0 \
        else None
    accum = max(1, FLAGS.accum_steps)
    if FLAGS.batch_size % accum:
        raise ValueError(f"--batch_size={FLAGS.batch_size} must be "
                         f"divisible by --accum_steps={accum}")
    step_fn = make_train_step(model, opt, keep_prob=FLAGS.keep_prob,
                              grad_transform=clip, accum_steps=accum)
    eval_fn = make_eval_step(model)

    sv = Supervisor(is_chief=(FLAGS.task_index == 0), logdir=FLAGS.logdir,
                    save_model_secs=FLAGS.save_model_secs,
                    max_to_keep=max_to_keep_from_flags(FLAGS))
    logger = MetricsLogger(FLAGS.logdir if sv.is_chief else None,
                           job_name=FLAGS.job_name or "worker",
                           task_index=FLAGS.task_index)
    meter = Throughput(FLAGS.batch_size)
    stimer = StepTimer()
    last_display = {}
    periodic_eval = _periodic_test_eval(FLAGS, sv, model, ds, logger)
    images_per_sec = 0.0
    busy = None

    with sv.managed(state) as box:
        state, step = box.state, box.step
        _log_recovery(sv, logger, step)
        periodic_eval.prime(step)
        batches = prefetch_to_device(
            batch_iterator(ds.train, FLAGS.batch_size, raw=FLAGS.raw_input),
            size=2, device=device)
        profiler = None
        profile_done = not FLAGS.profile_dir
        warm = False
        try:
            meter.reset()
            while not sv.should_stop() and step < FLAGS.training_iter:
                t0 = time.perf_counter()
                batch = next(batches)
                stimer.add("host_wait", time.perf_counter() - t0)
                if step % FLAGS.display_step == 0:
                    m = eval_fn(batch, state.model_state)
                    # the float() readback is where this waits for the card
                    last_display = {k: float(v) for k, v in m.items()}
                    logger.log_display(step, last_display["loss"],
                                       last_display["accuracy"])
                    logger.scalars(step, {
                        "images_per_sec": meter.images_per_sec,
                        **stimer.scalars()})
                    logger.flush()
                if warm and not profile_done and profiler is None:
                    profiler = _start_profiler(device)
                    profile_stop_at = step + FLAGS.profile_steps
                t0 = time.perf_counter()
                state, _ = step_fn(state, batch)
                stimer.add("dispatch", time.perf_counter() - t0)
                step += 1
                # the step changed the parameters in place: publish the
                # new state before anything else can raise, so the final
                # save never pairs step-N+1 params with a step-N optimizer
                box.update(state, step)
                meter.step()
                stimer.steps()
                if not warm:
                    # the first step carries one-time costs (cuDNN's
                    # algorithm search, module loads): keep it out of the
                    # throughput window and the breakdown
                    _sync(device)
                    meter.reset()
                    stimer.reset()
                    warm = True
                if profiler is not None and step >= profile_stop_at:
                    busy = _stop_profiler(profiler, device, FLAGS.profile_dir)
                    profiler, profile_done = None, True
                periodic_eval(state, step)
                sv.maybe_checkpoint(state, step)
            t0 = time.perf_counter()
            _sync(device)
            stimer.add("device", time.perf_counter() - t0)
            images_per_sec = meter.images_per_sec
            # the run's steady state: the window after the warm-up step
            logger.scalars(step, {"images_per_sec": images_per_sec,
                                  **stimer.scalars()})
        finally:
            if profiler is not None:
                profiler.stop()
            batches.close()

    test_metrics = _final_test_eval(FLAGS, sv, periodic_eval, model, state,
                                    ds, logger, step)
    print("Optimization Finished!")
    logger.close()
    return TrainResult(final_step=step, train_metrics=last_display,
                       test_metrics=test_metrics,
                       images_per_sec=images_per_sec,
                       device_busy_share=busy)


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, profile_dir: str):
    """End the window with the device drained, write the Chrome trace
    into ``profile_dir`` and return the device's busy share over it."""
    import os

    _sync(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    events = prof.events()
    share = busy_share(events)
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
    ``--logdir`` and evaluate the full test split, no training. Any
    optimizer layout restores, since only the params are read."""
    device = _full_f32_on(FLAGS.device)
    found = latest_checkpoint(FLAGS.logdir)
    if found is None:
        raise FileNotFoundError(
            f"--eval_only: no checkpoint found in --logdir={FLAGS.logdir!r}")
    ds = read_data_sets(FLAGS.data_dir, one_hot=True, dataset=FLAGS.dataset,
                        seed=FLAGS.seed)
    model = build_model_for(FLAGS, ds.meta).to(device)
    params = params_of(model)
    blob, step, _ = restore_with_fallback(FLAGS.logdir, {"params": params,
                                                         "step": 0})
    _adopt(params, blob["params"])
    m = evaluate(model, ds.test, batch_size=_eval_batch_for(ds.meta))
    print(f"step: {step} test accuracy: {m['accuracy']} "
          f"test loss: {m['loss']}")
    print(json.dumps({"step": step, "test_accuracy": m["accuracy"],
                      "test_loss": m["loss"], "dataset": FLAGS.dataset,
                      "data_source": ds.source}))
    return m


def _eval_batch_for(meta: dict) -> int:
    """Full-split evaluation batch size: 1000 examples for images."""
    return 1000


def _periodic_test_eval(FLAGS, sv, model, ds, logger):
    """(state, step) -> None: full held-out evaluation every
    ``--eval_step`` steps (once per boundary crossed), on the chief only.
    With ``--validation_size`` it runs on the validation split, and the
    test split is left to the final eval."""
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
        if not sv.is_chief:
            return
        m = evaluate(model, split,
                     model_state=state.model_state,
                     batch_size=_eval_batch_for(ds.meta))
        if not use_validation:
            # the end-of-run eval may reuse a result on the test split
            box["last"] = (step, m)
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
                     step):
    """End-of-run test evaluation; reuses the periodic eval's result when
    it already covered the final step."""
    if not FLAGS.test_eval:
        return None
    last = periodic_eval.last_result()
    if last is not None and last[0] == step:
        test_metrics = last[1]  # scalars already logged at this step
    else:
        test_metrics = evaluate(model, ds.test,
                                model_state=state.model_state,
                                batch_size=_eval_batch_for(ds.meta))
        logger.scalars(step, {"test_accuracy": test_metrics["accuracy"],
                              "test_loss": test_metrics["loss"]})
    print("test accuracy: ", test_metrics["accuracy"],
          "test loss: ", test_metrics["loss"])
    return test_metrics
