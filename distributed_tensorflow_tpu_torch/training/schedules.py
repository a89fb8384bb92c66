"""Learning-rate schedules for the train step.

The counterpart of ``distributed_tensorflow_tpu/training/schedules.py``.
The reference trains at one fixed rate (``MNISTDist.py:30,149``);
``--lr_schedule`` selects a schedule. A schedule is a callable ``step ->
learning_rate`` that the optimizer evaluates on its global step, an int32
tensor, in float32 as the JAX package does. Every schedule is defined for
any step >= 0 and holds its floor past its decay horizon.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _frac(step: torch.Tensor, decay_steps: int) -> torch.Tensor:
    return torch.clamp(step.float() / decay_steps, 0.0, 1.0)


def constant(learning_rate: float) -> Schedule:
    """The reference's behavior: one fixed rate (MNISTDist.py:30). The
    rate is filled in on ``step``'s device, with no copy from the host,
    so a CUDA graph can capture it."""
    lr = float(learning_rate)

    def schedule(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return schedule


def cosine_decay(learning_rate: float, decay_steps: int,
                 alpha: float = 0.0) -> Schedule:
    """Cosine annealing from ``learning_rate`` to ``alpha*learning_rate``
    over ``decay_steps``, then held at the floor."""
    lr = float(learning_rate)
    decay_steps = max(1, int(decay_steps))
    alpha = float(alpha)

    def schedule(step):
        cos = 0.5 * (1.0 + torch.cos(math.pi * _frac(step, decay_steps)))
        return lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def linear_decay(learning_rate: float, decay_steps: int,
                 end_factor: float = 0.0) -> Schedule:
    """Linear ramp from ``learning_rate`` to ``end_factor*learning_rate``
    over ``decay_steps``, then held."""
    lr = float(learning_rate)
    decay_steps = max(1, int(decay_steps))
    end_factor = float(end_factor)

    def schedule(step):
        return lr * (1.0 + (end_factor - 1.0) * _frac(step, decay_steps))

    return schedule


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False) -> Schedule:
    """``lr * decay_rate ** (step / decay_steps)`` — TF's classic
    ``tf.train.exponential_decay``, including the ``staircase`` variant."""
    lr = float(learning_rate)
    decay_steps = max(1, int(decay_steps))
    decay_rate = float(decay_rate)

    def schedule(step):
        exp = step.float() / decay_steps
        if staircase:
            exp = torch.floor(exp)
        return lr * decay_rate ** exp

    return schedule


def with_warmup(schedule: Schedule, warmup_steps: int) -> Schedule:
    """Linear warmup from 0 to the base schedule over ``warmup_steps``; the
    wrapped schedule then continues on the post-warmup step, so its decay
    horizon starts where the ramp ends."""
    warmup_steps = int(warmup_steps)
    if warmup_steps <= 0:
        return schedule

    def warmed(step):
        ramp = (step.float() + 1.0) / warmup_steps
        after = schedule(torch.clamp(step - warmup_steps, min=0))
        return torch.where(step < warmup_steps,
                           ramp * schedule(torch.zeros_like(step)), after)

    return warmed


_SCHEDULES = ("constant", "cosine", "linear", "exponential")


def get_schedule(name: str, learning_rate: float, decay_steps: int, *,
                 warmup_steps: int = 0, decay_rate: float = 0.96,
                 alpha: float = 0.0):
    """Build a schedule by name. The no-schedule case (``constant`` with
    no warmup) returns the plain float, as in the JAX package."""
    if name not in _SCHEDULES:
        raise ValueError(
            f"unknown lr_schedule {name!r}; available: {list(_SCHEDULES)}")
    if name == "constant" and warmup_steps <= 0:
        return float(learning_rate)
    if name == "constant":
        base = constant(learning_rate)
    elif name == "cosine":
        base = cosine_decay(learning_rate, decay_steps, alpha=alpha)
    elif name == "linear":
        base = linear_decay(learning_rate, decay_steps)
    else:
        base = exponential_decay(learning_rate, decay_steps, decay_rate)
    return with_warmup(base, warmup_steps)


def schedule_from_flags(FLAGS):
    """FLAGS -> float | Schedule for ``get_optimizer``. ``--decay_steps=0``
    decays over the full ``--training_iter`` budget less the warmup, so
    the schedule reaches its floor exactly at the end of the run."""
    name = FLAGS.lr_schedule
    warmup = FLAGS.warmup_steps
    if name == "constant" and warmup <= 0:
        return float(FLAGS.learning_rate)
    decay_steps = FLAGS.decay_steps or max(1, FLAGS.training_iter - warmup)
    return get_schedule(name, FLAGS.learning_rate, decay_steps,
                        warmup_steps=warmup, decay_rate=FLAGS.decay_rate)
