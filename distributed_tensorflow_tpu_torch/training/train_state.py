"""Train state and the train step, as plain functions over a module's
parameters.

The counterpart of ``distributed_tensorflow_tpu/training/train_state.py``.
The reference's step (``MNISTDist.py:148-149,188``) is forward, backward
and an optimizer update with a shared ``global_step``; here it is one
Python function over a ``TrainState`` whose ``params`` are the model's own
``nn.Parameter`` tensors, nested as the JAX parameter tree
(``{"weights": {...}, "biases": {...}}``). The forward is the module's own,
gradients come from ``torch.autograd.grad`` over those tensors, and
``apply_updates`` adds the updates to the parameters in place, so the
module always holds the current parameters. The optimizers update their
slots in place too, so one step can be captured in a CUDA graph and
replayed (``training/device_step.py``): a replay reads and writes the
same tensors.

A stateful model (the ResNet) keeps its batch-norm running stats in
buffers that a train-mode forward moves in place; ``model_state`` is the
tree of those same tensors (``state_of``), as ``params`` is the tree of
the parameters.

``TrainState`` flattens to the JAX package's checkpoint keys
(``params/...``, ``opt_state/...``, ``step``, ``rng``,
``model_state/...``), so a checkpoint of either package restores in the
other.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.ops import nn
from distributed_tensorflow_tpu_torch.utils.pytree import (
    tree_from_named,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_U64 = 0xFFFFFFFFFFFFFFFF


class TrainState(NamedTuple):
    """params + optimizer slots + shared global step + dropout key +
    non-gradient model state (``()`` for a stateless model)."""

    params: Any  # the model's nn.Parameters, nested as the JAX tree
    opt_state: Any
    step: torch.Tensor  # int32 scalar on the CPU: the reference's global_step
    rng: np.ndarray  # uint32[2], the JAX package's raw PRNG key layout
    model_state: Any = ()  # the model's buffers, nested as the JAX tree


class Optimizer(NamedTuple):
    # update: (grads, opt_state, params, step=None) -> (updates, opt_state).
    # ``step`` is the global step before this update; a scheduled rate is
    # evaluated on it, so the opt_state layout never depends on the
    # schedule.
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def params_of(model: torch.nn.Module) -> dict:
    """The module's parameters as the JAX parameter tree: ``weights.wd1``
    becomes ``{"weights": {"wd1": ...}}``. The leaves are the module's own
    tensors."""
    return tree_from_named(model.named_parameters())


def state_of(model: torch.nn.Module):
    """A stateful module's buffers as the JAX ``state`` tree
    (``stem.bn.mean`` becomes ``{"stem": {"bn": {"mean": ...}}}``), the
    leaves the module's own tensors; ``()`` for a stateless model."""
    if not getattr(model, "stateful", False):
        return ()
    return tree_from_named(model.named_buffers())


def _lr_at(learning_rate, step):
    """A float rate, or a schedule evaluated on ``step`` (the global step
    before the update). A schedule without a step is a caller bug."""
    if not callable(learning_rate):
        return learning_rate
    if step is None:
        raise ValueError(
            "scheduled learning rate needs the global step: call "
            "optimizer.update(grads, opt_state, params, step)")
    return learning_rate(step)


def _check_wd(weight_decay) -> float:
    """Weight decay must be non-negative. The zero path keeps the plain
    update, since ``0.0 * p`` is not free and turns an inf leaf into NaN."""
    wd = float(weight_decay)
    if wd < 0:
        raise ValueError(f"weight_decay must be >= 0, got {wd}")
    return wd


def sgd(learning_rate, weight_decay: float = 0.0) -> Optimizer:
    """Vanilla SGD, parity with ``GradientDescentOptimizer``
    (MNISTDist.py:149). The opt_state is ``()``; ``weight_decay`` adds
    ``-lr*wd*param`` to the update."""
    wd = _check_wd(weight_decay)

    def init(params):
        return ()

    def update(grads, opt_state, params, step=None):
        lr = _lr_at(learning_rate, step)
        if wd:
            updates = tree_map(lambda g, p: -lr * (g + wd * p), grads, params)
        else:
            updates = tree_map(lambda g: -lr * g, grads)
        return updates, opt_state

    return Optimizer(init, update)


def _assign(slots, values):
    """Write each new value into its slot tensor, in place."""
    return tree_map(lambda s, v: s.copy_(v), slots, values)


def momentum(learning_rate, beta: float = 0.9,
             weight_decay: float = 0.0) -> Optimizer:
    """SGD with momentum; the opt_state is the bare velocity tree, updated
    in place. Weight decay is decoupled: applied to the update, not fed
    through the velocity."""
    wd = _check_wd(weight_decay)

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, vel, params, step=None):
        lr = _lr_at(learning_rate, step)
        vel = _assign(vel, tree_map(lambda v, g: beta * v + g, vel, grads))
        if wd:
            updates = tree_map(lambda v, p: -lr * (v + wd * p), vel, params)
        else:
            updates = tree_map(lambda v: -lr * v, vel)
        return updates, vel

    return Optimizer(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam in the JAX package's form: an int32 step count ``t`` and
    ``scale = lr * sqrt(1 - b2**t) / (1 - b1**t)`` taken in float32 on
    the device. The slots ``m``, ``v`` and ``t`` are updated in place.
    Nonzero ``weight_decay`` makes it AdamW."""
    wd = _check_wd(weight_decay)

    def init(params):
        device = tree_leaves(params)[0].device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, st, params, step=None):
        lr = _lr_at(learning_rate, step)
        t = st["t"].add_(1)
        m = _assign(st["m"], tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g,
                                      st["m"], grads))
        v = _assign(st["v"], tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * g * g, st["v"], grads))
        tf_ = t.float()
        scale = lr * torch.sqrt(1 - b2 ** tf_) / (1 - b1 ** tf_)
        if wd:
            updates = tree_map(
                lambda m_, v_, p: -(scale * m_ / (torch.sqrt(v_) + eps)
                                    + lr * wd * p), m, v, params)
        else:
            updates = tree_map(
                lambda m_, v_: -scale * m_ / (torch.sqrt(v_) + eps), m, v)
        return updates, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


_OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam}


def get_optimizer(name: str, learning_rate,
                  weight_decay: float = 0.0) -> Optimizer:
    try:
        factory = _OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; available: "
                         f"{sorted(_OPTIMIZERS)}") from None
    return factory(learning_rate, weight_decay=weight_decay)


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates``, added in place (the leaves are the module's
    parameters); returns ``params``."""
    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)


def apply_gradients(optimizer: Optimizer, state, grads,
                    grad_transform: Callable[[Any], Any] | None = None):
    """``grad_transform`` (e.g. the clip), then one optimizer update
    evaluated at ``state.step``, added to the parameters in place.
    Returns the new opt_state; the caller advances the step."""
    if grad_transform is not None:
        grads = grad_transform(grads)
    updates, opt_state = optimizer.update(grads, state.opt_state,
                                          state.params, state.step)
    apply_updates(state.params, updates)
    return opt_state


def clip_by_global_norm(max_norm: float, split=None, group=None):
    """Gradient transform: scale the whole gradient tree so its global L2
    norm is at most ``max_norm`` (``tf.clip_by_global_norm``).

    Under a model axis (``split``: one bool per leaf, True for a
    tensor-parallel shard; ``group``: the model group) the norm is the
    full model's: the shards' square-sums ``all_reduce`` over the group
    and each replicated leaf adds once. Summing only the local leaves
    would clip each rank's shards by its own norm."""
    max_norm = float(max_norm)

    def square_sum(gs):
        return sum(torch.sum(torch.square(g.float())) for g in gs)

    def transform(grads):
        leaves = tree_leaves(grads)
        if split is None:
            sq = square_sum(leaves)
        else:
            import torch.distributed as dist

            local = square_sum(g for g, s in zip(leaves, split) if s)
            local = torch.as_tensor(local, dtype=torch.float32,
                                    device=leaves[0].device).clone()
            dist.all_reduce(local, group=group)
            sq = local + square_sum(g for g, s in zip(leaves, split)
                                    if not s)
        norm = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: (g * scale).to(g.dtype), grads)

    return transform


def _mix(*words: int) -> int:
    """A 64-bit seed from integers: each folded in through splitmix64."""
    z = 0
    for w in words:
        z = (z ^ (w & _U64)) + 0x9E3779B97F4A7C15 & _U64
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _U64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _U64
        z ^= z >> 31
    return z


def dropout_seed(rng: np.ndarray, step, rank: int = 0) -> int:
    """The dropout seed of one train step: the state's uint32[2] key
    mixed with the global step and, past rank 0, the data-parallel rank.
    The masks are a function of (key, step, rank), so a resumed run draws
    what an uninterrupted one would, and rank 0 draws the single-process
    masks; they are not the JAX package's threefry masks."""
    seed = _mix(int(rng[0]), int(rng[1]), int(step))
    return _mix(seed, rank) if rank else seed


def create_train_state(model, optimizer: Optimizer, seed: int = 0,
                       device: torch.device | str = "cpu") -> TrainState:
    """Initialize ``model`` from ``seed`` (on the CPU generator), move it
    to ``device`` and build the state around its parameters. The key is
    the raw uint32[2] layout of ``jax.random.PRNGKey(seed)``."""
    model.init(torch.Generator().manual_seed(seed)).to(device)
    params = params_of(model)
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32),
        rng=np.array([seed >> 32 & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32),
        model_state=state_of(model),
    )


def _check_model_state(model, model_state) -> None:
    """A stateful module reads and moves its own buffers: a
    ``model_state`` made of other tensors would be ignored, so it is
    refused."""
    if not getattr(model, "stateful", False):
        return
    mine = tree_leaves(state_of(model))
    given = tree_leaves(model_state)
    if len(given) != len(mine) or any(a is not b
                                      for a, b in zip(given, mine)):
        raise ValueError("a stateful model's model_state must be its own "
                         "buffers (train_state.state_of(model))")


def loss_and_metrics(model, batch, *, keep_prob=1.0, rng=None,
                     train=False, model_state=()):
    """(loss, {"metrics": {"loss", "accuracy"}, "model_state": ...}) for
    one batch through ``model``'s current parameters; a model with
    ``wants_loss_hook`` computes both through its ``loss_with_metrics``
    (the LM with ``ce_block`` or ``moe_experts``; the MoE LM's metrics
    add ``moe_lb``). ``rng`` is a
    dropout seed (``dropout_seed``), a ``torch.Generator`` seeded with
    one, or None for no dropout. A stateful model normalizes by the batch
    in train mode, moving ``model_state`` (its buffers) in place, and by
    ``model_state`` in eval mode; the returned state is the same tree."""
    _check_model_state(model, model_state)
    x, y = batch
    generator = rng
    if rng is not None and not isinstance(rng, torch.Generator):
        generator = torch.Generator(device=x.device).manual_seed(rng)
    if getattr(model, "wants_loss_hook", False):
        # a model that owns its loss (the LM's streamed CE head, which
        # never builds the (B, S, V) logits; its MoE load-balance term):
        # one hook for train, eval and evaluate(), whose metrics are the
        # hook's ("loss" the cross-entropy, without the aux term)
        loss, metrics = model.loss_with_metrics(
            x, y, keep_prob=keep_prob, generator=generator, train=train)
        return loss, {"metrics": {k: v.detach() for k, v in metrics.items()},
                      "model_state": model_state}
    logits = model(x, keep_prob=keep_prob, generator=generator, train=train)
    loss = nn.softmax_cross_entropy(logits, y)
    acc = nn.accuracy(logits, y)
    return loss, {"metrics": {"loss": loss.detach(), "accuracy": acc},
                  "model_state": model_state}


def compute_grads(model, params, batch, *, keep_prob, rng, model_state,
                  accum_steps: int = 1):
    """(grads, metrics, new_model_state) for one optimizer update: the
    gradients with respect to ``params``, the module's own parameters.
    A stateful model's ``model_state`` moves in place and comes back.

    ``accum_steps > 1`` splits the batch into that many equal
    microbatches, one backward pass each, and averages gradients and
    metrics; each microbatch draws its own dropout seed, and the state
    threads through the microbatches in order."""
    leaves = tree_leaves(params)

    def one(b, seed):
        loss, aux = loss_and_metrics(model, b, keep_prob=keep_prob,
                                     rng=seed, train=True,
                                     model_state=model_state)
        grads = torch.autograd.grad(loss, leaves)
        return grads, aux["metrics"]

    if accum_steps <= 1:
        grads, metrics = one(batch, rng)
        return tree_unflatten(params, grads), metrics, model_state

    x, y = batch
    n = x.shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} examples does not split into "
                         f"{accum_steps} equal microbatches")
    g_sum, m_sum = None, None
    for i, (xb, yb) in enumerate(zip(x.chunk(accum_steps),
                                     y.chunk(accum_steps))):
        seed = None if rng is None else _mix(rng, i)
        g, m = one((xb, yb), seed)
        g_sum = g if g_sum is None else [a + b for a, b in zip(g_sum, g)]
        m_sum = m if m_sum is None else {k: m_sum[k] + m[k] for k in m}
    inv = 1.0 / accum_steps
    grads = [g * inv for g in g_sum]
    metrics = {k: v * inv for k, v in m_sum.items()}
    return tree_unflatten(params, grads), metrics, model_state


_AUG_SALT = 0xA06  # parts the augmentation stream from the others


def augment_seed(rng: np.ndarray, step, rank: int = 0) -> int:
    """The augmentation seed of one train step: the dropout seed of
    (key, step, rank) mixed with a salt, so ``--augment`` perturbs no
    other stream. A function of (key, step, rank) alone, so a resumed run
    augments as an uninterrupted one does."""
    return _mix(dropout_seed(rng, step, rank), _AUG_SALT)


def apply_augment(augment_fn, batch, seed: int):
    """``batch`` with its images through ``augment_fn(images,
    generator)``, the generator seeded with ``seed`` on the images'
    device."""
    x, y = batch
    generator = torch.Generator(device=x.device).manual_seed(seed)
    return augment_fn(x, generator), y


def make_train_step(model, optimizer: Optimizer, keep_prob: float = 1.0,
                    grad_transform: Callable[[Any], Any] | None = None,
                    accum_steps: int = 1, augment_fn: Callable | None = None):
    """The train step: (state, batch) -> (state, metrics).

    ``grad_transform`` rewrites the gradients before the update (e.g.
    ``clip_by_global_norm``). ``augment_fn`` ((images, generator) ->
    images, ``ops.augment.make_augment``) transforms the batch's images
    before the forward pass, drawing from ``augment_seed``. The metrics
    stay on the device until the caller reads them."""

    def step_fn(state: TrainState, batch):
        if augment_fn is not None:
            batch = apply_augment(augment_fn, batch,
                                  augment_seed(state.rng, state.step))
        seed = dropout_seed(state.rng, state.step) if keep_prob < 1 else None
        grads, metrics, model_state = compute_grads(
            model, state.params, batch, keep_prob=keep_prob, rng=seed,
            model_state=state.model_state, accum_steps=accum_steps)
        opt_state = apply_gradients(optimizer, state, grads, grad_transform)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.rng, model_state), metrics)

    return step_fn


def make_eval_step(model):
    """(batch, model_state) -> metrics through ``model``'s current
    parameters, dropout off: the reference's display eval
    (``MNISTDist.py:181-182``), usable on the test split too."""

    @torch.no_grad()
    def eval_fn(batch, model_state=()):
        _, aux = loss_and_metrics(model, batch, train=False,
                                  model_state=model_state)
        return aux["metrics"]

    return eval_fn


def evaluate(model, dataset, batch_size: int = 1000,
             model_state=()) -> dict[str, float]:
    """Full-split evaluation of ``model``'s current parameters, weighted
    over a remainder batch, on the device that holds them."""
    eval_fn = make_eval_step(model)
    device = next(model.parameters()).device
    n = dataset.num_examples
    images, labels = dataset.images, dataset.labels
    total = {"loss": 0.0, "accuracy": 0.0}
    seen = 0
    for i in range(0, n, batch_size):
        xs = torch.tensor(images[i:i + batch_size], device=device)
        ys = torch.tensor(labels[i:i + batch_size], device=device)
        m = eval_fn((xs, ys), model_state)
        w = len(xs)
        total = {k: total[k] + float(m[k]) * w for k in total}
        seen += w
    return {k: v / max(seen, 1) for k, v in total.items()}
