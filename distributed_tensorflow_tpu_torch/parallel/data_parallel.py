"""Synchronous data parallelism on ``torch.distributed``.

The counterpart of ``distributed_tensorflow_tpu/parallel/data_parallel.py``.
The reference trains asynchronously through parameter servers
(``MNISTDist.py:110-111,174-176,188``) and leaves synchronous training
to ``SyncReplicasOptimizer``. The JAX package runs it as one
``shard_map`` program whose ``lax.pmean`` averages the gradients over
the mesh's data axis. Here each rank is its own process on its own
device (``parallel/mesh.py``); a step is forward and backward on the
rank's slice of the global batch, then ONE ``all_reduce`` of the
gradients, the metrics and a stateful model's batch-norm running stats,
packed into a flat float32 buffer (float64 for a float64 model) and
divided by the world size
(``pmean``), then the clip and the update, the same on every rank. The
replicas stay bitwise equal: every rank receives the same reduced bytes
and applies the same arithmetic to them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.training.train_state import (
    TrainState,
    apply_augment,
    apply_gradients,
    augment_seed,
    compute_grads,
    dropout_seed,
    loss_and_metrics,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_unflatten,
)


def local_batch_size(global_batch_size: int, mesh) -> int:
    """This rank's share of the global batch."""
    n = mesh.world_size
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} ranks")
    return global_batch_size // n


def pmean(tensors: list, mesh) -> list:
    """The mean of each tensor over the mesh's ranks (``lax.pmean``): one
    ``all_reduce`` of a flat buffer in float32 (float64 when a tensor is
    float64), then a division by the world size. Returns views of the
    buffer, in the tensors' shapes."""
    dtype = functools.reduce(torch.promote_types,
                             (t.dtype for t in tensors), torch.float32)
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.world_size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def pmean_grads_and_metrics(grads, metrics: dict, mesh, model_state=()):
    """(grads, metrics) averaged over the ranks in one collective, with
    ``model_state`` (a stateful model's running stats, each rank's own
    EMA) averaged in the same collective and written back in place."""
    leaves = tree_leaves(grads)
    names = sorted(metrics)
    stats = tree_leaves(model_state)
    reduced = pmean(leaves + [metrics[k] for k in names] + stats, mesh)
    n = len(leaves) + len(names)
    with torch.no_grad():
        for t, r in zip(stats, reduced[n:]):
            t.copy_(r)
    return (tree_unflatten(grads, reduced[:len(leaves)]),
            dict(zip(names, reduced[len(leaves):n])))


def make_dp_train_step(model, optimizer, mesh, keep_prob: float = 1.0,
                       grad_transform=None, accum_steps: int = 1,
                       augment_fn=None):
    """The sync-DP train step: (state, local batch) -> (state, metrics).

    Forward and backward on this rank's slice with dropout and
    augmentation seeds that mix in the rank (the JAX package's
    ``fold_in(axis_index)``), the gradients, metrics and running stats
    averaged over the ranks, ``grad_transform`` (the clip) on the
    averaged gradients, the same update everywhere."""

    def step_fn(state: TrainState, batch):
        if augment_fn is not None:
            batch = apply_augment(augment_fn, batch, augment_seed(
                state.rng, state.step, mesh.rank))
        seed = (dropout_seed(state.rng, state.step, mesh.rank)
                if keep_prob < 1 else None)
        grads, metrics, model_state = compute_grads(
            model, state.params, batch, keep_prob=keep_prob, rng=seed,
            model_state=state.model_state, accum_steps=accum_steps)
        grads, metrics = pmean_grads_and_metrics(grads, metrics, mesh,
                                                 model_state)
        opt_state = apply_gradients(optimizer, state, grads, grad_transform)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.rng, model_state), metrics)

    return step_fn


def make_dp_eval_step(model, mesh):
    """(local batch, model_state) -> metrics averaged over the ranks,
    dropout off."""

    @torch.no_grad()
    def eval_fn(batch, model_state=()):
        _, aux = loss_and_metrics(model, batch, train=False,
                                  model_state=model_state)
        metrics = aux["metrics"]
        names = sorted(metrics)
        return dict(zip(names, pmean([metrics[k] for k in names], mesh)))

    return eval_fn


def _broadcast_(t: torch.Tensor, mesh) -> None:
    """Rank 0's ``t`` into every rank's ``t``, in place. NCCL moves only
    device tensors, so a host tensor travels through a device copy."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        buf = t.to(mesh.device)
        dist.broadcast(buf, 0, group=mesh.group)
        t.copy_(buf)
    else:
        dist.broadcast(t, 0, group=mesh.group)


@torch.no_grad()
def replicate_state(mesh, state: TrainState) -> TrainState:
    """Rank 0's state on every rank: each tensor (parameters, optimizer
    slots, step) broadcast in place, and the uint32[2] key with them. A
    fresh init and a restore start bitwise equal everywhere.

    Refuses a ZeRO-layout state (``parallel.zero.ZeroState``): each rank
    holds its own flat, padded chunks there, and broadcasting rank 0's
    over the others would silently train on them as if they were the
    standard layout. Fetch the standard layout first
    (``parallel.zero.fetch_state_zero``) and replicate that."""
    from distributed_tensorflow_tpu_torch.parallel.zero import ZeroState

    if isinstance(state, ZeroState):
        raise ValueError(
            "replicate_state: the state is in the ZeRO layout (each "
            "rank's own flat, padded chunks); re-replicating it would "
            "treat rank 0's chunks as the standard layout. Fetch the "
            "standard layout first (parallel.zero.fetch_state_zero) and "
            "replicate that.")
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            _broadcast_(leaf, mesh)
    key = torch.from_numpy(np.asarray(state.rng).astype(np.int64))
    _broadcast_(key, mesh)
    return state._replace(rng=key.numpy().astype(np.uint32))


def dp_comm_rows(grad_bytes: int, d: int) -> list[dict]:
    """Static per-step collective wire bytes of replicated DP: its one
    collective, the gradient ``pmean`` (a ring all-reduce, ~2|G| over the
    ranks). The ZeRO level-0 row, so the all-reduce convention has one
    formula (``parallel/zero.zero_comm_rows``)."""
    from distributed_tensorflow_tpu_torch.parallel.zero import zero_comm_rows

    return zero_comm_rows(grad_bytes, 0, 0, d)
