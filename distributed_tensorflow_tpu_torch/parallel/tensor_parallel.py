"""Tensor parallelism over the grid's "model" axis — Megatron style.

The counterpart of ``distributed_tensorflow_tpu/parallel/tensor_parallel.py``.
The reference has no model parallelism of any kind (its only strategy is
async PS data-parallelism, ``MNISTDist.py:110-111``). The JAX package
makes the mesh's "model" axis real for the flagship CNN with the classic
column/row split of the FC stack —

    wd1 [3136, 1024]  column-split  (None, "model")   (bd1 follows)
    out [1024,   10]  row-split     ("model", None)

— and for the transformer blocks (attention heads and the MLP), and
lets XLA's SPMD partitioner insert the collectives the math needs. Here
each rank of a model group holds its own shards as its module's
parameters (``shard_state_tp``), and the collectives GSPMD derived are
written out as two autograd Functions at the split boundaries:
``copy_to_model`` (identity forward, ``all_reduce`` of the cotangent
over the model group backward) in front of a column-split matmul, and
``reduce_from_model`` (``all_reduce`` forward, identity backward) after a
row-split one. They are the only collectives of the split; the data axis
averages the gradients over each column of the grid
(``parallel/data_parallel.py``'s ``pmean`` on ``mesh.data_mesh``).

A spec is a tuple of axis names or None per dim, standing in for
``PartitionSpec``; ``()`` is replicated. Conv kernels, small biases,
embeddings, layer norms and the vocab head stay replicated.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (
    pmean,
    pmean_grads_and_metrics,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import MODEL_AXIS
from distributed_tensorflow_tpu_torch.training.train_state import (
    TrainState,
    apply_augment,
    apply_gradients,
    augment_seed,
    clip_by_global_norm,
    compute_grads,
    dropout_seed,
    loss_and_metrics,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    Shard,
    _leaves_with_path,
    shard_of,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# FC-stack split for the reference CNN's parameter names (models/cnn.py):
# first FC column-parallel, second FC row-parallel.
_CNN_TP_SPECS = {
    ("weights", "wd1"): (None, MODEL_AXIS),
    ("biases", "bd1"): (MODEL_AXIS,),
    ("weights", "out"): (MODEL_AXIS, None),
}


def _transformer_tp_table(all_keys) -> dict:
    """Megatron-style block split for the transformer families
    (models/transformer._Block): attention HEADS over the model axis
    (qkv (d, 3, h, dh) on its head dim; proj (h*dh, d) row-split — the
    head-major flatten keeps the split on head boundaries), MLP column-
    then row-split (in/w + in/b over mlp_dim; out/w contracting over
    it). Embeddings / positional / layernorms / the vocab head
    replicate: at these widths their FLOPs don't pay for collective
    traffic, and the large-vocab memory problem is solved by the
    streamed CE head (ops/nn.py), not by sharding."""
    table = {}
    for keys in all_keys:
        if len(keys) >= 3 and keys[0] == "blocks":
            leaf = keys[2:]
            if leaf == ("qkv",):
                table[keys] = (None, None, MODEL_AXIS, None)
            elif leaf == ("proj",):
                table[keys] = (MODEL_AXIS, None)
            elif leaf == ("mlp_in", "w"):
                table[keys] = (None, MODEL_AXIS)
            elif leaf == ("mlp_in", "b"):
                table[keys] = (MODEL_AXIS,)
            elif leaf == ("mlp_out", "w"):
                table[keys] = (MODEL_AXIS, None)
    return table


def _param_spec_list(params) -> list:
    """The split of each leaf of ``params``, in leaf order."""
    paths = [path for path, _ in _leaves_with_path(params)]
    all_keys = set(paths)
    if ("weights", "wd1") in all_keys:
        table = _CNN_TP_SPECS
    elif ("blocks", 0, "qkv") in all_keys:
        table = _transformer_tp_table(all_keys)
    else:
        table = {}
    return [table.get(p, ()) for p in paths]


def tp_param_specs(params):
    """Spec tree mirroring ``params``: the model family's split table
    over the model axis, everything else replicated (``()``). The CNN
    rule applies only when the params carry the full FC stack (wd1
    present) — a model that merely shares a leaf NAME with the table
    (e.g. the MLP's "out") must not have that one matmul split in
    isolation, which would buy a collective and shard nothing that
    matters. Transformer params (a "blocks" list of the shared block
    layout) get the Megatron block split."""
    return tree_unflatten(params, _param_spec_list(params))


def has_tp_specs(params) -> bool:
    """True when at least one leaf of ``params`` has a model-axis split —
    i.e. tensor parallelism would actually shard something. Models without
    matching names (e.g. the ResNets) would silently replicate everything
    over the model axis; callers use this to reject that loudly."""
    return any(s != () for s in _param_spec_list(params))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _check_divisibility(params, pspecs, mesh) -> None:
    """Every split dim must divide by the model-axis size — shape-based
    and at the LIBRARY layer, so every caller is protected (a split off
    head/column boundaries would silently mix heads)."""
    ways = mesh.shape[MODEL_AXIS]
    for path, leaf in _leaves_with_path(params):
        for d, axis in enumerate(_at(pspecs, path)):
            if axis == MODEL_AXIS and leaf.shape[d] % ways:
                raise ValueError(
                    f"model-axis size {ways} must divide the sharded "
                    f"dim {d} (= {leaf.shape[d]}) of a leaf with shape "
                    f"{tuple(leaf.shape)}; pick a --model_axis that "
                    f"divides the model's head count and MLP width")


def _structure(tree):
    return tree_map(lambda _: None, tree)


def _opt_spec_list(entry, params, pspecs: list) -> list:
    """Specs for one opt_state subtree, by structure rather than by
    optimizer name: a subtree that mirrors params (velocity/moment trees)
    takes the params specs; dicts recurse per slot; anything else (step
    counts and other scalar slots) replicates. This keeps every current
    and future slot layout working without a per-optimizer special
    case."""
    if _structure(entry) == _structure(params):
        return pspecs
    if isinstance(entry, Mapping):
        return [s for k in sorted(entry)
                for s in _opt_spec_list(entry[k], params, pspecs)]
    return [()] * len(tree_leaves(entry))


def tp_state_specs(state: TrainState) -> list:
    """The split of each leaf of ``state``, in leaf order: params (and
    their optimizer slots) follow ``tp_param_specs``; the step, the key
    and a model's state replicate."""
    pspecs = _param_spec_list(state.params)
    rest = (state.step, state.rng, state.model_state)
    return (pspecs + _opt_spec_list(state.opt_state, state.params, pspecs)
            + [()] * len(tree_leaves(rest)))


def _local_index(shape, spec, mesh) -> tuple[tuple[int, int], ...]:
    """This rank's [start, stop) per dim of a leaf of ``shape``."""
    index = []
    for d, size in enumerate(shape):
        if d < len(spec) and spec[d] == MODEL_AXIS:
            n = size // mesh.model
            index.append((mesh.model_index * n, (mesh.model_index + 1) * n))
        else:
            index.append((0, size))
    return tuple(index)


@torch.no_grad()
def _shard_leaf_(t: torch.Tensor, spec, mesh) -> None:
    """Cut ``t`` to this rank's shard in place (a parameter stays the
    module's parameter): its own contiguous tensor, not a strided view
    of the full one, tagged with where it sits in the full leaf."""
    full = tuple(t.shape)
    index = _local_index(full, spec, mesh)
    t.data = t.data[tuple(slice(a, b) for a, b in index)].clone(
        memory_format=torch.contiguous_format)
    t._dtt_shard = Shard(global_shape=full, index=index,
                         dim=list(spec).index(MODEL_AXIS), ways=mesh.model,
                         owner=mesh.data_index == 0, group=mesh.model_group,
                         backend=mesh.backend)


def shard_state_tp(state: TrainState, mesh) -> TrainState:
    """A full state, the optimizer slots included, cut to this rank's
    shards in place: the split parameters of the module (and their
    slots) become the rank's columns or rows. Refuses shapes the model
    axis does not divide. Leaves already sharded are left as they are
    (a re-staged state)."""
    _check_divisibility(state.params, tp_param_specs(state.params), mesh)
    for leaf, spec in zip(tree_leaves(state), tp_state_specs(state)):
        if MODEL_AXIS in spec and shard_of(leaf) is None:
            _shard_leaf_(leaf, spec, mesh)
    return state


class _CopyToModel(torch.autograd.Function):
    """Identity forward; ``all_reduce`` of the cotangent over the model
    group backward: the input of a column-split matmul feeds every
    rank's columns, so its gradient is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """``all_reduce`` over the model group forward (the row-split
    matmul's partial outputs sum to the full one); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, taken in float32 (a bf16 partial
    is rounded once, after the sum), in ``x``'s dtype."""
    buf = x.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def tp_model(model, mesh):
    """``model`` running its forward on its local shards over ``mesh``'s
    model group (``model.tp``); the parameters must be sharded before the
    first forward (``shard_state_tp``)."""
    model.tp = mesh
    return model


def tp_clip_transform(max_norm: float, params, mesh):
    """``clip_by_global_norm`` of the full model's gradient: the split
    leaves' local square-sums ``all_reduce`` over the model group, each
    replicated leaf counted once. A per-shard clip would scale each
    rank's shards by its own norm and tear the model apart."""
    split = [s != () for s in _param_spec_list(params)]
    return clip_by_global_norm(max_norm, split=split,
                               group=mesh.model_group)


def make_tp_train_step(model, optimizer, mesh, keep_prob: float = 1.0,
                       grad_transform=None, accum_steps: int = 1,
                       augment_fn=None):
    """The TP(+DP) train step: (state, local batch) -> (state, metrics).

    Forward and backward on this rank's shards (the model group's
    collectives inside the forward and backward), the gradients and
    metrics averaged over the data axis (the grid's column), then
    ``grad_transform`` (``tp_clip_transform``) and the update of the local
    shards and the replicated leaves. The dropout and augmentation seeds
    mix in the data index, not the rank: the ranks of one model group
    draw one mask, and each keeps its own columns of it."""
    tp_model(model, mesh)
    data_mesh = mesh.data_mesh

    def step_fn(state: TrainState, batch):
        if augment_fn is not None:
            batch = apply_augment(augment_fn, batch, augment_seed(
                state.rng, state.step, mesh.data_index))
        seed = (dropout_seed(state.rng, state.step, mesh.data_index)
                if keep_prob < 1 else None)
        grads, metrics, model_state = compute_grads(
            model, state.params, batch, keep_prob=keep_prob, rng=seed,
            model_state=state.model_state, accum_steps=accum_steps)
        if mesh.data > 1:
            grads, metrics = pmean_grads_and_metrics(grads, metrics,
                                                     data_mesh, model_state)
        opt_state = apply_gradients(optimizer, state, grads, grad_transform)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.rng, model_state), metrics)

    return step_fn


def make_tp_eval_step(model, mesh):
    """(local batch, model_state) -> metrics, dropout off, through the
    local shards (every rank of a model group calls it together), averaged
    over the data axis."""
    tp_model(model, mesh)

    @torch.no_grad()
    def eval_fn(batch, model_state=()):
        _, aux = loss_and_metrics(model, batch, train=False,
                                  model_state=model_state)
        metrics = aux["metrics"]
        if mesh.data == 1:
            return metrics
        names = sorted(metrics)
        return dict(zip(names, pmean([metrics[k] for k in names],
                                     mesh.data_mesh)))

    return eval_fn


def stage_batch_tp(mesh, batch):
    """This rank's batch on its device: the ranks of a model group read
    the same batch (their data seed is the data index), so the model
    axis needs no staging of its own."""
    return tuple(t.to(mesh.device, non_blocking=True) for t in batch)


def tp_comm_rows(fwd_act_bytes: int, bwd_act_bytes: int) -> list[dict]:
    """Static per-step activation all-reduce bytes for the Megatron
    split — the comm ledger's TP rows, priced against what the GSPMD
    partitioner ACTUALLY inserts (machine-proven for the CNN by
    ``tools/dttcheck`` r18 from the compiled SPMD HLO). The two
    payloads differ because the two sync points sit at different
    widths: forward psums the ROW-SPLIT matmul's partial OUTPUTS
    (``fwd_act_bytes`` — for the CNN FC stack that is (B, num_classes),
    NOT the hidden activations the pre-r18 row priced, a ~100x
    overcount at the flagship shapes); backward psums the cotangent at
    the COLUMN-SPLIT input (``bwd_act_bytes`` — (B, fc_in) for the
    CNN). Transformer blocks are symmetric: both boundaries psum a
    (B, S, d_model) tensor per block, attention-out + MLP-down.
    All-reduce convention ~2x; callers pass the summed per-pass
    payload."""
    rows = []
    if fwd_act_bytes > 0:
        rows.append({
            "collective": "all_reduce(activations, forward)",
            "axis": "model", "bytes": 2 * fwd_act_bytes,
            "note": "row-split boundaries psum their partial outputs "
                    "(~2x, GSPMD-inserted)"})
    if bwd_act_bytes > 0:
        rows.append({
            "collective": "all_reduce(cotangents, backward)",
            "axis": "model", "bytes": 2 * bwd_act_bytes,
            "note": "the column-split inputs psum the backward "
                    "cotangent (~2x, GSPMD-inserted)"})
    return rows
