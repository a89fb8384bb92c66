"""ZeRO-sharded synchronous data parallelism on ``torch.distributed``.

The counterpart of ``distributed_tensorflow_tpu/parallel/zero.py``.
Replicated sync DP (``data_parallel.py``) keeps the full optimizer state
on every rank and all-reduces the full gradient every step; every rank
then computes the same update. ZeRO (Rajbhandari et al., 2020) partitions
that redundant state 1/D over the D data-parallel ranks at identical
arithmetic:

``--zero 1`` (optimizer-state sharding)
    The gradients leave the backward pass as full local leaves, are
    flattened, zero-padded to a multiple of D and reduce-scattered
    (``dist.reduce_scatter_tensor``): each rank receives its 1/D chunk of
    the summed gradient, divided by D after the sum, as ``pmean`` does.
    The optimizer update runs on the rank's chunk of its slots against
    the same chunk of the (replicated) parameters, and one
    ``all_gather_into_tensor`` a leaf writes the updated parameters back
    into the module everywhere. Wire: |G| + |P| where the all-reduce
    moves 2|G|; optimizer memory 1/D.

``--zero 3`` (FSDP-style: the parameters sharded too)
    The parameters live as 1/D flat chunks in the state. The module's own
    parameter tensors are the gathered-parameter buffer: each step first
    gathers the chunks into them, runs forward and backward against them,
    and reduce-scatters the full gradient explicitly. That is the
    transpose of the gather, which is how the JAX package's serial path
    differentiates through its ``all_gather`` (tests/test_torch_zero.py
    holds the two equal). The buffer stays allocated between steps, where
    a CUDA graph needs it; the state's own resting parameters are 1/D.

``overlap=True`` (``--zero_overlap``) groups the leaves into buckets of
at most ``--zero_bucket_mb`` (``_bucket_plan``; one collective a bucket,
each leaf padded and laid out as [D, c] rows so rank r owns row r, the
per-leaf chunk), and at level 3 gathers the NEXT step's parameters into
the buffer right after the update (the prefetch), so the following step
starts on gathered parameters. Every collective here runs on NCCL's
stream in program order: the prefetch moves the gather out of the step's
critical path on the host's side only.

Exactness: every optimizer op is elementwise and the padding lanes reduce
exact zeros, so a ZeRO step computes the values that replicated DP
computes wherever the reduce-scatter sums what the all-reduce sums in the
same order: at one rank (the collectives are copies) and at two (a + b =
b + a). gloo at three or more ranks orders a sum by the element's place in
the buffer, so its per-leaf and bucketed layouts, and DP's one packed
buffer, round differently in the last ulp (ROADMAP queue 3). ``--clip_norm``
needs ``zero_clip_transform``: each rank's chunks are distinct pieces of
the gradient, so their squared norms are summed over the ranks before one
scale applies everywhere.

Checkpoints stay in the standard layout: ``fetch_state_zero`` is a
collective gather (every rank takes part, at a step they agree on) into a
host copy of the standard ``TrainState``, and ``shard_state_zero`` cuts a
standard state (restored from either package, from a replicated or a
ZeRO run) into this rank's chunks. ``replicate_state`` refuses a
``ZeroState``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (
    make_dp_eval_step,
    pmean_grads_and_metrics,
)
from distributed_tensorflow_tpu_torch.training.train_state import (
    TrainState,
    apply_augment,
    apply_updates,
    augment_seed,
    compute_grads,
    dropout_seed,
    params_of,
)
from distributed_tensorflow_tpu_torch.utils.pytree import (
    _leaves_with_path,
    _is_namedtuple,
    path_key,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

DEFAULT_BUCKET_MB = 4.0  # --zero_bucket_mb default (the comm/latency knob)


class ZeroState(TrainState):
    """A ``TrainState`` in the ZeRO layout on one rank: each params-shaped
    optimizer subtree, and at level 3 ``params``, holds this rank's flat
    zero-padded chunks of ceil(n/D) elements; ``params`` at level 1 are
    the module's own (replicated) parameters. It flattens to the standard
    keys but not the standard shapes, so it is never checkpointed:
    ``fetch_state_zero`` makes the standard layout."""

    __slots__ = ()


def _leaf_size(leaf) -> int:
    """Element count of a (possibly scalar) leaf or shape."""
    shape = leaf if isinstance(leaf, (tuple, list, torch.Size)) \
        else tuple(leaf.shape)
    return math.prod(shape) if shape else 1


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def abstract_params(model) -> list:
    """The model's parameters as (shape, dtype) meta tensors, in tree
    order: the per-leaf metadata every gather and scatter needs to undo
    the padded chunking. No memory and no device."""
    return [torch.empty(p.shape, dtype=p.dtype, device="meta")
            for p in tree_leaves(params_of(model))]


def _check_level(level: int) -> int:
    level = int(level)
    if level not in (1, 3):
        raise ValueError(f"zero level must be 1 (optimizer-state "
                         f"sharding) or 3 (params too); got {level}")
    return level


def _pad_flat(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` flattened and zero-padded to a multiple of ``d``."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % d
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


@torch.no_grad()
def _scatter_leaf(g: torch.Tensor, mesh) -> torch.Tensor:
    """Full local leaf -> this rank's 1/D chunk of the cross-rank SUM:
    flatten, zero-pad to a multiple of D, reduce-scatter. The padding
    lanes sum exact zeros, so they stay inert through every optimizer."""
    flat = _pad_flat(g, mesh.world_size).contiguous()
    out = flat.new_empty(flat.numel() // mesh.world_size)
    dist.reduce_scatter_tensor(out, flat, group=mesh.group)
    return out


@torch.no_grad()
def _gather_leaf(chunk: torch.Tensor, shape, mesh) -> torch.Tensor:
    """Local 1/D chunk -> the full leaf: all-gather over the ranks, drop
    the padding lanes, restore the shape."""
    full = chunk.new_empty(mesh.world_size * chunk.numel())
    dist.all_gather_into_tensor(full, chunk.contiguous(), group=mesh.group)
    return full[:_leaf_size(shape)].view(shape)


def _gather_params(chunks: list, meta: list, mesh) -> list:
    return [_gather_leaf(c, m.shape, mesh) for c, m in zip(chunks, meta)]


def _bucket_plan(leaves, d: int, bucket_bytes: int) -> list[list[int]]:
    """Host-side static bucketing: consecutive leaves (tree order) grouped
    while the PADDED payload stays within ``bucket_bytes`` (every bucket
    holds >= 1 leaf; a dtype change starts a new bucket, since a bucket
    is one concatenated tensor). The JAX package's plan, leaf for leaf."""
    d = max(1, int(d))
    bucket_bytes = max(1, int(bucket_bytes))
    plan: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_dtype = None
    for i, leaf in enumerate(leaves):
        n = _leaf_size(leaf)
        padded = (-(-n // d)) * d * _itemsize(leaf.dtype)
        if cur and (leaf.dtype != cur_dtype
                    or cur_bytes + padded > bucket_bytes):
            plan.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += padded
        cur_dtype = leaf.dtype
    if cur:
        plan.append(cur)
    return plan


def n_buckets(model, d: int, bucket_mb: float) -> int:
    """Static bucket count of a model's parameter tree at one bucket
    size."""
    return len(_bucket_plan(abstract_params(model), d,
                            int(bucket_mb * 2 ** 20)))


@torch.no_grad()
def _scatter_bucketed(grads: list, mesh, plan) -> list:
    """Bucketed reduce-scatter: each leaf pads and reshapes to [D, c] (row
    r IS rank r's chunk, the ownership of ``_scatter_leaf``), the leaves
    of a bucket concatenate along the chunk axis, one reduce-scatter per
    bucket, then the chunks split back out. A one-leaf bucket is
    ``_scatter_leaf``."""
    d = mesh.world_size
    out = [None] * len(grads)
    for bucket in plan:
        if len(bucket) == 1:
            out[bucket[0]] = _scatter_leaf(grads[bucket[0]], mesh)
            continue
        mats = [_pad_flat(grads[i], d).view(d, -1) for i in bucket]
        buck = torch.cat(mats, dim=1).reshape(-1)
        red = buck.new_empty(buck.numel() // d)
        dist.reduce_scatter_tensor(red, buck, group=mesh.group)
        off = 0
        for i, mat in zip(bucket, mats):
            c = mat.shape[1]
            out[i] = red[off:off + c]
            off += c
    return out


@torch.no_grad()
def _gather_bucketed(chunks: list, meta: list, mesh, plan) -> list:
    """Bucketed all-gather: the chunks of a bucket concatenate, one
    all-gather per bucket, then each leaf's [D, c] columns slice back out
    of the [D, C] result: pure data movement, bitwise the per-leaf
    gathers. A one-leaf bucket is ``_gather_leaf``."""
    d = mesh.world_size
    out = [None] * len(chunks)
    for bucket in plan:
        if len(bucket) == 1:
            i = bucket[0]
            out[i] = _gather_leaf(chunks[i], meta[i].shape, mesh)
            continue
        cat = torch.cat([chunks[i] for i in bucket])
        full = cat.new_empty(d * cat.numel())
        dist.all_gather_into_tensor(full, cat, group=mesh.group)
        full = full.view(d, -1)
        off = 0
        for i in bucket:
            c = chunks[i].numel()
            out[i] = full[:, off:off + c].reshape(-1)[
                :_leaf_size(meta[i])].view(meta[i].shape)
            off += c
    return out


@torch.no_grad()
def _local_chunk(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's 1/D flat chunk of a REPLICATED full leaf (a copy): pad,
    then slice at the rank's offset, the chunk a reduce-scatter owns."""
    flat = _pad_flat(x, mesh.world_size)
    c = flat.numel() // mesh.world_size
    return flat[mesh.rank * c:(mesh.rank + 1) * c].clone()


@torch.no_grad()
def _write_params(params: list, full: list) -> None:
    """Gathered full leaves into the module's parameters, in place."""
    for p, f in zip(params, full):
        p.copy_(f)


def zero_clip_transform(max_norm: float, mesh):
    """The global-norm clip for the gradient chunks of a ZeRO step. Each
    rank's chunks are a distinct 1/D piece of the mean gradient, so each
    rank's squared sum is an exact partial of the global one; one
    ``all_reduce`` totals them and the SAME scale applies on every rank.
    The clip of ``train_state.clip_by_global_norm`` otherwise (a plain one
    here would scale each rank by its own partial norm). The partials sum
    in another order than the replicated clip's full leaves, so a clipped
    run matches replicated DP to float tolerance and every ZeRO level
    bitwise."""
    max_norm = float(max_norm)

    def transform(gchunks):
        sq = sum(torch.sum(torch.square(g.float()))
                 for g in tree_leaves(gchunks)).reshape(1)
        dist.all_reduce(sq, group=mesh.group)
        norm = torch.sqrt(sq[0])
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: (g * scale).to(g.dtype), gchunks)

    return transform


def _structure(tree):
    """A hashable description of ``tree``'s containers and keys, leaves
    left out: two trees with the same structure differ only in leaves."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if _is_namedtuple(tree):
        return (type(tree).__name__,
                tuple(_structure(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    return "*"


def _map_params_shaped(entry, pstruct, fn, passthrough):
    """``fn`` on every optimizer-state subtree that mirrors the parameter
    tree's structure (adam's ``m`` and ``v``, momentum's velocity),
    recursing through dict containers; ``passthrough`` on everything else
    (adam's scalar ``t``). The JAX package keeps this rule in its
    pipeline-parallel module."""
    if _structure(entry) == pstruct:
        return fn(entry)
    if isinstance(entry, dict):
        return {k: _map_params_shaped(entry[k], pstruct, fn, passthrough)
                for k in sorted(entry)}
    return passthrough(entry)


def shard_state_zero(state: TrainState, mesh, level: int) -> ZeroState:
    """Standard-layout ``TrainState`` -> this rank's ZeRO layout: the
    params-shaped optimizer subtrees (and, at level 3, the params) become
    flat zero-padded copies of this rank's 1/D chunk; everything else is
    kept (the level-1 params and the model state stay the module's own
    tensors). The inverse is ``fetch_state_zero``."""
    level = _check_level(level)
    if isinstance(state, ZeroState):
        raise ValueError("shard_state_zero: the state is already in the "
                         "ZeRO layout")
    chunkify = lambda tree: tree_map(  # noqa: E731
        lambda t: _local_chunk(t, mesh), tree)
    pstruct = _structure(state.params)
    return ZeroState(
        params=chunkify(state.params) if level >= 3 else state.params,
        opt_state=_map_params_shaped(state.opt_state, pstruct, chunkify,
                                     lambda e: e),
        step=state.step, rng=state.rng, model_state=state.model_state)


def _to_host(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return np.array(t, copy=True)


@torch.no_grad()
def fetch_state_zero(state: ZeroState, model, mesh, level: int) -> TrainState:
    """ZeRO-layout state -> a host copy of the state in the STANDARD layout
    (the checkpoint format, the same whatever ``--zero`` level or none the
    run trained under). A collective: every rank calls it at the same
    step. At level 3 it also gathers the parameters into the module, so
    an evaluation after it reads the current ones."""
    level = _check_level(level)
    params = params_of(model)
    leaves, meta = tree_leaves(params), abstract_params(model)
    if level >= 3:
        _write_params(leaves, _gather_params(tree_leaves(state.params),
                                             meta, mesh))
    unchunk = lambda tree: tree_unflatten(  # noqa: E731
        params, _gather_params(tree_leaves(tree), meta, mesh))
    opt_state = _map_params_shaped(state.opt_state, _structure(params),
                                   unchunk, lambda e: e)
    return TrainState(params=tree_map(_to_host, params),
                      opt_state=tree_map(_to_host, opt_state),
                      step=_to_host(state.step), rng=_to_host(state.rng),
                      model_state=tree_map(_to_host, state.model_state))


def _zero_step_core(model, optimizer, mesh, level, keep_prob,
                    grad_transform, accum_steps: int = 1,
                    overlap: bool = False, bucket_bytes: int | None = None):
    """The ZeRO update shared by the host-fed step and the device step
    (``training/device_step.ZeroDeviceTrainStep``): ``core(state, batch,
    rng) -> (opt_state, metrics)``, in place on ``state`` (a
    ``ZeroState``) and the module. The caller owns the seeds and the
    sampling, the replicated step's own; the core owns (gather) -> grads
    -> reduce-scatter -> clip -> sharded update -> gather.

    ``overlap`` switches to the bucketed collectives and, at level 3, the
    prefetch: the update ends by gathering the next step's parameters
    into the module, so the next step skips its leading gather. The
    values are the serial path's."""
    level = _check_level(level)
    params = params_of(model)  # level 1: replicated; level 3: the buffer
    leaves = tree_leaves(params)
    meta = abstract_params(model)
    d = mesh.world_size
    bucket_bytes = int(bucket_bytes or DEFAULT_BUCKET_MB * 2 ** 20)
    plan = (_bucket_plan(meta, d, bucket_bytes) if overlap
            else [[i] for i in range(len(leaves))])

    def gather_into_module(chunks):
        _write_params(leaves, _gather_bucketed(tree_leaves(chunks), meta,
                                               mesh, plan))

    def core(state: ZeroState, batch, rng):
        if level >= 3 and not overlap:
            # params live as chunks: gather them for forward and backward
            gather_into_module(state.params)
        grads, metrics, model_state = compute_grads(
            model, params, batch, keep_prob=keep_prob, rng=rng,
            model_state=state.model_state, accum_steps=accum_steps)
        with torch.no_grad():
            return update(state, grads, metrics, model_state)

    def update(state, grads, metrics, model_state):
        # reduce-scatter (|G| on the wire) where the replicated step
        # all-reduces (2|G|); /d after the sum, pmean's arithmetic
        gchunks = tree_unflatten(params, [
            g / d for g in _scatter_bucketed(tree_leaves(grads), mesh,
                                             plan)])
        if grad_transform is not None:
            gchunks = grad_transform(gchunks)
        _, metrics = pmean_grads_and_metrics({}, metrics, mesh, model_state)
        pchunks = (state.params if level >= 3 else
                   tree_map(lambda p: _local_chunk(p, mesh), params))
        # every optimizer op is elementwise over (grads, slots, params):
        # on 1/D chunks it computes the replicated update's values
        updates, opt_state = optimizer.update(gchunks, state.opt_state,
                                              pchunks, state.step)
        apply_updates(pchunks, updates)
        if level < 3 or overlap:
            # level 1: rebuild the replicated params; level 3 overlapped:
            # prefetch the next step's
            gather_into_module(pchunks)
        return opt_state, metrics

    return core


def make_zero_train_step(model, optimizer, mesh, level: int,
                         keep_prob: float = 1.0, grad_transform=None,
                         accum_steps: int = 1, augment_fn=None,
                         overlap: bool = False,
                         bucket_mb: float = DEFAULT_BUCKET_MB):
    """The ZeRO sync-DP train step: (ZeroState, local batch) -> (state,
    metrics). Drop-in for ``make_dp_train_step`` on a state made by
    ``shard_state_zero``: the same augmentation and dropout seeds, the
    same elementwise update arithmetic; only the collectives change.
    ``grad_transform`` runs on the scattered mean-gradient chunks: pass
    ``zero_clip_transform`` for ``--clip_norm``."""
    core = _zero_step_core(model, optimizer, mesh, level, keep_prob,
                           grad_transform, accum_steps, overlap=overlap,
                           bucket_bytes=int(bucket_mb * 2 ** 20))

    def step_fn(state: ZeroState, batch):
        if augment_fn is not None:
            batch = apply_augment(augment_fn, batch, augment_seed(
                state.rng, state.step, mesh.rank))
        seed = (dropout_seed(state.rng, state.step, mesh.rank)
                if keep_prob < 1 else None)
        opt_state, metrics = core(state, batch, seed)
        return state._replace(opt_state=opt_state,
                              step=state.step + 1), metrics

    return step_fn


def make_zero_eval_step(model, mesh, level: int):
    """(params, local batch, model_state) -> metrics averaged over the
    ranks, dropout off, for a ZeRO-layout state's ``params``. Level 1's
    are the module's and the DP eval applies verbatim; level 3 first
    gathers the chunks into the module (the same reconstruction, so the
    metrics are the DP eval's)."""
    level = _check_level(level)
    dp_eval = make_dp_eval_step(model, mesh)
    leaves, meta = tree_leaves(params_of(model)), abstract_params(model)

    def eval_fn(params, batch, model_state=()):
        if level >= 3:
            _write_params(leaves, _gather_params(tree_leaves(params), meta,
                                                 mesh))
        return dp_eval(batch, model_state)

    return eval_fn


def zero_memory_budget(model, optimizer, d: int) -> dict:
    """STATIC per-rank memory budget (meta tensors: no memory, no
    device): parameter and optimizer bytes per leaf and per ``--zero``
    level, the JAX package's table row for row. Replicated holds full
    params and the full optimizer state; ZeRO-1 holds full params and
    ceil(n/D) elements of every params-shaped slot (padding included);
    ZeRO-3 chunks the params the same way. Gradient bytes are the
    transient full-leaf backward output, the same in every mode. The
    port's level 3 also keeps one full gathered-parameter buffer (the
    module's parameters) that this table, like the JAX package's, leaves
    out."""
    d = int(d)
    if d < 1:
        raise ValueError(f"data-axis size must be >= 1, got {d}")
    params = tree_unflatten(params_of(model), abstract_params(model))
    opt_state = optimizer.init(params)
    rows: list[dict] = []

    def add_rows(kind, tree, chunked: bool, prefix: str = ""):
        for path, leaf in _leaves_with_path(tree):
            n = _leaf_size(leaf)
            isz = _itemsize(leaf.dtype)
            rows.append({
                "kind": kind,
                "leaf": (prefix + path_key(path)).rstrip("/") or "(scalar)",
                "elements": n,
                "bytes": n * isz,
                "sharded_bytes": (-(-n // d)) * isz if chunked else n * isz,
                "chunked": chunked,
            })

    add_rows("param", params, chunked=True)
    pstruct = _structure(params)

    def walk_opt(entry, prefix: str):
        # _map_params_shaped's rule, keeping the container path
        if _structure(entry) == pstruct:
            add_rows("opt", entry, chunked=True, prefix=prefix)
        elif isinstance(entry, dict):
            for k in sorted(entry):
                walk_opt(entry[k], f"{prefix}{k}/")
        else:
            add_rows("opt", entry, chunked=False, prefix=prefix)

    walk_opt(opt_state, "")

    def total(kind, key):
        return sum(r[key] for r in rows if r["kind"] == kind)

    p_full, p_shard = total("param", "bytes"), total("param", "sharded_bytes")
    o_full, o_shard = total("opt", "bytes"), total("opt", "sharded_bytes")
    per_chip = {
        "replicated": {"params": p_full, "opt": o_full, "grads": p_full},
        "zero1": {"params": p_full, "opt": o_shard, "grads": p_full},
        "zero3": {"params": p_shard, "opt": o_shard, "grads": p_full},
    }
    return {
        "d": d, "rows": rows,
        "param_bytes": p_full, "opt_bytes": o_full,
        "per_chip": per_chip,
        "opt_reduction": (o_full / o_shard) if o_shard else 1.0,
        "param_reduction": (p_full / p_shard) if p_shard else 1.0,
    }


def zero_comm_rows(grad_bytes: int, param_bytes: int, level: int,
                   d: int, overlap: bool = False,
                   bucket_mb: float = DEFAULT_BUCKET_MB) -> list[dict]:
    """Static per-step collective wire bytes of this module's patterns,
    the JAX package's rows and conventions: all-reduce ~2|G|,
    reduce-scatter |G|, all-gather |P|. ``level=0`` is replicated DP's
    gradient all-reduce. A 1-way data axis moves nothing.

    Each row carries ``exposed_bytes``, the analytic share on the step's
    critical path: serial rows expose everything; ``overlap=True`` prices
    the bucketed reduce-scatter at its last bucket and the level-3
    prefetched gather at 0. These are the JAX package's schedule
    assumptions: the port issues every collective in program order on
    NCCL's stream, so on the card they bound what an overlapped schedule
    could hide, not what this one hides."""
    if d < 2:
        return []
    if level == 0:
        return [{"collective": "all_reduce(grads)", "axis": "data",
                 "bytes": 2 * grad_bytes, "exposed_bytes": 2 * grad_bytes,
                 "note": "replicated DP: ring all-reduce moves ~2|G|"}]
    _check_level(level)
    bucket_bytes = max(1, int(bucket_mb * 2 ** 20))
    scatter_exposed = (min(bucket_bytes, grad_bytes) if overlap
                       else grad_bytes)
    scatter_note = (
        f"bucketed reduce-scatter ({-(-grad_bytes // bucket_bytes)} "
        f"bucket(s) of <= {bucket_mb:g} MB): buckets issue as backward "
        f"produces leaves; only the last is exposed" if overlap else
        "reduce-scatter: each rank receives its 1/D chunk of the "
        "summed gradient (|G| on the wire)")
    rows = [{"collective": "psum_scatter(grads)", "axis": "data",
             "bytes": grad_bytes, "exposed_bytes": scatter_exposed,
             "note": scatter_note}]
    if level == 1:
        rows.append({
            "collective": "all_gather(params)", "axis": "data",
            "bytes": param_bytes,
            "exposed_bytes": (min(bucket_bytes, param_bytes) if overlap
                              else param_bytes),
            "note": ("bucketed gather rebuilds the replicated params; "
                     "the next step's sampling hides all but the last "
                     "bucket" if overlap else
                     "one gather rebuilds the replicated updated "
                     "params (|P|)")})
    elif overlap:  # level 3 overlapped: ONE prefetched gather, reused
        rows[0]["collective"] = "psum_scatter(grads, bucketed)"
        rows.append({
            "collective": "all_gather(params, prefetched)",
            "axis": "data", "bytes": param_bytes, "exposed_bytes": 0,
            "note": "issued right after the previous update and reused "
                    "by forward and backward"})
    else:  # level 3 serial: params live sharded, ONE gather per step
        rows[0]["collective"] = "reduce_scatter(grad transpose)"
        rows[0]["note"] = ("the all_gather's transpose routes grad "
                           "contributions to the owning rank (|G|)")
        rows.append({"collective": "all_gather(params, forward)",
                     "axis": "data", "bytes": param_bytes,
                     "exposed_bytes": param_bytes,
                     "note": "sharded params gather into the module "
                             "once per step (|P|); the backward reads "
                             "the same buffer, so nothing re-gathers"})
    return rows


def zero_exposed_comm_bytes(grad_bytes: int, param_bytes: int, level: int,
                            d: int, overlap: bool = False,
                            bucket_mb: float = DEFAULT_BUCKET_MB) -> int:
    """Analytic critical-path wire bytes per step (the sum of the rows'
    exposure)."""
    return int(sum(r["exposed_bytes"]
                   for r in zero_comm_rows(grad_bytes, param_bytes, level,
                                           d, overlap, bucket_mb)))
