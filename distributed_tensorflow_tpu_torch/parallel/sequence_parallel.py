"""Sequence (context) parallelism: the token axis split over the grid's
"model" axis.

The counterpart of
``distributed_tensorflow_tpu/parallel/sequence_parallel.py``. The batch
splits over the grid's data axis and the sequence over its model axis:
every rank holds one (batch slice, token block) tile and the whole
replicated state. Attention runs as a ring over the model group (the
key/value blocks travel, the queries stay, ``ops/attention``), and the
classifier mean-pools with a sum over the group, so its head sees the
whole sequence. A rank's activations are one token block's, whatever
the length of the sequence: that is what lets long contexts fit.

The JAX package runs the model axis as a ``shard_map`` axis; here each
rank is a process (``parallel/mesh.GridMesh``) and every ``psum``,
``ppermute`` and ``pmean`` over the model axis is a collective on the
rank's model group.

The gradient reduction is the subtle half, and the two loss families
need separate derivations (both land on the SAME uniform mean, for
different reasons):

POOLED CLASSIFIER (MiniTransformer): each sequence shard differentiates
its own replicated copy of the loss, and the pooled sum's backward is
itself a sum over the group (``psum_model``), so per-token parameter
gradients arrive as their true partials scaled by the axis size P,
while the post-pool head's gradients arrive bitwise-replicated. ONE
uniform mean over the model group reduces both exactly (the mean of
P-scaled partials is the total; the mean of replicas is the identity).

PER-TOKEN LOSS (TransformerLM): nothing is replicated. Shard p's local
loss L_p is the mean over ITS OWN (B_local, S/P) tokens, a different
scalar on every shard, and the global loss is L = (1/P) * sum_p L_p
(equal shard sizes make the mean of means the token mean). Each shard
seeds its backward pass with 1.0 on its OWN L_p, so the ranks' backward
passes together compute the gradient of sum_p L_p = P*L. Cross-shard
paths run through the ring's backward: a query on shard q attends keys
shard p produced, and the dk/dv accumulators riding the ring carry that
cotangent back to shard p, so the per-shard gradients g_p are EXACT
partitions of the total: sum_p g_p = d(P*L)/dtheta. The uniform mean
(1/P) * sum_p g_p is then exactly dL/dtheta. What changed from the
pooled case: there the factor P came from the sum's backward P-scaling
every pre-pool cotangent; here it comes from P independent loss seeds.
Same reduction, different proof. The METRICS differ too: pooled metrics
are replicated over the model group (the mean is the identity),
per-token metrics are shard-local means that MUST be averaged over the
group to report the global mean (the step does both unconditionally,
exact in either case).

Then the mean over the data group, as in sync DP, and every rank applies
the same update, so the replicated state stays in step.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (
    pmean,
    pmean_grads_and_metrics,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import MODEL_AXIS
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    _all_reduce_f32,
)
from distributed_tensorflow_tpu_torch.training.train_state import (
    TrainState,
    apply_gradients,
    compute_grads,
    dropout_seed,
    loss_and_metrics,
)


class _PsumModel(torch.autograd.Function):
    """``lax.psum`` over the model axis: the sum over the model group
    forward, and its transpose, the sum of the cotangents, backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


def psum_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over ``mesh``'s model group, summed in float32,
    whose backward is the same sum of the cotangents."""
    return _PsumModel.apply(x, mesh.model_group)


def sp_of(model):
    """The grid a ``seq_axis`` model splits its sequence over (set by
    ``make_sp_train_step``/``make_sp_eval_step``), or None for a model
    without ``seq_axis``."""
    if getattr(model, "seq_axis", None) is None:
        return None
    mesh = getattr(model, "sp", None)
    if mesh is None:
        raise RuntimeError(
            "a seq_axis model runs on its grid's token blocks: build its "
            "step with parallel.sequence_parallel.make_sp_train_step or "
            "make_sp_eval_step")
    return mesh


def _check_sp_model(model, mesh) -> None:
    """Refuse a model without ``seq_axis``, then hand it its grid."""
    if getattr(model, "seq_axis", None) != MODEL_AXIS:
        raise ValueError(
            f"model.seq_axis must be {MODEL_AXIS!r} for the SP step "
            f"(got {getattr(model, 'seq_axis', None)!r})")
    model.sp = mesh


def stage_batch_sp(mesh, batch, per_token_targets: bool = False):
    """This rank's tile of a batch, on its device: the token block of
    model index i (tokens i * S/P to (i + 1) * S/P) of the batch slice
    the rank read. The ranks of a model group read the same batch
    (their data seed is the data index), so the slice needs no staging
    of its own. Targets: one label per example for the pooled classifier,
    or, with ``per_token_targets``, the LM's (B, S) next-token targets
    tiled exactly like the tokens whose logits they score."""
    x, y = batch
    block = x.shape[1] // mesh.model
    cols = slice(mesh.model_index * block, (mesh.model_index + 1) * block)
    x = x[:, cols]
    if per_token_targets:
        y = y[:, cols]
    return tuple(t.to(mesh.device, non_blocking=True).contiguous()
                 for t in (x, y))


def reshape_for_sp(model, x):
    """Flat (B, F) pixels -> (B, S, token) before staging, so the token
    axis exists to split."""
    return x.reshape(-1, model.seq_len, model.token_dim)


def make_sp_train_step(model, optimizer, mesh, keep_prob: float = 1.0,
                       grad_transform=None, accum_steps: int = 1):
    """The sequence-parallel train step: (state, this rank's tile) ->
    (state, metrics).

    ``model`` must be built with ``seq_axis="model"`` (it then
    ring-attends over the model group); the state is replicated. The
    gradients and metrics take ONE uniform mean over the model group
    (exact for every parameter and both loss families: the module
    docstring's two derivations), then one over the data group; then
    ``grad_transform`` (the clip) on the fully reduced gradients, the
    same on every rank, and the update. ``accum_steps`` splits the
    tile's batch slice into microbatches before the reduction. The
    dropout seed mixes in the data index, not the rank: the pooled
    classifier's post-pool mask must be the same on every rank of a
    row (the head's computation is replicated there), and the LM folds
    the model index in itself (its per-token masks differ by shard)."""
    _check_sp_model(model, mesh)

    def step_fn(state: TrainState, batch):
        seed = (dropout_seed(state.rng, state.step, mesh.data_index)
                if keep_prob < 1 else None)
        grads, metrics, model_state = compute_grads(
            model, state.params, batch, keep_prob=keep_prob, rng=seed,
            model_state=state.model_state, accum_steps=accum_steps)
        grads, metrics = pmean_grads_and_metrics(grads, metrics,
                                                 mesh.model_mesh)
        if mesh.data > 1:
            grads, metrics = pmean_grads_and_metrics(grads, metrics,
                                                     mesh.data_mesh)
        opt_state = apply_gradients(optimizer, state, grads, grad_transform)
        return (TrainState(state.params, opt_state, state.step + 1,
                           state.rng, model_state), metrics)

    return step_fn


def make_sp_eval_step(model, mesh):
    """(this rank's tile, model_state) -> metrics, dropout off, averaged
    over the model group (the identity for pooled metrics, the global
    token mean for per-token ones) and then the data group. Every rank
    of the grid calls it together."""
    _check_sp_model(model, mesh)

    @torch.no_grad()
    def eval_fn(batch, model_state=()):
        _, aux = loss_and_metrics(model, batch, train=False,
                                  model_state=model_state)
        metrics = aux["metrics"]
        names = sorted(metrics)
        values = pmean([metrics[k] for k in names], mesh.model_mesh)
        if mesh.data > 1:
            values = pmean(values, mesh.data_mesh)
        return dict(zip(names, values))

    return eval_fn


def sp_comm_rows(kv_block_bytes: int, ways: int,
                 n_attn_layers: int,
                 grad_bytes: int = 0) -> list[dict]:
    """Static per-step ring-attention bytes, per rank: the comm ledger's
    SP rows, hop for hop what ``ops/attention``'s ring sends. Forward:
    each layer runs ``ways - 1`` prefetch hops of 2 blocks (k and v; the
    last block is used where it arrives, no trailing hop). Backward (the
    distributed flash backward): ``ways`` hops of 4 blocks, the k/v
    replay ring PLUS the dk/dv accumulators riding home with their
    blocks (attend-then-rotate, one extra hop, which is exactly what
    delivers each block's gradient to its owner). The online-softmax
    statistics stay local.

    ``grad_bytes`` prices the step's other model-group collective: the
    uniform gradient mean over the token axis (every leaf replicated;
    the module docstring's two derivations), ~2|G| on the wire.

    Every block is priced at ``kv_block_bytes``: under ``--bf16`` the
    dk/dv accumulators travel in float32, twice a bf16 block's bytes."""
    if ways < 2 or n_attn_layers <= 0:
        return []
    fwd = n_attn_layers * (ways - 1) * 2 * kv_block_bytes
    bwd = n_attn_layers * ways * 4 * kv_block_bytes
    rows = [
        {"collective": "ppermute(k/v ring, forward)", "axis": "model",
         "bytes": fwd,
         "note": f"{n_attn_layers} layers x {ways - 1} scan hops x "
                 f"(k+v) blocks"},
        {"collective": "ppermute(k/v ring + dk/dv, backward)",
         "axis": "model", "bytes": bwd,
         "note": f"{n_attn_layers} layers x {ways} hops x "
                 f"(k+v+dk+dv) blocks (flash-VJP replay ring)"},
    ]
    if grad_bytes > 0:
        rows.append({
            "collective": "all_reduce(grads, sequence axis)",
            "axis": "model", "bytes": 2 * grad_bytes,
            "note": "the ONE uniform pmean over the token axis (exact "
                    "for both loss families — module docstring), "
                    "~2|G| all-reduce convention"})
    return rows
