"""The transformer families as PyTorch ``nn.Module``s: the causal LM
(``--model lm``) and the row-sequence classifier (``--model
transformer``).

The counterpart of ``distributed_tensorflow_tpu/models/transformer.py``.
The parameters keep the JAX tree's names and layouts, so ``state_dict``
keys map one to one onto its path keys (``blocks.0.qkv`` <->
``blocks/0/qkv``): per pre-LN block ``ln1_g``, ``ln1_b``, ``qkv`` (d, 3,
H, Dh), ``proj`` (H*Dh, d), ``ln2_g``, ``ln2_b``, ``mlp_in`` {w, b} and
``mlp_out`` {w, b}; an MoE block (``moe_experts > 0``) has ``moe``
{``router`` (d, E), ``w1`` (E, d, m), ``b1`` (E, m), ``w2`` (E, m, d),
``b2`` (E, d)} in place of the two MLP layers (``ops/moe.py``). The block
is one set of functions (``_attn_half_kv``, ``_mlp_half``) that the
training forward and the serving decode (``serving/decode.py``) both run.

Tensor parallelism (``model.tp``, ``parallel/tensor_parallel.py``) runs
each block on its rank's heads and MLP columns, with one sum over the
model group after ``proj`` and one after ``mlp_out``; embeddings, layer
norms and the head stay replicated. Sequence parallelism (``seq_axis``,
ring attention) and expert parallelism (``moe_axis``) come with a later
slice and raise here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_tensorflow_tpu_torch.models.registry import register_model
from distributed_tensorflow_tpu_torch.ops import nn as ops
from distributed_tensorflow_tpu_torch.ops.attention import (
    blockwise_attention,
    multi_head_attention,
)
from distributed_tensorflow_tpu_torch.ops.moe import switch_moe
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)


def _layernorm(x, gain, bias, eps: float = 1e-5):
    """Layer norm over the last dim with float32 statistics (the biased
    variance), cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gain + bias).to(x.dtype)


class _Block(nn.Module):
    """One pre-LN block's parameters: the JAX package's ``_block_params``,
    or with ``num_experts`` its ``_moe_block_params`` (the same attention
    half, E experts behind a top-1 router for the MLP)."""

    def __init__(self, d: int, h: int, mlp_dim: int, num_experts: int = 0):
        super().__init__()
        dh = d // h
        self.ln1_g = nn.Parameter(torch.empty(d))
        self.ln1_b = nn.Parameter(torch.empty(d))
        self.qkv = nn.Parameter(torch.empty(d, 3, h, dh))
        self.proj = nn.Parameter(torch.empty(h * dh, d))
        self.ln2_g = nn.Parameter(torch.empty(d))
        self.ln2_b = nn.Parameter(torch.empty(d))
        if num_experts:
            e = num_experts
            self.moe = nn.ParameterDict({
                "router": nn.Parameter(torch.empty(d, e)),
                "w1": nn.Parameter(torch.empty(e, d, mlp_dim)),
                "b1": nn.Parameter(torch.empty(e, mlp_dim)),
                "w2": nn.Parameter(torch.empty(e, mlp_dim, d)),
                "b2": nn.Parameter(torch.empty(e, d))})
        else:
            self.mlp_in = nn.ParameterDict({
                "w": nn.Parameter(torch.empty(d, mlp_dim)),
                "b": nn.Parameter(torch.empty(mlp_dim))})
            self.mlp_out = nn.ParameterDict({
                "w": nn.Parameter(torch.empty(mlp_dim, d)),
                "b": nn.Parameter(torch.empty(d))})

    def _mlp_params(self) -> tuple[list, list]:
        """The MLP half's (matrices, biases), matrices in the JAX
        package's init order."""
        if hasattr(self, "moe"):
            m = self.moe
            return [m["router"], m["w1"], m["w2"]], [m["b1"], m["b2"]]
        return ([self.mlp_in["w"], self.mlp_out["w"]],
                [self.mlp_in["b"], self.mlp_out["b"]])

    @torch.no_grad()
    def init(self, w) -> None:
        """Layer-norm gains 1, biases 0, the matrices from ``w``, in the
        JAX package's order (qkv, proj, then mlp_in, mlp_out or router,
        w1, w2)."""
        matrices, biases = self._mlp_params()
        for p in (self.ln1_g, self.ln2_g):
            p.fill_(1.0)
        for p in (self.ln1_b, self.ln2_b, *biases):
            p.zero_()
        for p in (self.qkv, self.proj, *matrices):
            w(p)


def _qkv(y, blk: _Block):
    """``einsum("bsd,dthe->tbshe", y, qkv)`` as one matmul: (q, k, v),
    each (B, S, H, Dh) in ``y``'s dtype."""
    d, _, h, dh = blk.qkv.shape
    out = (y @ blk.qkv.to(y.dtype).reshape(d, 3 * h * dh)).reshape(
        *y.shape[:-1], 3, h, dh)
    return out[..., 0, :, :], out[..., 1, :, :], out[..., 2, :, :]


def _attn_half_kv(h, blk: _Block, attn_fn, cd, tp=None):
    """LN -> attention -> residual, also handing back this block's (k, v)
    (B, S, H, Dh) in the attention's input dtype: the serving prefill
    keeps them as its KV cache. Returns (h_out, k, v). Under a model
    axis (``tp``, the grid mesh) the block holds its rank's heads: the
    attention runs on them, and the row-split ``proj``'s partial outputs
    sum over the model group."""
    y = _layernorm(h, blk.ln1_g, blk.ln1_b)
    if tp is not None:
        y = copy_to_model(y, tp)
    q, k, v = _qkv(y, blk)
    a = attn_fn(q, k, v)
    a = a.reshape(*a.shape[:2], -1)  # (B, S, H*Dh)
    out = ops.dense(a, blk.proj, compute_dtype=cd)
    if tp is not None:
        out = reduce_from_model(out, tp)
    return h + out, k, v


def _mlp_half(h, blk: _Block, cd, tp=None):
    """LN -> relu MLP -> residual: the block's second half. Under a model
    axis ``mlp_in`` is column-split and ``mlp_out`` row-split: the
    partial outputs sum over the model group, then the bias adds once."""
    y = _layernorm(h, blk.ln2_g, blk.ln2_b)
    if tp is not None:
        y = copy_to_model(y, tp)
    y = torch.relu(ops.dense(y, blk.mlp_in["w"], blk.mlp_in["b"],
                             compute_dtype=cd))
    if tp is None:
        return h + ops.dense(y, blk.mlp_out["w"], blk.mlp_out["b"],
                             compute_dtype=cd)
    out = reduce_from_model(ops.dense(y, blk.mlp_out["w"], compute_dtype=cd),
                            tp)
    return h + (out + blk.mlp_out["b"].to(out.dtype))


def _transformer_block(h, blk: _Block, attn_fn, cd, tp=None):
    """One pre-LN block: LN -> attention -> residual -> LN -> MLP ->
    residual. ``attn_fn(q, k, v)`` picks the attention form."""
    return _mlp_half(_attn_half_kv(h, blk, attn_fn, cd, tp)[0], blk, cd, tp)


def _transformer_block_moe(h, blk: _Block, attn_fn, cd,
                           capacity_factor: float):
    """The MoE block: LN -> attention -> residual -> LN -> Switch MoE ->
    residual. Returns (h, the block's load-balance term)."""
    h = _attn_half_kv(h, blk, attn_fn, cd)[0]
    y = _layernorm(h, blk.ln2_g, blk.ln2_b)
    y, aux = switch_moe(y, blk.moe, capacity_factor=capacity_factor,
                        compute_dtype=cd)
    return h + y, aux["lb_loss"]


def _call_block(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` under autograd its activations are
    recomputed in the backward pass (``torch.utils.checkpoint``). A block
    draws no random numbers (dropout follows the blocks), so the
    checkpoint keeps no RNG state: stashing and restoring it cannot run
    inside a CUDA graph's capture."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _run_blocks(h, blocks, attn_fn, cd, remat: bool, tp=None):
    """The dense blocks in order (``remat`` as in ``_call_block``; under
    ``remat`` a tensor-parallel block's forward collectives run again in
    the backward pass, on every rank of the group alike)."""
    for blk in blocks:
        h = _call_block(_transformer_block, remat, h, blk, attn_fn, cd, tp)
    return h


def _trunc_normal(generator, stddev: float = 0.02):
    """The JAX package's ``truncated_normal_init``: a normal of
    ``stddev`` truncated to +-2 sigma."""
    def w(p):
        nn.init.trunc_normal_(p, mean=0.0, std=stddev, a=-2 * stddev,
                              b=2 * stddev, generator=generator)
    return w


def _tp_of(model):
    """The grid mesh a tensor-parallel model runs over (``model.tp``, set
    by ``make_tp_train_step``/``make_tp_eval_step``), checked
    against the heads the blocks hold, or None."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return None
    if getattr(model, "moe_experts", 0):
        raise NotImplementedError(
            "the MoE LM under a model axis is expert parallelism, not yet "
            "ported to distributed_tensorflow_tpu_torch")
    if model.blocks[0].qkv.shape[2] * tp.model != model.num_heads:
        raise RuntimeError(
            "the model runs tensor-parallel but holds every head: cut the "
            "state to this rank's shards first "
            "(parallel.tensor_parallel.shard_state_tp)")
    return tp


def _refuse_unported(seq_axis, moe_axis=None) -> None:
    if seq_axis is not None:
        raise NotImplementedError(
            "seq_axis (ring attention, sequence parallelism) is not yet "
            "ported to distributed_tensorflow_tpu_torch (ROADMAP queue 1: "
            "the model axis on torch.distributed, then SP)")
    if moe_axis is not None:
        raise NotImplementedError(
            "moe_axis (expert parallelism) is not yet ported to "
            "distributed_tensorflow_tpu_torch (ROADMAP queue 1: the model "
            "axis on torch.distributed, then EP)")


class _TransformerBase(nn.Module):
    """What both families share: the blocks, the final layer norm and the
    head, built as the JAX package lays them out."""

    stateful = False

    def _build(self, d: int, h: int, num_blocks: int, mlp_dim: int,
               out_dim: int, num_experts: int = 0) -> None:
        if d % h:
            raise ValueError(f"d_model={d} % num_heads={h} != 0")
        self.blocks = nn.ModuleList(_Block(d, h, mlp_dim, num_experts)
                                    for _ in range(num_blocks))
        self.ln_f = nn.ParameterDict({
            "g": nn.Parameter(torch.empty(d)),
            "b": nn.Parameter(torch.empty(d))})
        self.head = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(d, out_dim)),
            "b": nn.Parameter(torch.empty(out_dim))})

    @torch.no_grad()
    def _init_shared(self, w) -> None:
        for blk in self.blocks:
            blk.init(w)
        self.ln_f["g"].fill_(1.0)
        self.ln_f["b"].zero_()
        w(self.head["w"])
        self.head["b"].zero_()

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("transformer")
class MiniTransformer(_TransformerBase):
    """Row-sequence transformer classifier: an image is a sequence of its
    rows (MNIST: 28 tokens of 28 pixels), embedded, run through pre-LN
    blocks with dense non-causal attention, mean-pooled, dropped out and
    classified."""

    def __init__(self, image_size: int = 28, channels: int = 1,
                 num_classes: int = 10, d_model: int = 128,
                 num_heads: int = 4, num_blocks: int = 2,
                 mlp_ratio: int = 4,
                 compute_dtype: torch.dtype | None = None,
                 seq_axis: str | None = None, remat: bool = False,
                 **_unused):
        super().__init__()
        _refuse_unported(seq_axis)
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        self.mlp_dim = mlp_ratio * d_model
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.seq_len = image_size  # one token per image row
        self.token_dim = image_size * channels
        self.embed = nn.ParameterDict({
            "w": nn.Parameter(torch.empty(self.token_dim, d_model)),
            "b": nn.Parameter(torch.empty(d_model))})
        self.pos = nn.Parameter(torch.empty(self.seq_len, d_model))
        self._build(d_model, num_heads, num_blocks, self.mlp_dim,
                    num_classes)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None):
        """Matrices from a normal of sigma 0.02 truncated to +-2 sigma,
        biases 0, layer-norm gains 1 (the JAX package's values, not its
        draws). Call before moving the module."""
        w = _trunc_normal(generator)
        w(self.embed["w"])
        self.embed["b"].zero_()
        w(self.pos)
        self._init_shared(w)
        return self

    def forward(self, x, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None,
                train: bool = False):
        """(B, 784 * C) or (B, S, token) images -> float32 logits."""
        cd = self.compute_dtype
        x = ops.normalize_if_u8(x, cd)
        if x.dim() == 2:
            x = x.reshape(-1, self.seq_len, self.token_dim)
        if cd is not None:
            x = x.to(cd)
        h = ops.dense(x, self.embed["w"], self.embed["b"], compute_dtype=cd)
        h = h + self.pos.to(h.dtype)
        h = _run_blocks(h, self.blocks, multi_head_attention, cd,
                        self.remat, _tp_of(self))
        h = _layernorm(h, self.ln_f["g"], self.ln_f["b"])
        pooled = h.sum(dim=1) / torch.tensor(self.seq_len, dtype=h.dtype)
        pooled = ops.dropout(pooled, keep_prob, generator,
                             deterministic=not train)
        logits = ops.dense(pooled, self.head["w"], self.head["b"],
                           compute_dtype=cd)
        return logits.float()


@register_model("lm")
class TransformerLM(_TransformerBase):
    """Causal (next-token) transformer language model: integer ids
    (B, S) -> per-token float32 logits (B, S, V).

    Attention: dense causal (``attn_block=None``, O(S^2) memory) or the
    single-device flash form over key/value blocks of ``attn_block``
    tokens (O(S * block)). ``remat`` recomputes each block in the
    backward pass. ``ce_block`` streams the loss head over row blocks
    (``ops.nn.streamed_softmax_ce_head``): training and evaluation then
    go through ``loss_with_metrics`` and never build the (B, S, V)
    logits; ``forward`` still returns them for generation and
    inspection. ``moe_experts > 0`` makes every block's MLP a top-1
    Switch MoE of that many experts (``ops/moe.py``, capacity factor
    ``moe_capacity``); ``loss_with_metrics`` then reports the blocks'
    summed load-balance term as ``moe_lb`` and adds ``moe_aux`` times it
    to the training loss."""

    def __init__(self, vocab_size: int = 64, seq_len: int = 256,
                 d_model: int = 128, num_heads: int = 4,
                 num_blocks: int = 2, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype | None = None,
                 seq_axis: str | None = None,
                 attn_block: int | None = None, remat: bool = False,
                 ce_block: int | None = None, moe_experts: int = 0,
                 moe_capacity: float = 1.25, moe_aux: float = 0.01,
                 moe_axis: str | None = None, **_unused):
        super().__init__()
        _refuse_unported(seq_axis, moe_axis)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_blocks = num_blocks
        self.mlp_dim = mlp_ratio * d_model
        self.compute_dtype = compute_dtype
        self.attn_block = attn_block
        self.remat = remat
        self.ce_block = ce_block
        self.moe_experts = int(moe_experts)
        self.moe_capacity = float(moe_capacity)
        self.moe_aux = float(moe_aux)
        self.tok = nn.Parameter(torch.empty(vocab_size, d_model))
        self.pos = nn.Parameter(torch.empty(seq_len, d_model))
        self._build(d_model, num_heads, num_blocks, self.mlp_dim,
                    vocab_size, self.moe_experts)

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None):
        """Matrices from a normal of sigma 0.02 truncated to +-2 sigma,
        biases 0, layer-norm gains 1. Call before moving the module."""
        w = _trunc_normal(generator)
        w(self.tok)
        w(self.pos)
        self._init_shared(w)
        return self

    def attention(self, q, k, v):
        """The model's causal attention form."""
        if self.attn_block is not None:
            return blockwise_attention(q, k, v, self.attn_block, causal=True)
        return multi_head_attention(q, k, v, causal=True)

    def embed(self, x):
        """Token plus position embeddings of ids (B, S), in the compute
        dtype."""
        h = F.embedding(x, self.tok)
        h = h + self.pos.to(h.dtype)
        return h if self.compute_dtype is None else h.to(self.compute_dtype)

    def apply_hidden(self, x, *, keep_prob: float = 1.0,
                     generator: torch.Generator | None = None,
                     train: bool = False):
        """The final hidden states (B, S, d): the blocks, ``ln_f`` and
        dropout, everything before the vocab head."""
        return self._hidden_and_aux(x, keep_prob=keep_prob,
                                    generator=generator, train=train)[0]

    def _hidden_and_aux(self, x, *, keep_prob: float = 1.0,
                        generator: torch.Generator | None = None,
                        train: bool = False):
        """(hidden states, the MoE blocks' summed load-balance term, a
        float32 scalar; None for dense blocks)."""
        cd = self.compute_dtype
        h, lb_total = self.embed(x), None
        if self.moe_experts:
            for blk in self.blocks:
                h, lb = _call_block(_transformer_block_moe, self.remat, h,
                                    blk, self.attention, cd,
                                    self.moe_capacity)
                lb_total = lb if lb_total is None else lb_total + lb
        else:
            h = _run_blocks(h, self.blocks, self.attention, cd, self.remat,
                            _tp_of(self))
        h = _layernorm(h, self.ln_f["g"], self.ln_f["b"])
        return (ops.dropout(h, keep_prob, generator,
                            deterministic=not train), lb_total)

    def logits(self, h):
        """The vocab head on hidden states -> float32 logits."""
        return ops.dense(h, self.head["w"], self.head["b"],
                         compute_dtype=self.compute_dtype).float()

    def forward(self, x, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None,
                train: bool = False):
        return self.logits(self.apply_hidden(
            x, keep_prob=keep_prob, generator=generator, train=train))

    @property
    def wants_loss_hook(self) -> bool:
        """True when training and evaluation must route through
        ``loss_with_metrics``: the streamed loss head, the MoE's
        load-balance term, or both."""
        return bool(self.ce_block or self.moe_experts)

    def loss_with_metrics(self, x, y, *, keep_prob: float = 1.0,
                          generator: torch.Generator | None = None,
                          train: bool = False):
        """(loss, {"loss", "accuracy"[, "moe_lb"]}) over next-token
        targets ``y`` (B, S): the streamed head with ``ce_block``, else
        the logits through ``softmax_cross_entropy`` and ``accuracy``.
        With ``moe_experts`` the metrics add the load-balance term
        ``moe_lb``, and the training loss (not the metric, not the eval
        loss) adds ``moe_aux`` times it."""
        h, lb = self._hidden_and_aux(x, keep_prob=keep_prob,
                                     generator=generator, train=train)
        if self.ce_block:
            ce, acc = ops.streamed_softmax_ce_head(
                h, self.head["w"], self.head["b"], y, block=self.ce_block,
                compute_dtype=self.compute_dtype)
        else:
            logits = self.logits(h)
            ce = ops.softmax_cross_entropy(logits, y)
            acc = ops.accuracy(logits, y)
        metrics = {"loss": ce, "accuracy": acc}
        loss = ce
        if self.moe_experts:
            metrics["moe_lb"] = lb
            if train:
                loss = ce + self.moe_aux * lb
        return loss, metrics
