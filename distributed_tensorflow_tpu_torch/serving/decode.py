"""Autoregressive decode for ``models/transformer.TransformerLM`` through
a preallocated KV cache on the model's device.

The counterpart of ``distributed_tensorflow_tpu/serving/decode.py``'s
``check_decodable``, ``make_prefill``, ``make_decode_step`` and
``generate``. The prefill runs the model's own ``_attn_half_kv`` and
``_mlp_half`` (the functions the training forward composes) with dense
causal attention over the whole cache capacity (``model.seq_len``),
keeping each block's (k, v). A decode step projects only the newest
token, writes its (k, v) into every block's cache at position ``t`` in
place, and attends its one query against the full capacity with the
positions after ``t`` masked to -inf: the same masked row, shapes
included, as the full forward computes at ``t``. The ``p @ v``
contraction runs at a query width of 2 (the row duplicated, row 0 kept)
and a single sequence is served as a duplicated pair, as in the JAX
package, where a width-1 contraction takes another kernel than the
batched forward. On XLA:CPU this makes a decode row bitwise equal to the
full-prefix forward's; under cuBLAS that is measured, not assumed
(``chip_smoke.py`` phase 12).

The paged slot pools and step of the continuous scheduler
(``make_slot_pools``, ``make_slot_step``) come with
``serving/continuous.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from distributed_tensorflow_tpu_torch.models.transformer import (
    TransformerLM,
    _attn_half_kv,
    _layernorm,
    _mlp_half,
    _qkv,
)
from distributed_tensorflow_tpu_torch.ops import nn as ops
from distributed_tensorflow_tpu_torch.ops.attention import (
    multi_head_attention,
)


def check_decodable(model) -> None:
    """Loud rejection of a model the KV-cache step cannot serve."""
    if not isinstance(model, TransformerLM):
        raise ValueError(f"KV-cache decode serves TransformerLM; got "
                         f"{type(model).__name__}")
    if model.moe_experts:
        raise ValueError("KV-cache decode does not support MoE blocks yet")


def make_prefill(model):
    """(module, tokens (B, C) int) -> (logits (B, C, V) float32, cache).

    ``C`` must be ``model.seq_len``, the cache capacity; tokens past the
    real prompt are padding, causally masked until decode overwrites
    their cache entries. ``cache`` is a list of per-block (k, v), each
    (B, C, H, Dh) in the attention's input dtype. ``module`` is the
    placed copy of ``model`` whose parameters serve."""
    check_decodable(model)
    cd = model.compute_dtype

    def attn(q, k, v):
        return multi_head_attention(q, k, v, causal=True)

    def prefill(module, tokens):
        h = module.embed(tokens)
        cache = []
        for blk in module.blocks:
            h, k, v = _attn_half_kv(h, blk, attn, cd)
            h = _mlp_half(h, blk, cd)
            # own storage: decode writes into it in place
            cache.append((k.clone(memory_format=torch.contiguous_format),
                          v.clone(memory_format=torch.contiguous_format)))
        h = _layernorm(h, module.ln_f["g"], module.ln_f["b"])
        return module.logits(h), cache

    return prefill


def make_decode_step(model):
    """(module, cache, tok (B,) int, t int) -> (logits (B, V) float32,
    cache): one decode tick at absolute position ``t``, the cache updated
    in place."""
    check_decodable(model)
    cd = model.compute_dtype
    capacity = model.seq_len
    root_dh = float(np.sqrt(np.float32(model.d_model // model.num_heads)))

    def step(module, cache, tok, t: int):
        h = F.embedding(tok[:, None], module.tok)  # (B, 1, d)
        h = h + module.pos[t:t + 1].to(h.dtype)
        if cd is not None:
            h = h.to(cd)
        # row t of the causal mask over the full capacity
        masked = torch.arange(capacity, device=h.device) > t
        for blk, (k_cache, v_cache) in zip(module.blocks, cache):
            y = _layernorm(h, blk.ln1_g, blk.ln1_b)
            q, k, v = _qkv(y, blk)
            k_cache[:, t] = k[:, 0].to(k_cache.dtype)
            v_cache[:, t] = v[:, 0].to(v_cache.dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float()
            s = (s / root_dh).masked_fill(masked, -torch.inf)
            p = torch.softmax(s, dim=-1)
            # p @ V at query width 2, row 0 kept (see the module doc)
            p2 = torch.cat([p, p], dim=2).to(q.dtype)
            a = torch.einsum("bhqk,bkhd->bqhd", p2, v_cache)[:, :1]
            a = a.reshape(*a.shape[:2], -1)  # (B, 1, H*Dh)
            h = h + ops.dense(a, blk.proj, compute_dtype=cd)
            h = _mlp_half(h, blk, cd)
        h = _layernorm(h, module.ln_f["g"], module.ln_f["b"])
        return module.logits(h)[:, 0], cache

    return step


def _gumbel_sample(logits: np.ndarray, temperature: float,
                   generator: torch.Generator) -> np.ndarray:
    """One categorical draw per row of softmax(logits / temperature) by
    the Gumbel-max trick, from ``generator`` (a CPU generator, so a seed
    repeats on any device)."""
    scaled = torch.from_numpy(logits).float() / temperature
    u = torch.rand(scaled.shape, generator=generator).clamp_(
        min=torch.finfo(torch.float32).tiny)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1).numpy()


def generate(model, prompts, max_new_tokens: int, *,
             temperature: float = 0.0,
             generator: torch.Generator | None = None,
             prefill_fn=None, step_fn=None) -> dict:
    """Greedy (``temperature == 0``) or temperature-sampled decode with
    ``model``, a placed ``TransformerLM`` whose parameters serve.

    ``prompts``: int array (B, P) with 1 <= P and P + max_new_tokens <=
    model.seq_len (the cache capacity). Returns ``{"tokens": (B, P + N),
    "logits": (B, N, V)}``: ``logits[:, i]`` is the distribution the
    (P + i)'th token was drawn from. A prompt id outside the vocabulary
    is a ValueError (a 400 on the wire), never a clamped embedding.
    Sampling draws from ``generator`` (a fixed seed when None).
    ``prefill_fn``/``step_fn`` are the engine's cached pair; omitted,
    fresh ones are made."""
    check_decodable(model)
    prompts = np.asarray(prompts)
    if prompts.ndim != 2 or prompts.shape[1] < 1:
        raise ValueError(f"prompts must be (B, P>=1); got {prompts.shape}")
    if prompts.size and (prompts.min() < 0
                         or prompts.max() >= model.vocab_size):
        raise ValueError(
            f"prompt ids must be in [0, {model.vocab_size}); got range "
            f"[{prompts.min()}, {prompts.max()}]")
    b, p = prompts.shape
    n = int(max_new_tokens)
    if n < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {n}")
    capacity = model.seq_len
    if p + n > capacity:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({n}) exceeds the model's "
            f"context window / cache capacity ({capacity})")
    prefill_fn = prefill_fn or make_prefill(model)
    step_fn = step_fn or make_decode_step(model)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator().manual_seed(0)

    # one sequence is served as a duplicated pair (see the module doc)
    b_real = b
    if b == 1:
        prompts = np.concatenate([prompts, prompts], axis=0)
        b = 2
    padded = np.zeros((b, capacity), dtype=np.int64)
    padded[:, :p] = prompts
    device = model.tok.device
    out_tokens = [prompts.astype(np.int32)]
    out_logits = []
    with torch.inference_mode():
        logits_all, cache = prefill_fn(model, torch.from_numpy(padded).to(
            device))
        step_logits = logits_all[:, p - 1].cpu().numpy()
        for i in range(n):
            out_logits.append(step_logits)
            if temperature > 0.0:
                tok = _gumbel_sample(step_logits, temperature,
                                     generator).astype(np.int32)
            else:
                tok = step_logits.argmax(axis=-1).astype(np.int32)
            out_tokens.append(tok[:, None])
            if i + 1 < n:
                step_logits, cache = step_fn(
                    model, cache, torch.from_numpy(tok).long().to(device),
                    p + i)
                step_logits = step_logits.cpu().numpy()
    return {"tokens": np.concatenate(out_tokens, axis=1)[:b_real],
            "logits": np.stack(out_logits, axis=1)[:b_real]}
