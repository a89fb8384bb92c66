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

``make_slot_pools`` and ``make_slot_step`` are the paged form the
continuous scheduler (``serving/continuous.py``) runs: the same step over
``S`` independent slots, each at its own position, against a pool of KV
pages instead of a dense per-row cache.

``generate`` notes its prompt pass and its decode loop to the request
plane as the ``prefill`` and ``decode`` phases of the requests in the
current microbatch.
"""

from __future__ import annotations

import time

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
from distributed_tensorflow_tpu_torch.serving import reqtrace


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


def _decode_tick(module, tok, pos, masked, write_read, cd, root_dh):
    """The body both decode steps share: one token a row through every
    block, attending against a dense ``(B, C, H, Dh)`` view of the cache.

    ``tok`` (B,) int64; ``pos`` the rows' position embeddings, broadcast
    against (B, 1, d); ``masked`` the positions past each row's own,
    broadcast against the (B, H, 1, C) scores. ``write_read(i, k, v)``
    stores block ``i``'s new (k, v) and returns its dense view: the
    whole-batch cache itself, or the slot step's gather of its pages.
    Returns the logits (B, V) in float32."""
    h = F.embedding(tok[:, None], module.tok)  # (B, 1, d)
    h = h + pos.to(h.dtype)
    if cd is not None:
        h = h.to(cd)
    for i, blk in enumerate(module.blocks):
        y = _layernorm(h, blk.ln1_g, blk.ln1_b)
        q, k, v = _qkv(y, blk)
        k_cache, v_cache = write_read(i, k, v)
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
    return module.logits(h)[:, 0]


def make_decode_step(model):
    """(module, cache, tok (B,) int, t int) -> (logits (B, V) float32,
    cache): one decode tick at absolute position ``t``, the cache updated
    in place."""
    check_decodable(model)
    cd = model.compute_dtype
    capacity = model.seq_len
    root_dh = float(np.sqrt(np.float32(model.d_model // model.num_heads)))

    def step(module, cache, tok, t: int):
        # row t of the causal mask over the full capacity
        masked = torch.arange(capacity, device=tok.device) > t

        def write_read(i, k, v):
            k_cache, v_cache = cache[i]
            k_cache[:, t] = k[:, 0].to(k_cache.dtype)
            v_cache[:, t] = v[:, 0].to(v_cache.dtype)
            return k_cache, v_cache

        logits = _decode_tick(module, tok, module.pos[t:t + 1], masked,
                              write_read, cd, root_dh)
        return logits, cache

    return step


def make_slot_pools(model, page_size: int, num_pages: int,
                    device=None) -> tuple:
    """The paged KV pools of the slot step: a tuple, one ``(k_pool,
    v_pool)`` pair per block, each ``(num_pages + 1, page_size, H, Dh)``
    zeros in the cache dtype (the compute dtype, else float32) on
    ``device``.

    Row 0 is the scratch page: a free slot's page-table row is all zeros,
    so its reads (masked, discarded) and its writes land there and never
    on a live request's pages."""
    check_decodable(model)
    dh = model.d_model // model.num_heads
    dtype = model.compute_dtype or torch.float32
    shape = (num_pages + 1, page_size, model.num_heads, dh)
    return tuple((torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))
                 for _ in range(model.num_blocks))


def make_slot_step(model, page_size: int):
    """(module, pools, page_table (S, P) int32, tok (S,) int32, t (S,)
    int32) -> logits (S, V) float32: one decode tick over ``S``
    independent slots against the paged cache, the pools written in
    place.

    Slot ``i`` feeds token ``tok[i]`` at its own position ``t[i]``;
    ``page_table[i, j]`` is the pool row that holds logical page ``j`` of
    slot ``i`` (0, the scratch page, for free or unmapped entries). The
    step writes the new (k, v) into ``pool[dest, offset]`` with ``dest =
    page_table[i, t // page_size]`` and ``offset = t % page_size``, then
    attends each slot's query against its gathered dense view
    ``pool[page_table].reshape(S, capacity, H, Dh)``. Everything else is
    ``make_decode_step``'s body (``_decode_tick``, shared): the layer
    norm, the fused qkv, row ``t[i]`` of the causal mask over the full
    capacity, the scale after the score product, the float32 softmax,
    the width-2 ``p @ v``, the MLP half, ``ln_f`` and the head. A free
    slot runs the same ops on scratch contents; every score past its
    ``t`` is masked, and the scheduler discards its logits.

    Every shape is static (slots, page table, pools), so the step can be
    captured once into a CUDA graph and replayed however requests come
    and go (``continuous.EngineSlotBackend``)."""
    check_decodable(model)
    cd = model.compute_dtype
    capacity = model.seq_len
    heads = model.num_heads
    dh = model.d_model // heads
    if page_size < 1 or capacity % page_size:
        raise ValueError(
            f"page_size ({page_size}) must be >= 1 and divide the cache "
            f"capacity ({capacity}) so a slot's logical pages tile it "
            f"exactly")
    root_dh = float(np.sqrt(np.float32(dh)))

    def step(module, pools, page_table, tok, t):
        s_count = tok.shape[0]
        t = t.long()
        table = page_table.long()
        # row t[i] of the causal mask per slot over the full capacity
        masked = (torch.arange(capacity, device=tok.device)[None, :]
                  > t[:, None])[:, None, None, :]
        rows = torch.arange(s_count, device=tok.device)
        dest = table[rows, t // page_size]  # (S,) pool rows
        offset = t % page_size

        def write_read(i, k, v):
            k_pool, v_pool = pools[i]
            k_pool[dest, offset] = k[:, 0].to(k_pool.dtype)
            v_pool[dest, offset] = v[:, 0].to(v_pool.dtype)
            return (k_pool[table].reshape(s_count, capacity, heads, dh),
                    v_pool[table].reshape(s_count, capacity, heads, dh))

        return _decode_tick(module, tok.long(), module.pos[t][:, None, :],
                            masked, write_read, cd, root_dh)

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
        # the prompt pass and its first readback are the "prefill" phase,
        # the loop below the "decode" phase with a tick a token
        t0 = time.perf_counter()
        logits_all, cache = prefill_fn(model, torch.from_numpy(padded).to(
            device))
        step_logits = logits_all[:, p - 1].cpu().numpy()
        reqtrace.note_phase("prefill", time.perf_counter() - t0)
        t0 = time.perf_counter()
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
    reqtrace.note_phase("decode", time.perf_counter() - t0, ticks=n)
    return {"tokens": np.concatenate(out_tokens, axis=1)[:b_real],
            "logits": np.stack(out_logits, axis=1)[:b_real]}
