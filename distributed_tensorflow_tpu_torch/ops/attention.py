"""Attention ops: dense multi-head attention and single-device flash
(blockwise) attention.

The counterpart of ``distributed_tensorflow_tpu/ops/attention.py``'s
``multi_head_attention``, ``_online_softmax_step``, ``_flash_bwd_block``
and ``blockwise_attention``. Tensors are (B, S, H, Dh) at the public
functions. The blockwise form is a ``torch.autograd.Function`` whose
forward streams key/value blocks through the online-softmax recurrence
and saves only (q, k, v, o, logsumexp); its backward recomputes each
block's probability panel from them (the flash backward), so neither
pass holds more than one (B, H, Sq, block) panel. As in the JAX package
the recurrence runs in float32 whatever the input dtype, and causal
blocks above the diagonal still run and contribute exact zeros.

Ring attention (sequence parallelism) comes with
``parallel/sequence_parallel.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def _scale(dh: int) -> float:
    """1 / sqrt(dh) rounded once to float32, as ``1.0 /
    jnp.sqrt(jnp.float32(dh))``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def multi_head_attention(q, k, v, causal: bool = False):
    """Dense multi-head attention: (B, S, H, Dh) -> (B, S, H, Dh).

    The scores are computed in the inputs' dtype, then taken to float32
    for the scale, the mask and the softmax (bf16-safe statistics); the
    probabilities are cast back to ``q``'s dtype before ``p @ v``.
    ``causal`` masks j > i with -inf (the autoregressive form)."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / float(np.sqrt(np.float32(dh)))
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sk, device=s.device)[None, :]
                <= torch.arange(sq, device=s.device)[:, None])
        s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def _causal_mask(t: int, block: int, rows: torch.Tensor):
    """Block ``t``'s (Sq, block) causal mask by absolute position."""
    cols = t * block + torch.arange(block, device=rows.device)
    return cols[None, :] <= rows[:, None]


def _online_softmax_step(qf, scale, o, m, l, k_blk, v_blk, mask):
    """Fold one k/v block into the streaming-softmax accumulators: running
    max ``m``, denominator ``l`` and unnormalized numerator ``o``, all
    float32. ``mask`` broadcasts to (B, H, Sq, block), or is None."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
    if mask is not None:
        s.masked_fill_(~mask, -torch.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                           v_blk.float())
    return o, m_new, l


def _flash_bwd_block(qf, gf, dD, lse, scale, k_blk, v_blk, mask):
    """One k/v block of the flash backward. With p = exp(s - lse) the
    row-exact probabilities recomputed from the saved logsumexp and
    D_i = sum_d(do_i * o_i): dv = p^T do, ds = p * (do @ v^T - D),
    dq += ds @ k * scale, dk = ds^T @ q * scale. Masked entries give
    p = 0 and drop out of every product. Returns (dq contribution BQHD,
    dk block, dv block)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
    if mask is not None:
        s.masked_fill_(~mask, -torch.inf)
    p = torch.exp(s - lse[..., None])
    dv_blk = torch.einsum("bhqk,bhqd->bkhd", p, gf)
    dp = torch.einsum("bhqd,bkhd->bhqk", gf, v_blk.float())
    ds = p * (dp - dD[..., None])
    dq_c = torch.einsum("bhqk,bkhd->bqhd", ds, k_blk.float()) * scale
    dk_blk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq_c, dk_blk, dv_blk


def _blockwise_forward(q, k, v, block: int, causal: bool):
    """The forward scan: (out BQHD in q's dtype, o float32 BHQD,
    logsumexp BHQ)."""
    b, sq, h, dh = q.shape
    n_blocks = k.shape[1] // block
    scale = _scale(dh)
    qf = q.float()
    rows = torch.arange(sq, device=q.device)
    o = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for t in range(n_blocks):
        sl = slice(t * block, (t + 1) * block)
        mask = _causal_mask(t, block, rows) if causal else None
        o, m, l = _online_softmax_step(qf, scale, o, m, l, k[:, sl],
                                       v[:, sl], mask)
    o = o / l[..., None]
    lse = m + torch.log(l)  # p_ij = exp(s_ij - lse_i)
    out = o.permute(0, 2, 1, 3).to(q.dtype)
    return out, o, lse


class _Blockwise(torch.autograd.Function):
    """Flash attention with the recomputing backward (the JAX package's
    ``_blockwise`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, block, causal):
        out, o, lse = _blockwise_forward(q, k, v, block, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.block, ctx.causal = block, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        block, causal = ctx.block, ctx.causal
        b, sq, h, dh = q.shape
        n_blocks = k.shape[1] // block
        scale = _scale(dh)
        qf = q.float()
        gf = g.float().permute(0, 2, 1, 3)
        rows = torch.arange(sq, device=q.device)
        dD = (gf * o).sum(dim=-1)  # (B, H, Sq)
        dq = torch.zeros((b, sq, h, dh), dtype=torch.float32,
                         device=q.device)
        dks, dvs = [], []
        for t in range(n_blocks):
            sl = slice(t * block, (t + 1) * block)
            mask = _causal_mask(t, block, rows) if causal else None
            dq_c, dk_blk, dv_blk = _flash_bwd_block(
                qf, gf, dD, lse, scale, k[:, sl], v[:, sl], mask)
            dq = dq + dq_c
            dks.append(dk_blk)
            dvs.append(dv_blk)
        dk = torch.cat(dks, dim=1)
        dv = torch.cat(dvs, dim=1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def blockwise_attention(q, k, v, block_size: int, causal: bool = False):
    """Single-device flash attention with O(S * block) peak memory in the
    forward and the backward; the same math as ``multi_head_attention``.

    Raises ValueError when the key length does not divide into blocks."""
    sk = k.shape[1]
    if sk % block_size:
        raise ValueError(f"key length {sk} must divide into blocks of "
                         f"{block_size}")
    return _Blockwise.apply(q, k, v, int(block_size), bool(causal))
