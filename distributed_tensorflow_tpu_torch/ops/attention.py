"""Attention ops: dense multi-head attention, single-device flash
(blockwise) attention and ring attention over a model group.

The counterpart of ``distributed_tensorflow_tpu/ops/attention.py``'s
``multi_head_attention``, ``_online_softmax_step``, ``_flash_bwd_block``,
``blockwise_attention`` and ``ring_attention``. Tensors are (B, S, H,
Dh) at the public functions. The blockwise form is a
``torch.autograd.Function`` whose forward streams key/value blocks
through the online-softmax recurrence and saves only (q, k, v, o,
logsumexp); its backward recomputes each
block's probability panel from them (the flash backward), so neither
pass holds more than one (B, H, Sq, block) panel. As in the JAX package
the recurrence runs in float32 whatever the input dtype, and causal
blocks above the diagonal still run and contribute exact zeros.

Ring attention (sequence parallelism, ``parallel/sequence_parallel.py``)
runs the same per-block math with the key/value blocks travelling round
the model group (``parallel/mesh.ring_shift``) instead of being sliced
from a local tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.parallel.mesh import ring_shift


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


def _ring_forward(q, k, v, mesh, causal: bool):
    """The forward ring: (out BQHD in q's dtype, o float32 BHQD,
    logsumexp BHQ). Step t holds the key/value block of shard (me - t)
    mod P; the local block comes first, so the causal running max is
    finite from step one and a block wholly above the diagonal adds
    exact zeros; its causal mask compares global positions, key block
    ``owner`` against the queries' ``rows``. The next block is asked for
    before this one is used (JAX's double-buffered order); P - 1 hops,
    none after the last."""
    ways, me = mesh.model, mesh.model_index
    b, sq, h, dh = q.shape
    scale = _scale(dh)
    qf = q.float()
    rows = me * sq + torch.arange(sq, device=q.device)
    o = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for t in range(ways):
        if t < ways - 1:
            k_nxt, v_nxt = ring_shift(k_cur, mesh), ring_shift(v_cur, mesh)
        mask = (_causal_mask((me - t) % ways, k_cur.shape[1], rows)
                if causal else None)
        o, m, l = _online_softmax_step(qf, scale, o, m, l, k_cur, v_cur,
                                       mask)
        if t < ways - 1:
            k_cur, v_cur = k_nxt, v_nxt
    o = o / l[..., None]
    lse = m + torch.log(l)
    return o.permute(0, 2, 1, 3).to(q.dtype), o, lse


class _Ring(torch.autograd.Function):
    """Ring attention with the distributed flash backward (the JAX
    package's ``_ring`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        out, o, lse = _ring_forward(q, k, v, mesh, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, g):
        """P steps, attend then rotate: step t recomputes the panel of
        the block of shard (me - t) mod P from the saved logsumexp,
        adds to dq here, and sends the block on with its float32 dk/dv
        accumulators, so after the P-th hop every block is home with
        every shard's share of its gradient."""
        q, k, v, o, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        ways, me = mesh.model, mesh.model_index
        b, sq, h, dh = q.shape
        scale = _scale(dh)
        qf = q.float()
        gf = g.float().permute(0, 2, 1, 3)
        rows = me * sq + torch.arange(sq, device=q.device)
        dD = (gf * o).sum(dim=-1)  # (B, H, Sq)
        dq = torch.zeros((b, sq, h, dh), dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for t in range(ways):
            mask = (_causal_mask((me - t) % ways, k_cur.shape[1], rows)
                    if causal else None)
            k_nxt, v_nxt = ring_shift(k_cur, mesh), ring_shift(v_cur, mesh)
            dq_c, dk_blk, dv_blk = _flash_bwd_block(
                qf, gf, dD, lse, scale, k_cur, v_cur, mask)
            dq = dq + dq_c
            dk = ring_shift(dk + dk_blk, mesh)
            dv = ring_shift(dv + dv_blk, mesh)
            k_cur, v_cur = k_nxt, v_nxt
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q, k, v, mesh, causal: bool = False):
    """Attention over a sequence split into P blocks along ``mesh``'s
    model group (``parallel/mesh.GridMesh``): q, k, v are this rank's
    blocks (B, S/P, H, Dh), the block of model index i holding tokens
    i * S/P to (i + 1) * S/P. Equals dense attention over the whole
    sequence, this rank's rows of it.

    Forward: the key/value blocks travel round the group in P - 1 hops
    of ``ring_shift`` while the queries stay, each folded into the
    online-softmax accumulators in float32 (the blocks travel in their
    own dtype). Backward: only (q, k, v, o, logsumexp) are saved; the
    blocks go round again, P hops, each carrying its float32 dk/dv
    accumulators home. ``causal`` masks by global position, key
    ``owner * S/P + j`` against query ``i_rank * S/P + i``. Every rank of
    the group must call it together."""
    return _Ring.apply(q, k, v, mesh, bool(causal))
