"""Switch-style top-1 mixture-of-experts MLP.

The counterpart of ``distributed_tensorflow_tpu/ops/moe.py``
(``moe_capacity``, ``switch_moe``). Routing and dispatch are one-hot
einsums (the Switch Transformer formulation): every shape is static, no
token is gathered by a data-dependent index, and nothing reads a value
back to the host, so a step that runs it can be captured in a CUDA graph
(``training/device_step.py``). The einsums stay ``torch.einsum``: the JAX
package leaves them to XLA and writes no kernel for them.

Routing: per token, a softmax over the E router logits in float32, the
top-1 expert (the first maximum, as ``jnp.argmax``), the chosen
probability as the gate. Capacity C = ceil(cf * T / E) tokens per
expert; a token past its expert's capacity is DROPPED (its MoE output is
zero, the residual stream carries it). Arrival positions come from an
int32 cumsum, exact at any token count. The load-balance term is the
Switch one, E * sum_e(fraction_of_tokens_e * mean_router_prob_e),
minimized at uniform routing; the model adds ``moe_aux`` times it to the
training loss.

Expert parallelism (the JAX package's ``axis_name``, sharded experts and
one ``psum``) is not ported: it needs a model axis on the port's mesh
(ROADMAP queue 1, the model-axis sequence).
"""

from __future__ import annotations

import math

import torch


def moe_capacity(tokens: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert token capacity (>= 1)."""
    return max(1, math.ceil(capacity_factor * tokens / num_experts))


def switch_moe(h, params, *, capacity_factor: float = 1.25,
               axis_name: str | None = None, compute_dtype=None):
    """(B, S, d) -> ((B, S, d), {"lb_loss", "dropped_frac"}).

    ``params``: {"router": (d, E), "w1": (E, d, m), "b1": (E, m), "w2":
    (E, m, d), "b2": (E, d)}. ``lb_loss`` and ``dropped_frac`` are
    float32 scalars on ``h``'s device. With ``compute_dtype`` the
    dispatch, the expert MLPs and the combine run in it, cast where the
    JAX package casts; the router always runs in float32."""
    if axis_name is not None:
        raise NotImplementedError(
            "switch_moe(axis_name=...) (expert parallelism) is not yet "
            "ported to distributed_tensorflow_tpu_torch (ROADMAP queue 1: "
            "the model axis on torch.distributed, then EP)")
    b, s, d = h.shape
    t = b * s
    hf = h.reshape(t, d)
    cd = compute_dtype
    e = params["w1"].shape[0]
    cap = moe_capacity(t, e, capacity_factor)

    logits = hf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                         # (T, E)
    expert = probs.argmax(dim=-1)                                 # (T,)
    gate = probs.amax(dim=-1)                                     # (T,)
    experts = torch.arange(e, device=h.device)
    assign_i = (expert[:, None] == experts).to(torch.int32)
    assign = assign_i.float()
    # 1-based arrival position in the expert's queue, 0 where unassigned
    pos = torch.cumsum(assign_i, dim=0, dtype=torch.int32) * assign_i
    keep = assign * (pos <= cap)
    # jax.nn.one_hot(pos - 1, cap) * keep: one_hot gives a zero row for
    # pos - 1 = -1 (unassigned) and for pos - 1 >= cap (dropped), and
    # keep is 0 on exactly those rows, so the clamped index never lands
    # a 1 there
    slot_idx = (pos - 1).clamp(0, cap - 1).long()
    slot = torch.zeros((t, e, cap), dtype=torch.float32, device=h.device)
    slot.scatter_(2, slot_idx[..., None], keep[..., None])       # (T, E, C)

    f_e = assign.mean(dim=0)
    p_e = probs.mean(dim=0)
    lb_loss = e * torch.sum(f_e * p_e)
    dropped = 1.0 - keep.sum() / assign.sum().clamp_min(1.0)

    w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    if cd is None:
        # the JAX einsums promote the float32 slots with h's dtype
        cd = torch.promote_types(h.dtype, torch.float32)
    xe = torch.einsum("tec,td->ecd", slot.to(cd), hf.to(cd))
    he = torch.relu(torch.einsum("ecd,edm->ecm", xe, w1.to(cd))
                    + b1.to(cd)[:, None, :])
    ye = (torch.einsum("ecm,emd->ecd", he, w2.to(cd))
          + b2.to(cd)[:, None, :])
    comb = (slot * gate[:, None, None]).to(cd)
    y = torch.einsum("tec,ecd->td", comb, ye).to(h.dtype)
    return y.reshape(b, s, d), {"lb_loss": lb_loss, "dropped_frac": dropped}
