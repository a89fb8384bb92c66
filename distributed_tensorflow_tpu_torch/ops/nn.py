"""Neural-net ops of the ported models, in PyTorch.

The counterpart of ``distributed_tensorflow_tpu/ops/nn.py`` (``conv2d``,
``maxpool2d``, ``dense``, ``normalize_if_u8``, ``dropout``,
``softmax_cross_entropy``, ``accuracy``, ``batch_norm`` and the LM's
``streamed_softmax_ce_head``), plus ``conv``,
the bare SAME convolution of ``models/resnet.py``'s ``_conv``. Public
functions keep the reference's layouts: NHWC activations and HWIO conv
kernels. ``conv2d`` hands cuDNN an NCHW view of the NHWC tensor (the
channels-last memory format, so no copy) and an OIHW view of the kernel.

On the card, f32 convolutions run in full f32 only when the caller has
set ``torch.backends.cudnn.allow_tf32 = False`` (cuDNN's default is TF32);
the serving entry point does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF/XLA SAME padding for one spatial dim: (before, after)."""
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, strides: int = 1, *, compute_dtype=None):
    """SAME-padded convolution of NHWC ``x`` with HWIO ``w``, no bias and
    no activation. SAME pads as XLA does: at stride 2 a 3x3 kernel over
    an even size pads (0, 1), not (1, 1). With ``compute_dtype`` the conv
    runs in it and the result is cast back to ``x``'s dtype."""
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pads(x.shape[1], kh, strides)
    left, right = _same_pads(x.shape[2], kw, strides)
    xn = x.permute(0, 3, 1, 2)
    if top or bottom or left or right:
        xn = F.pad(xn, (left, right, top, bottom))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=strides)
    y = y.permute(0, 2, 3, 1)
    return y.to(in_dtype) if compute_dtype is not None else y


def conv2d(x, w, b=None, strides: int = 1, *, compute_dtype=None):
    """SAME-padded conv + bias + ReLU on NHWC ``x`` and HWIO ``w``.

    The dtype chain follows the reference: with ``compute_dtype`` the conv
    runs in it, the result is cast back to ``x``'s dtype, then the bias is
    added and ReLU applied."""
    y = conv(x, w, strides, compute_dtype=compute_dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return torch.relu(y)


def maxpool2d(x, k: int = 2):
    """k x k max-pool, stride k, SAME padding on NHWC ``x``: the end of an
    odd-sized dim is padded with -inf (the dtype's minimum for ints)."""
    n, h, w, c = x.shape
    (top, bottom), (left, right) = _same_pads(h, k, k), _same_pads(w, k, k)
    if top or bottom or left or right:
        fill = (-math.inf if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        x = F.pad(x, (0, 0, left, right, top, bottom), value=fill)
    ho, wo = x.shape[1] // k, x.shape[2] // k
    return x.reshape(n, ho, k, wo, k, c).amax(dim=(2, 4))


def dense(x, w, b=None, *, compute_dtype=None):
    """x @ w + b. With ``compute_dtype`` the matmul runs in that dtype
    (operands and result), then casts back to ``x``'s dtype; the bias is
    added after the cast."""
    if compute_dtype is not None:
        y = (x.to(compute_dtype) @ w.to(compute_dtype)).to(x.dtype)
    else:
        y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def normalize_if_u8(x, compute_dtype=None):
    """uint8 pixels are normalized to [0, 1] in ``compute_dtype`` (float32
    by default); any other dtype passes through."""
    if x.dtype == torch.uint8:
        return x.to(compute_dtype or torch.float32) / 255.0
    return x


def dropout(x, keep_prob, generator=None, *, deterministic: bool = False,
            shard: tuple[int, int] | None = None):
    """Inverted dropout. ``deterministic=True`` or no ``generator`` is the
    eval path (identity). ``keep_prob == 0`` zeroes everything.

    ``shard=(i, n)``: ``x`` is column block ``i`` of ``n`` of a wider
    activation (a tensor-parallel shard). The mask of the full width is
    drawn and block ``i`` kept, so the ranks of a model group, drawing
    from one seed, apply the one-rank run's mask column for column."""
    if deterministic or generator is None:
        return x
    if shard is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        i, n = shard
        w = x.shape[-1]
        u = torch.rand((*x.shape[:-1], w * n), generator=generator,
                       device=x.device)[..., i * w:(i + 1) * w]
    mask = u < keep_prob
    scale = 1.0 / keep_prob if keep_prob > 0 else 0.0
    return torch.where(mask, x * scale, torch.zeros_like(x))


def softmax_cross_entropy(logits, labels):
    """Mean softmax cross-entropy over the batch (the reference cost,
    ``MNISTDist.py:148``), taken in float32.

    ``labels`` are one-hot [B, C] or integer class ids [B]. An id outside
    [0, C) matches no class and contributes zero loss and gradient (the
    JAX package's one-hot semantics); the loaders reject such ids at
    load time."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if labels.dim() == logits.dim() - 1:  # integer class ids
        classes = torch.arange(logp.shape[-1], device=logp.device)
        # where(), not a one-hot multiply: a class with logit -inf has
        # logp -inf, and 0 * -inf would turn the sum into NaN
        hit = classes == labels.unsqueeze(-1).long()
        per_example = -torch.where(hit, logp, torch.zeros_like(logp)).sum(-1)
    else:
        per_example = -(labels.float() * logp).sum(-1)
    return per_example.mean()


class _StreamedCE(torch.autograd.Function):
    """Dense head + softmax cross-entropy + accuracy over row blocks (the
    JAX package's ``_streamed_ce`` custom VJP). The forward keeps each
    row's logsumexp; the backward recomputes each block's logits from
    (h, w, b) and those, so no more than one (block, V) float32 panel
    exists in either pass. dw and db accumulate in float32."""

    @staticmethod
    def forward(ctx, h2, w, b, labels2, block, cd, n_valid):
        n_pad = h2.shape[0]
        inv = float(np.float32(1.0 / n_valid))
        loss_sum = torch.zeros((), dtype=torch.float32, device=h2.device)
        corr_sum = torch.zeros((), dtype=torch.float32, device=h2.device)
        lses = []
        wc = w.to(cd) if cd is not None else w  # cast once, not per block
        for start in range(0, n_pad, block):
            sl = slice(start, start + block)
            # one block's logits as the unstreamed head computes them:
            # the dot in cd, cast back, the bias, then float32
            logits = dense(h2[sl], wc, b, compute_dtype=cd).float()
            lbl = labels2[sl].long()
            vocab = logits.shape[-1]
            m = logits.amax(dim=-1)
            lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            # out-of-range ids: zero loss and zero gradient (the one-hot
            # of such an id is all zeros); accuracy counts them as misses
            ok = (lbl >= 0) & (lbl < vocab)
            lab = logits.gather(1, lbl.clamp(0, vocab - 1)[:, None])[:, 0]
            lab = torch.where(ok, lab, torch.zeros_like(lab))
            rows = torch.arange(start, start + len(lbl), device=h2.device)
            vf = (rows < n_valid).float()
            loss_sum = loss_sum + ((lse - lab) * vf * ok.float()).sum()
            hit = (logits.argmax(dim=-1) == lbl).float()
            corr_sum = corr_sum + (hit * vf).sum()
            lses.append(lse)
        ctx.save_for_backward(h2, w, b, labels2, torch.cat(lses))
        ctx.block, ctx.cd, ctx.n_valid = block, cd, n_valid
        acc = corr_sum * inv
        ctx.mark_non_differentiable(acc)
        return loss_sum * inv, acc

    @staticmethod
    def backward(ctx, g_loss, _g_acc):
        h2, w, b, labels2, lses = ctx.saved_tensors
        block, cd, n_valid = ctx.block, ctx.cd, ctx.n_valid
        n_pad = h2.shape[0]
        scale = g_loss.float() / n_valid
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        dhs = []
        wc = w.to(cd) if cd is not None else w
        for start in range(0, n_pad, block):
            sl = slice(start, start + block)
            h_blk = h2[sl]
            logits = dense(h_blk, wc, b, compute_dtype=cd).float()
            lbl = labels2[sl].long()
            vocab = logits.shape[-1]
            g = torch.exp(logits - lses[sl][:, None])
            ok = (lbl >= 0) & (lbl < vocab)
            rows = torch.arange(len(lbl), device=g.device)
            # softmax - onehot: subtract 1 at an in-range label (an
            # out-of-range row subtracts 0 and is zeroed by ``ok`` below)
            g[rows, lbl.clamp(0, vocab - 1)] -= ok.float()
            valid = (torch.arange(start, start + len(lbl), device=g.device)
                     < n_valid).float()
            g = g * (valid * ok.float() * scale)[:, None]
            if cd is not None:
                gc = g.to(cd)
                dhs.append((gc @ wc.T).to(h2.dtype))
                dw = dw + (h_blk.to(cd).T @ gc).float()
            else:
                dhs.append((g @ w.T).to(h2.dtype))
                dw = dw + h_blk.T @ g
            db = db + g.sum(dim=0)
        return (torch.cat(dhs), dw.to(w.dtype), db.to(b.dtype), None, None,
                None, None)


def streamed_softmax_ce_head(h, w, b, labels, block: int,
                             compute_dtype=None):
    """Fused dense head + softmax cross-entropy + accuracy, streamed over
    row blocks of ``block`` rows so the (..., V) float32 logits never
    exist beyond one (block, V) panel, forward or backward.

    ``h``: (..., d) hidden states; ``labels``: integer ids of ``h``'s
    leading shape; ``w``, ``b``: the head. Values and gradients match
    ``softmax_cross_entropy(dense(h, w, b, compute_dtype=...), labels)``
    and ``accuracy`` to float32 rounding. The rows are zero-padded to a
    multiple of ``block`` and the padding is masked out. Returns (mean
    loss, accuracy), both float32 scalars; the accuracy carries no
    gradient."""
    d = h.shape[-1]
    if tuple(labels.shape) != tuple(h.shape[:-1]):
        raise ValueError(f"labels shape {tuple(labels.shape)} != hidden "
                         f"leading shape {tuple(h.shape[:-1])}")
    n_valid = labels.numel()
    h2 = h.reshape(n_valid, d)
    labels2 = labels.reshape(n_valid)
    pad = (-n_valid) % int(block)
    if pad:
        h2 = torch.cat([h2, h2.new_zeros((pad, d))])
        labels2 = torch.cat([labels2, labels2.new_zeros((pad,))])
    return _StreamedCE.apply(h2, w, b, labels2, int(block), compute_dtype,
                             n_valid)


def accuracy(logits, labels):
    """Minibatch argmax-equality accuracy (``MNISTDist.py:152-153``).
    ``labels``: one-hot [B, C] or integer class ids [B]."""
    pred = logits.argmax(-1)
    true = labels.long() if labels.dim() == logits.dim() - 1 \
        else labels.argmax(-1)
    return (pred == true).float().mean()


def batch_norm(x, scale, bias, running_mean, running_var, *,
               train: bool, momentum: float = 0.9, eps: float = 1e-5):
    """Batch normalization over NHWC ``x``, statistics over N, H and W.

    Returns (y, (new_running_mean, new_running_var)). Train mode
    normalizes by the batch mean and the biased variance (``jnp.var``)
    and moves the running stats as ``momentum * running + (1 - momentum)
    * batch``; the new stats carry no gradient. Eval mode normalizes by
    the running stats and returns them unchanged. Written out rather than
    ``F.batch_norm``, whose running variance is the unbiased one and
    whose momentum is ``1 - momentum``. The dtype chain is the JAX
    package's: a bfloat16 ``x`` has bfloat16 batch stats (reduced in
    float32), and ``* scale`` promotes to ``scale``'s dtype."""
    if train:
        dims = tuple(range(x.dim() - 1))
        # jnp.mean and jnp.var reduce a half type in float32 and round
        # the result back
        xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
        mean = xf.mean(dims)
        var = (xf - mean).square().mean(dims)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        with torch.no_grad():
            new_mean = momentum * running_mean + (1.0 - momentum) * mean
            new_var = momentum * running_var + (1.0 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_mean, new_var = running_mean, running_var
    y = (x - mean) * torch.rsqrt(var + eps) * scale + bias
    return y, (new_mean, new_var)
