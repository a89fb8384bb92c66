"""Neural-net ops of the ported models, in PyTorch.

The counterpart of ``distributed_tensorflow_tpu/ops/nn.py`` (``conv2d``,
``maxpool2d``, ``dense``, ``normalize_if_u8``, ``dropout``,
``softmax_cross_entropy``, ``accuracy``, ``batch_norm``), plus ``conv``,
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


def dropout(x, keep_prob, generator=None, *, deterministic: bool = False):
    """Inverted dropout. ``deterministic=True`` or no ``generator`` is the
    eval path (identity). ``keep_prob == 0`` zeroes everything."""
    if deterministic or generator is None:
        return x
    mask = torch.rand(x.shape, generator=generator,
                      device=x.device) < keep_prob
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
