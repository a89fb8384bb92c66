"""Data augmentation on the device, inside the train step.

The counterpart of ``distributed_tensorflow_tpu/ops/augment.py``
(``random_crop_flip``, ``make_augment``): the standard CIFAR recipe,
zero-pad by ``pad``, crop each example back to its size at its own
offset in ``[0, 2 * pad]``, and flip half the examples horizontally. It
runs on the batch's device, in the host-fed step and in the
device-resident step (where a CUDA graph replays it), so no host work is
added per step.

It comes in two parts: ``draw_crop_flip`` takes the offsets and flips
from an explicit ``torch.Generator`` (static shapes, so a graph can
replay it), and ``apply_crop_flip`` is a pure gather, with ``torch.flip``
for the flip, so it can be held to the JAX package's transform on the
offsets JAX draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def draw_crop_flip(batch: int, pad: int, flip: bool,
                   generator: torch.Generator, device=None):
    """(offsets int64 [batch, 2] in [0, 2 * pad], flips bool [batch] or
    None), drawn from ``generator`` on ``device``."""
    offsets = torch.randint(0, 2 * pad + 1, (batch, 2), generator=generator,
                            device=device)
    flips = (torch.rand(batch, generator=generator, device=device) < 0.5
             if flip else None)
    return offsets, flips


def apply_crop_flip(images, offsets, flips, pad: int):
    """``images`` [B, H, W, C] of any dtype, zero-padded by ``pad``,
    cropped back to H x W at each example's (row, col) ``offsets`` and,
    where ``flips`` is set, mirrored along W. Same shape and dtype."""
    b, h, w, _ = images.shape
    padded = F.pad(images, (0, 0, pad, pad, pad, pad))
    rows = offsets[:, 0, None] + torch.arange(h, device=images.device)
    cols = offsets[:, 1, None] + torch.arange(w, device=images.device)
    bidx = torch.arange(b, device=images.device)[:, None, None]
    out = padded[bidx, rows[:, :, None], cols[:, None, :]]
    if flips is not None:
        out = torch.where(flips[:, None, None, None],
                          torch.flip(out, dims=[2]), out)
    return out


def random_crop_flip(images, generator: torch.Generator, *, pad: int = 4,
                     flip: bool = True):
    """Per-example random crop (after zero-padding) and horizontal flip of
    ``images`` [B, H, W, C], drawn from ``generator``."""
    offsets, flips = draw_crop_flip(images.shape[0], pad, flip, generator,
                                    images.device)
    return apply_crop_flip(images, offsets, flips, pad)


def make_augment(meta: dict, *, pad: int = 4, flip: bool = True):
    """(flat [B, H*W*C] or NHWC images, generator) -> augmented images in
    the same layout: the image geometry comes from the dataset's
    ``meta``."""
    h = w = meta["image_size"]
    c = meta["channels"]

    def augment(x, generator):
        imgs = x.reshape(-1, h, w, c) if x.dim() == 2 else x
        imgs = random_crop_flip(imgs, generator, pad=pad, flip=flip)
        return imgs.reshape(x.shape)

    return augment
