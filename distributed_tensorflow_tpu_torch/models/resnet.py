"""The CIFAR ResNet as a PyTorch ``nn.Module``, with batch-norm state.

The counterpart of ``distributed_tensorflow_tpu/models/resnet.py``
(BASELINE.md config 4). Classic CIFAR ResNet (He et al. 2015 §4.2): a
3x3 stem, 3 stages of n basic blocks at widths 16/32/64, stride 2 at the
first block of stages 1 and 2, 1x1 projection shortcuts with their own
batch norm, a global mean pool and a dense head; depth 6n+2, so n=3 is
ResNet-20 (272,474 parameters) and n=5 ResNet-32.

The parameters and the batch-norm running stats keep the JAX package's
names: ``stem.conv``, ``stem.bn.{scale,bias}``,
``stage{s}.block{b}.{conv1,bn1,conv2,bn2,proj,proj_bn}``, ``head.{w,b}``,
and the stats ``....{mean,var}``. The stats are buffers, so
``named_parameters`` yields the JAX ``params`` tree and ``named_buffers``
its ``state`` tree (``state_of``). A forward in train mode normalizes by
the batch statistics and writes the new running stats into the buffers
in place, without gradient, so a step replayed from a CUDA graph updates
them too; eval mode normalizes by them.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.registry import register_model
from distributed_tensorflow_tpu_torch.ops import nn as ops


class _Node(nn.Module):
    """A named level of the parameter tree."""


class _BatchNorm(nn.Module):
    """``scale``/``bias`` parameters and ``mean``/``var`` running stats."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, train: bool, momentum: float):
        y, (m, v) = ops.batch_norm(x, self.scale, self.bias, self.mean,
                                   self.var, train=train, momentum=momentum)
        if train:
            with torch.no_grad():
                self.mean.copy_(m)
                self.var.copy_(v)
        return y


def _conv_param(kh: int, kw: int, cin: int, cout: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(kh, kw, cin, cout))


@register_model("resnet")
class ResNet(nn.Module):
    """CIFAR ResNet-(6n+2). ``blocks_per_stage=3`` -> ResNet-20.

    ``compute_dtype=torch.bfloat16`` runs the convs and the head's matmul
    in bf16 with float32 parameters and stats, as the JAX package's
    ``--bf16``."""

    stateful = True

    def __init__(self, blocks_per_stage: int = 3,
                 widths: tuple = (16, 32, 64), num_classes: int = 10,
                 channels: int = 3, image_size: int = 32,
                 compute_dtype: torch.dtype | None = None,
                 bn_momentum: float = 0.9):
        super().__init__()
        self.n = blocks_per_stage
        self.widths = tuple(widths)
        self.num_classes = num_classes
        self.channels = channels
        self.image_size = image_size
        self.compute_dtype = compute_dtype
        self.bn_momentum = bn_momentum
        self.stem = _Node()
        self.stem.conv = _conv_param(3, 3, channels, self.widths[0])
        self.stem.bn = _BatchNorm(self.widths[0])
        cin = self.widths[0]
        for s, width in enumerate(self.widths):
            stage = _Node()
            for b in range(self.n):
                block = _Node()
                block.conv1 = _conv_param(3, 3, cin, width)
                block.bn1 = _BatchNorm(width)
                block.conv2 = _conv_param(3, 3, width, width)
                block.bn2 = _BatchNorm(width)
                if self._stride(s, b) != 1 or cin != width:
                    block.proj = _conv_param(1, 1, cin, width)
                    block.proj_bn = _BatchNorm(width)
                setattr(stage, f"block{b}", block)
                cin = width
            setattr(self, f"stage{s}", stage)
        self.head = _Node()
        self.head.w = nn.Parameter(torch.zeros(self.widths[-1], num_classes))
        self.head.b = nn.Parameter(torch.zeros(num_classes))

    @staticmethod
    def _stride(stage: int, block: int) -> int:
        return 2 if stage > 0 and block == 0 else 1

    def _blocks(self):
        for s in range(len(self.widths)):
            for b in range(self.n):
                stage = getattr(self, f"stage{s}")
                yield self._stride(s, b), getattr(stage, f"block{b}")

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "ResNet":
        """The JAX package's init: He-normal convs (std sqrt(2 / fan_in),
        fan_in = kh * kw * cin), a zero head, batch norms at scale 1,
        bias 0, mean 0, var 1. Draws on the CPU generator's device, so
        call it before moving the module."""
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[0] * p.shape[1] * p.shape[2]
                p.copy_(torch.randn(p.shape, generator=generator)
                        * (2.0 / fan_in) ** 0.5)
            elif name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, t in self.named_buffers():
            t.fill_(1.0 if name.endswith(".var") else 0.0)
        return self

    def _conv(self, x, w, stride: int = 1):
        return ops.conv(x, w, stride, compute_dtype=self.compute_dtype)

    def forward(self, x, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None,
                train: bool = False):
        """Forward pass -> float32 logits [B, num_classes]. Train mode
        also moves the running stats, in place. ``keep_prob`` and
        ``generator`` are accepted for the models' common signature; the
        ResNet has no dropout."""
        mom = self.bn_momentum
        x = ops.normalize_if_u8(x, self.compute_dtype)
        x = x.reshape(-1, self.image_size, self.image_size, self.channels)
        h = self._conv(x, self.stem.conv)
        h = torch.relu(self.stem.bn(h, train, mom))
        for stride, bp in self._blocks():
            y = self._conv(h, bp.conv1, stride)
            y = torch.relu(bp.bn1(y, train, mom))
            y = self._conv(y, bp.conv2)
            y = bp.bn2(y, train, mom)
            if hasattr(bp, "proj"):
                sc = bp.proj_bn(self._conv(h, bp.proj, stride), train, mom)
            else:
                sc = h
            h = torch.relu(y + sc)
        h = h.mean(dim=(1, 2))  # global average pool
        return ops.dense(h, self.head.w, self.head.b,
                         compute_dtype=self.compute_dtype)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@register_model("resnet20")
class ResNet20(ResNet):
    def __init__(self, **kw):
        kw.setdefault("blocks_per_stage", 3)
        super().__init__(**kw)


@register_model("resnet32")
class ResNet32(ResNet):
    def __init__(self, **kw):
        kw.setdefault("blocks_per_stage", 5)
        super().__init__(**kw)
