"""The single-hidden-layer MLP as a PyTorch ``nn.Module``.

The counterpart of ``distributed_tensorflow_tpu/models/mlp.py``: the
model the reference's ``--hidden_units`` flag was defined for
(``MNISTDist.py:26``, never read there). flatten -> dense(hidden_units)
+ ReLU -> dropout -> dense(num_classes), with the deep CNN's init
(truncated normal sigma 0.1, biases 0.1). The parameters keep the JAX
names: ``weights.{h1,out}``, ``biases.{h1,out}``.
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.registry import register_model
from distributed_tensorflow_tpu_torch.ops import nn as ops


@register_model("mlp")
class MLP(nn.Module):
    def __init__(self, image_size: int = 28, channels: int = 1,
                 num_classes: int = 10, hidden_units: int = 100,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.hidden_units = hidden_units
        self.compute_dtype = compute_dtype
        self.flat_dim = image_size * image_size * channels
        self.weights = nn.ParameterDict({
            "h1": nn.Parameter(torch.empty(self.flat_dim, hidden_units)),
            "out": nn.Parameter(torch.empty(hidden_units, num_classes))})
        self.biases = nn.ParameterDict({
            "h1": nn.Parameter(torch.empty(hidden_units)),
            "out": nn.Parameter(torch.empty(num_classes))})

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "MLP":
        """Weights from a normal with sigma 0.1 truncated to +-2 sigma,
        biases 0.1. Draws on the CPU generator's device, so call it
        before moving the module."""
        for p in self.weights.values():
            nn.init.trunc_normal_(p, mean=0.0, std=0.1, a=-0.2, b=0.2,
                                  generator=generator)
        for p in self.biases.values():
            p.fill_(0.1)
        return self

    def forward(self, x, *, keep_prob: float = 1.0,
                generator: torch.Generator | None = None,
                train: bool = False):
        """Forward pass -> float32 logits [B, num_classes]."""
        w, b = self.weights, self.biases
        cd = self.compute_dtype
        x = ops.normalize_if_u8(x, cd)
        x = x.reshape(-1, self.flat_dim)
        x = torch.relu(ops.dense(x, w["h1"], b["h1"], compute_dtype=cd))
        x = ops.dropout(x, keep_prob, generator, deterministic=not train)
        return ops.dense(x, w["out"], b["out"], compute_dtype=cd)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
