"""The reference's deep CNN as a PyTorch ``nn.Module``.

The counterpart of ``distributed_tensorflow_tpu/models/cnn.py``:

    reshape [B,784] -> [B,28,28,1]
    conv 5x5x1x32  + bias + relu -> maxpool 2x2  -> [B,14,14,32]
    conv 5x5x32x64 + bias + relu -> maxpool 2x2  -> [B,7,7,64]
    flatten 3136 -> dense 1024 + relu -> dropout -> dense 10 logits

About 3.27 M parameters. The parameters keep the reference's names and
layouts — ``weights`` {wc1, wc2, wd1, out} (HWIO convs, [in, out] dense)
and ``biases`` {bc1, bc2, bd1, out} — so ``state_dict`` keys map one to
one onto the JAX tree's paths (``weights.wd1`` <-> ``weights/wd1``) and
``utils.pytree.params_from_jax`` loads JAX-initialized parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from distributed_tensorflow_tpu_torch.models.registry import register_model
from distributed_tensorflow_tpu_torch.ops import nn as ops
from distributed_tensorflow_tpu_torch.ops.fused_dense import fused_dense_relu
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    reduce_from_model,
)


@register_model("deep_cnn")
class DeepCNN(nn.Module):
    """2 x conv + 2 x dense MNIST classifier (the reference's only model).

    ``compute_dtype=torch.bfloat16`` runs the convs and matmuls in bf16
    with float32 parameters, as the reference's ``--bf16``.
    ``use_pallas=True`` (the ``--pallas`` flag; the name is kept so the
    same command lines work on both packages) runs the ``wd1`` layer
    through the hand-written CUDA kernel ``ops.fused_dense.fused_dense_relu``
    instead of ``relu(dense(...))``.

    Under a model axis (``model.tp``, set by ``make_tp_train_step`` and
    ``make_tp_eval_step``) the module holds its rank's column block of ``wd1``/``bd1``
    and row block of ``out``: ``wd1`` (through the kernel with
    ``use_pallas``) runs on the column shard, each rank keeps its columns
    of the full dropout mask, and the partial ``out`` products sum over
    the model group before the bias is added once.
    """

    def __init__(self, image_size: int = 28, channels: int = 1,
                 num_classes: int = 10, hidden_units: int = 1024,
                 compute_dtype: torch.dtype | None = None,
                 use_pallas: bool = False):
        super().__init__()
        self.image_size = image_size
        self.channels = channels
        self.num_classes = num_classes
        self.hidden_units = hidden_units
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        # two 2x2 stride-2 SAME pools => ceil(size/4)
        self.pooled = math.ceil(math.ceil(image_size / 2) / 2)
        self.flat_dim = self.pooled * self.pooled * 64
        shapes_w = {
            "wc1": (5, 5, channels, 32),
            "wc2": (5, 5, 32, 64),
            "wd1": (self.flat_dim, hidden_units),
            "out": (hidden_units, num_classes),
        }
        shapes_b = {"bc1": (32,), "bc2": (64,), "bd1": (hidden_units,),
                    "out": (num_classes,)}
        self.weights = nn.ParameterDict(
            {k: nn.Parameter(torch.empty(s)) for k, s in shapes_w.items()})
        self.biases = nn.ParameterDict(
            {k: nn.Parameter(torch.empty(s)) for k, s in shapes_b.items()})

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None) -> "DeepCNN":
        """The reference's init: weights from a normal with sigma 0.1
        truncated to +-2 sigma, biases 0.1. Draws on the CPU generator's
        device, so call it before moving the module."""
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
        x = x.reshape(-1, self.image_size, self.image_size, self.channels)

        x = ops.conv2d(x, w["wc1"], b["bc1"], compute_dtype=cd)
        x = ops.maxpool2d(x, k=2)
        x = ops.conv2d(x, w["wc2"], b["bc2"], compute_dtype=cd)
        x = ops.maxpool2d(x, k=2)

        # NHWC flatten: wd1's rows are in (H, W, C) order
        x = x.reshape(-1, self.flat_dim)
        tp = getattr(self, "tp", None)
        if tp is not None:
            x = copy_to_model(x, _check_sharded(self, tp))
        if self.use_pallas:
            if cd is not None:
                x = fused_dense_relu(x.to(cd), w["wd1"].to(cd),
                                     b["bd1"].to(cd)).float()
            else:
                x = fused_dense_relu(x, w["wd1"], b["bd1"])
        else:
            x = torch.relu(ops.dense(x, w["wd1"], b["bd1"], compute_dtype=cd))
        if tp is None:
            x = ops.dropout(x, keep_prob, generator, deterministic=not train)
            return ops.dense(x, w["out"], b["out"], compute_dtype=cd)
        x = ops.dropout(x, keep_prob, generator, deterministic=not train,
                        shard=(tp.model_index, tp.model))
        y = reduce_from_model(ops.dense(x, w["out"], compute_dtype=cd), tp)
        return y + b["out"].to(y.dtype)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


def _check_sharded(model: DeepCNN, mesh):
    """``mesh``, once the module holds its column of wd1: a tensor-parallel
    forward over the full matrix would sum m copies of the output."""
    if model.weights["wd1"].shape[1] * mesh.model != model.hidden_units:
        raise RuntimeError(
            "the model runs tensor-parallel but holds the full wd1: cut "
            "the state to this rank's shards first "
            "(parallel.tensor_parallel.shard_state_tp)")
    return mesh
