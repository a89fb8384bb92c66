"""Model construction from flags.

The counterpart of ``distributed_tensorflow_tpu/training/loop.py``'s
``build_model_for``; the training loops come with the training slice.
"""

from __future__ import annotations

import torch

from distributed_tensorflow_tpu_torch.models import get_model


def build_model_for(FLAGS, meta: dict):
    """The model the flags describe, for a dataset with ``meta``'s image
    size, channels and classes. Only ``deep_cnn`` is ported."""
    if meta.get("kind") == "lm" or FLAGS.model != "deep_cnn":
        raise NotImplementedError(
            f"--model {FLAGS.model} (dataset kind {meta.get('kind', 'image')})"
            f" is not yet ported to distributed_tensorflow_tpu_torch; only "
            f"deep_cnn is")
    return get_model(
        "deep_cnn",
        image_size=meta["image_size"],
        channels=meta["channels"],
        num_classes=meta["num_classes"],
        compute_dtype=torch.bfloat16 if FLAGS.bf16 else None,
        use_pallas=bool(FLAGS.pallas),
    )
