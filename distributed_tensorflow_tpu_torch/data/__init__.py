"""Data: the procedural offline digit set (numpy only)."""

from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_digits,
)
