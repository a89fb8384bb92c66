"""Checkpoint save/restore in the JAX package's monolithic format."""

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointFormatError,
    RestoreReport,
    ShardedCheckpointNotPorted,
    latest_checkpoint,
    load_flat,
    quarantine_step,
    restore_params_with_fallback,
    restore_with_fallback,
    save_checkpoint,
)
