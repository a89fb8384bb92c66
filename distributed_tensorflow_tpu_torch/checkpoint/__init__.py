"""Checkpoint save/restore in the JAX package's monolithic format."""

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointFormatError,
    Checkpointer,
    RestoreReport,
    ShardedCheckpointNotPorted,
    checkpoint_keys,
    latest_checkpoint,
    load_flat,
    max_to_keep_from_flags,
    quarantine_step,
    restore_params_with_fallback,
    restore_with_fallback,
    save_checkpoint,
)
