"""Checkpoint save/restore in the JAX package's formats (the monolithic
file and the sharded set, each written and read), and the inspect CLI
(``python -m distributed_tensorflow_tpu_torch.checkpoint.inspect``)."""

from distributed_tensorflow_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointFormatError,
    Checkpointer,
    RestoreReport,
    background_save_from_flags,
    checkpoint_keys,
    latest_checkpoint,
    load_flat,
    load_flat_sharded,
    max_to_keep_from_flags,
    quarantine_step,
    restore_params_with_fallback,
    restore_with_fallback,
    save_checkpoint,
    save_checkpoint_sharded,
)
