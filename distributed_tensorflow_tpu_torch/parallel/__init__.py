"""Parallelism: the data mesh, synchronous data parallelism on
``torch.distributed``, its ZeRO-sharded form, and the asynchronous
parameter-server topology."""

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (  # noqa: F401
    dp_comm_rows,
    local_batch_size,
    make_dp_eval_step,
    make_dp_train_step,
    replicate_state,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh,
    make_mesh,
)
from distributed_tensorflow_tpu_torch.parallel.ps_emulation import (  # noqa: F401
    MirrorCycle,
    PSClient,
    PSServer,
    assign_shards,
    make_grad_fn,
    ps_comm_rows,
    ps_unsupported_flag_error,
    run_parameter_server,
    run_worker,
)
from distributed_tensorflow_tpu_torch.parallel.zero import (  # noqa: F401
    DEFAULT_BUCKET_MB,
    ZeroState,
    fetch_state_zero,
    make_zero_eval_step,
    make_zero_train_step,
    n_buckets,
    shard_state_zero,
    zero_clip_transform,
    zero_comm_rows,
    zero_exposed_comm_bytes,
    zero_memory_budget,
)
