"""Parallelism: the mesh (data, or a data x model grid), synchronous data
parallelism on ``torch.distributed``, its ZeRO-sharded form, tensor
parallelism over the grid's model axis, and the asynchronous
parameter-server topology."""

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (  # noqa: F401
    dp_comm_rows,
    local_batch_size,
    make_dp_eval_step,
    make_dp_train_step,
    replicate_state,
)
from distributed_tensorflow_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    GridMesh,
    MeshSpec,
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
from distributed_tensorflow_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    copy_to_model,
    has_tp_specs,
    make_tp_eval_step,
    make_tp_train_step,
    reduce_from_model,
    shard_state_tp,
    stage_batch_tp,
    tp_clip_transform,
    tp_comm_rows,
    tp_param_specs,
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
