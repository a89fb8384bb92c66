"""Parallelism: the data mesh, synchronous data parallelism on
``torch.distributed``, and the asynchronous parameter-server topology."""

from distributed_tensorflow_tpu_torch.parallel.data_parallel import (  # noqa: F401
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
