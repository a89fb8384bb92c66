"""Parallelism: the data mesh and synchronous data parallelism on
``torch.distributed``."""

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
