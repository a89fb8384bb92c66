"""Serving: checkpoint-to-traffic inference for the predict route and,
for the causal LM, the generate route."""

from distributed_tensorflow_tpu_torch.serving.batcher import (  # noqa: F401
    BatcherStats,
    DynamicBatcher,
    Future,
    RejectedError,
    pow2_bucket,
)
from distributed_tensorflow_tpu_torch.serving.engine import (  # noqa: F401
    CheckpointWatcher,
    InferenceEngine,
    NoCheckpointError,
    resolve_device,
)
from distributed_tensorflow_tpu_torch.serving.server import (  # noqa: F401
    InferenceServer,
    InProcessClient,
    ServingMetrics,
    generate_group_key,
    make_generate_runner,
    make_predict_runner,
    predict_group_key,
)
