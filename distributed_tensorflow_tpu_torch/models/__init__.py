"""Model zoo: importing this package registers every ported model."""

from distributed_tensorflow_tpu_torch.models import cnn  # noqa: F401
from distributed_tensorflow_tpu_torch.models.cnn import DeepCNN  # noqa: F401
from distributed_tensorflow_tpu_torch.models.registry import (  # noqa: F401
    available_models,
    get_model,
    register_model,
)
