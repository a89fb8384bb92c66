"""Model zoo: importing this package registers every ported model."""

from distributed_tensorflow_tpu_torch.models import (  # noqa: F401
    cnn,
    mlp,
    resnet,
)
from distributed_tensorflow_tpu_torch.models.cnn import DeepCNN  # noqa: F401
from distributed_tensorflow_tpu_torch.models.mlp import MLP  # noqa: F401
from distributed_tensorflow_tpu_torch.models.registry import (  # noqa: F401
    available_models,
    get_model,
    register_model,
)
from distributed_tensorflow_tpu_torch.models.resnet import (  # noqa: F401
    ResNet,
    ResNet20,
    ResNet32,
)
