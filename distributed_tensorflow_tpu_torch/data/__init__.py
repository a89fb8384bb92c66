"""Data: the reference's datasets (IDX files, CIFAR-10 pickles or
procedural sets), the pinned-memory prefetch to the card and the
device-resident split."""

from distributed_tensorflow_tpu_torch.data.datasets import (  # noqa: F401
    DataSet,
    Datasets,
    read_data_sets,
)
from distributed_tensorflow_tpu_torch.data.device_data import (  # noqa: F401
    DeviceData,
    put_device_data,
)
from distributed_tensorflow_tpu_torch.data.pipeline import (  # noqa: F401
    batch_iterator,
    prefetch_to_device,
)
from distributed_tensorflow_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_cifar,
    synthetic_digits,
)
