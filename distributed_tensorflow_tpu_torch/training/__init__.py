"""Training: the train state and step, schedules, the device-resident
step, the Supervisor and the local and sync training loops."""

from distributed_tensorflow_tpu_torch.training.schedules import (  # noqa: F401
    get_schedule,
    schedule_from_flags,
)
from distributed_tensorflow_tpu_torch.training.train_state import (  # noqa: F401
    TrainState,
    adam,
    create_train_state,
    get_optimizer,
    make_eval_step,
    make_train_step,
    momentum,
    sgd,
)
