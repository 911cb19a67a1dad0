"""Train and eval steps, the Trainer, checkpoints, meters (twin of
``rdmnet_tpu/engine``)."""

from rdmnet_tpu_torch.engine.train_step import (
    TRAIN_STAGES,
    TrainState,
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_value_and_grad,
)
from rdmnet_tpu_torch.engine.trainer import Trainer, batch_to_device

__all__ = ["TRAIN_STAGES", "TrainState", "Trainer", "create_optimizer", "create_train_state",
           "make_eval_step", "make_train_step", "make_value_and_grad", "batch_to_device"]
