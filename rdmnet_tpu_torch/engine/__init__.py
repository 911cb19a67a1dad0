"""Train and eval steps, the Trainer, checkpoints, meters (twin of
``rdmnet_tpu/engine``)."""

from rdmnet_tpu_torch.engine.train_step import (
    TRAIN_STAGES,
    StepProgram,
    TrainState,
    capture_eval_step,
    capture_train_step,
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
    make_value_and_grad,
)
from rdmnet_tpu_torch.engine.trainer import Trainer, batch_to_device

__all__ = ["TRAIN_STAGES", "StepProgram", "TrainState", "Trainer", "batch_to_device",
           "capture_eval_step", "capture_train_step", "create_optimizer", "create_train_state",
           "make_eval_step", "make_train_step", "make_value_and_grad"]
