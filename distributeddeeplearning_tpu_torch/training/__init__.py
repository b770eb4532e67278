"""Data-parallel training of the port: state, schedules, optimizer and
the train step. The loop, metrics accumulator, accumulation, checkpoints
and callbacks come with later slices."""

from distributeddeeplearning_tpu_torch.training.optimizer import MomentumSGD, create_optimizer
from distributeddeeplearning_tpu_torch.training.schedules import create_lr_schedule
from distributeddeeplearning_tpu_torch.training.state import TrainState, create_train_state
from distributeddeeplearning_tpu_torch.training.train_step import (
    cross_entropy_loss,
    l2_kernel_penalty,
    make_train_step,
)

__all__ = [
    "MomentumSGD",
    "TrainState",
    "create_lr_schedule",
    "create_optimizer",
    "create_train_state",
    "cross_entropy_loss",
    "l2_kernel_penalty",
    "make_train_step",
]
