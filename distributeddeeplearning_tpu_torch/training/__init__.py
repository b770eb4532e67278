"""Data-parallel training of the port: state, schedules, optimizers
(SGD, ``AdamW``; ``MultiSteps`` for ``GRAD_ACCUM_STEPS``), the train and eval steps
(``ACCUM_STEPS`` through ``accum``), the on-device metric accumulator,
checkpoints, callbacks, the dp engine and the loop (``fit``,
``evaluate``)."""

from distributeddeeplearning_tpu_torch.training.optimizer import (
    AdamW,
    MomentumSGD,
    MultiSteps,
    create_optimizer,
)
from distributeddeeplearning_tpu_torch.training.schedules import create_lr_schedule
from distributeddeeplearning_tpu_torch.training.state import TrainState, create_train_state
from distributeddeeplearning_tpu_torch.training.train_step import (
    cross_entropy_loss,
    l2_kernel_penalty,
    make_eval_step,
    sown_aux_loss,
    make_train_step,
)

__all__ = [
    "AdamW",
    "MomentumSGD",
    "MultiSteps",
    "TrainState",
    "create_lr_schedule",
    "create_optimizer",
    "create_train_state",
    "cross_entropy_loss",
    "l2_kernel_penalty",
    "make_eval_step",
    "make_train_step",
    "sown_aux_loss",
]
