"""Optimizer of the port: ``optax.sgd(schedule, momentum=0.9,
nesterov=False)``, the JAX package's ``create_optimizer`` for
``optimizer="sgd"``.

Per step: ``trace = g + momentum·trace``, ``p += -lr(count)·trace``,
with ``count`` the number of updates before this one. Weight decay is
not applied here: it is L2 on the kernels in the loss
(``train_step.l2_kernel_penalty``), as in the JAX package. ``adamw``
waits for the LM-training slice (``TrainConfig`` raises on it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.training.schedules import Schedule, create_lr_schedule


class MomentumSGD:
    """A functional optimizer like an optax transform: :meth:`init`
    makes the state, :meth:`apply` updates parameters and state in
    place (the port keeps parameters in the model, not in a pytree)."""

    def __init__(self, schedule: Schedule, momentum: float = 0.9) -> None:
        self.schedule = schedule
        self.momentum = momentum

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0,
                "trace": [torch.zeros_like(p, memory_format=torch.preserve_format)
                          for p in params]}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict) -> float:
        """One update; returns the learning rate it used."""
        lr = self.schedule(state["count"])
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, torch._foreach_mul(trace, -lr))
        state["count"] += 1
        return lr


def create_optimizer(config: TrainConfig, steps_per_epoch: int,
                     world_size: Optional[int] = None) -> Tuple[MomentumSGD, Schedule]:
    """``(optimizer, lr_schedule)``, as the JAX package returns
    ``(tx, schedule)``."""
    schedule = create_lr_schedule(config, steps_per_epoch, world_size)
    return MomentumSGD(schedule, config.momentum), schedule
