"""Optimizer of the port: ``optax.sgd(schedule, momentum=0.9,
nesterov=False)``, the JAX package's ``create_optimizer`` for
``optimizer="sgd"``.

Per step: ``trace = g + momentum·trace``, ``p += -lr(count)·trace``,
with ``count`` the number of updates before this one. Weight decay is
not applied here: it is L2 on the kernels in the loss
(``train_step.l2_kernel_penalty``), as in the JAX package. ``adamw``
waits for a later slice (``TrainConfig`` raises on it).

``GRAD_ACCUM_STEPS=k`` wraps the optimizer in :class:`MultiSteps`, the
port of ``optax.MultiSteps`` (JAX ``training/optimizer.py:45-76``):
gradients are averaged over k dispatches, the parameters and the
schedule's count move on every k-th, and the running mean lives in the
optimizer state, so it is checkpointed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)`` with the mean of
    the gradients: each call folds ``grads`` into the running mean
    ``acc + (g - acc) / (n + 1)`` (optax's Welford form); the k-th call
    hands the mean to ``inner``, which moves the parameters and its own
    count, and zeroes the mean. The other calls leave the parameters
    and ``inner``'s state as they are."""

    def __init__(self, inner: MomentumSGD, every_k: int) -> None:
        if every_k < 1:
            raise ValueError(f"GRAD_ACCUM_STEPS must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": [torch.zeros_like(p, memory_format=torch.preserve_format)
                        for p in params],
                "inner": self.inner.init(params)}

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict) -> Optional[float]:
        """One micro-step; returns the learning rate when the parameters
        moved, else None."""
        acc = state["acc"]
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(state["mini_step"] + 1))
        torch._foreach_add_(acc, delta)
        if state["mini_step"] < self.every_k - 1:
            state["mini_step"] += 1
            return None
        lr = self.inner.apply(params, acc, state["inner"])
        torch._foreach_zero_(acc)
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return lr


def create_optimizer(config: TrainConfig, steps_per_epoch: int,
                     world_size: Optional[int] = None):
    """``(optimizer, lr_schedule)``, as the JAX package returns
    ``(tx, schedule)``. With ``config.grad_accum_steps = k > 1`` the
    schedule is built in update units (``steps_per_epoch // k`` updates
    an epoch) and the returned one is indexed by dispatches, as JAX's
    (``step // k``)."""
    k = max(config.grad_accum_steps, 1)
    schedule = create_lr_schedule(config, max(steps_per_epoch // k, 1), world_size)
    sgd = MomentumSGD(schedule, config.momentum)
    if k > 1:
        return MultiSteps(sgd, k), (lambda step: schedule(step // k))
    return sgd, schedule
