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

Each update is split at the host/device boundary, so that the device
part can be captured in a CUDA graph (``training/metrics.StepFn``):
:meth:`prepare` does the host part (the schedule's rate at the host
``count``, written into a device scalar with one ``fill_``, and the
counters) and returns a token; :meth:`update` does the device part,
reading the rate from that scalar, never from a host float, so a
replayed graph follows the schedule. :meth:`apply` is the two in turn.
``MultiSteps`` has a host branch (fold, or fold and apply): its token
carries the micro-step, and a captured step keeps one graph for each
micro-step of the k-cycle (:meth:`phase`).
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

    phases = 1

    def __init__(self, schedule: Schedule, momentum: float = 0.9) -> None:
        self.schedule = schedule
        self.momentum = momentum
        self._neg_lr: Dict[torch.device, torch.Tensor] = {}

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0,
                "trace": [torch.zeros_like(p, memory_format=torch.preserve_format)
                          for p in params]}

    def neg_lr(self, device) -> torch.Tensor:
        """The f32 device scalar that holds ``-lr`` for ``device``'s
        updates (one per device, made on first use)."""
        device = torch.device(device)
        t = self._neg_lr.get(device)
        if t is None:
            t = self._neg_lr[device] = torch.zeros((), dtype=torch.float32, device=device)
        return t

    def phase(self, state: Dict) -> int:
        """Which device program the next update runs: always the one."""
        return 0

    @torch.no_grad()
    def prepare(self, state: Dict) -> float:
        """The host part of one update: the rate at ``count`` into the
        device scalar (one ``fill_``, no sync), ``count`` advanced.
        Returns the rate."""
        lr = self.schedule(state["count"])
        self.neg_lr(state["trace"][0].device).fill_(-lr)
        state["count"] += 1
        return lr

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
               token=None) -> None:
        """The device part: ``trace = momentum·trace + g``, ``p += -lr·trace``
        with ``-lr`` read from the device scalar."""
        trace = state["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, torch._foreach_mul(trace, self.neg_lr(trace[0].device)))

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict) -> float:
        """One update; returns the learning rate it used."""
        lr = self.prepare(state)
        self.update(params, grads, state, lr)
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
        self.phases = every_k

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": [torch.zeros_like(p, memory_format=torch.preserve_format)
                        for p in params],
                "inner": self.inner.init(params)}

    def phase(self, state: Dict) -> int:
        """The next call's micro-step: its device program (fold, or at
        ``k - 1`` fold and apply)."""
        return state["mini_step"]

    def prepare(self, state: Dict) -> Tuple[int, Optional[float]]:
        """The host part of one micro-step: ``(micro_step, lr)``, ``lr``
        None unless this call moves the parameters (then the inner
        optimizer's host part ran)."""
        n = state["mini_step"]
        if n < self.every_k - 1:
            state["mini_step"] += 1
            return n, None
        lr = self.inner.prepare(state["inner"])
        state["mini_step"] = 0
        state["gradient_step"] += 1
        return n, lr

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
               token: Tuple[int, Optional[float]]) -> None:
        """The device part of micro-step ``token[0]``."""
        n = token[0]
        acc = state["acc"]
        delta = torch._foreach_sub(grads, acc)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(acc, delta)
        if n == self.every_k - 1:
            self.inner.update(params, acc, state["inner"])
            torch._foreach_zero_(acc)

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Dict) -> Optional[float]:
        """One micro-step; returns the learning rate when the parameters
        moved, else None."""
        token = self.prepare(state)
        self.update(params, grads, state, token)
        return token[1]


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
