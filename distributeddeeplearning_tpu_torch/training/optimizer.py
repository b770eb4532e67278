"""Optimizers of the port, the JAX package's ``create_optimizer``:
``optimizer="sgd"`` is ``optax.sgd(schedule, momentum=0.9,
nesterov=False)`` (:class:`MomentumSGD`), ``optimizer="adamw"`` is
``optax.adamw(schedule, b1, b2, eps, weight_decay, mask=kernels)``
(:class:`AdamW`).

SGD per step: ``trace = g + momentum·trace``, ``p += -lr(count)·trace``,
with ``count`` the number of updates before this one. Its weight decay
is L2 on the kernels in the loss (``train_step.l2_kernel_penalty``), as
in the JAX package. AdamW's decoupled decay (``DECOUPLED_WEIGHT_DECAY``)
is applied in the update to the same kernels (``model.kernel_parameters()``,
handed to :meth:`AdamW.init` as ``decay_mask`` by ``create_train_state``);
pair it with ``weight_decay=0``.

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
replayed graph follows the schedule (AdamW's two bias corrections ride
in device scalars the same way). :meth:`apply` is the two in turn.
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

    def init(self, params: Sequence[torch.Tensor],
             decay_mask: Optional[Sequence[bool]] = None) -> Dict:
        """The state; ``decay_mask`` is ignored (SGD's decay is L2 in
        the loss)."""
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


class AdamW:
    """``optax.adamw(schedule, b1, b2, eps, weight_decay, mask)``, split
    as :class:`MomentumSGD` is. Per update, with ``n = count + 1``::

        mu = b1·mu + (1 - b1)·g          nu = b2·nu + (1 - b2)·g²
        u  = (mu / (1 - b1ⁿ)) / (sqrt(nu / (1 - b2ⁿ)) + eps)
        u += wd·p                         (the masked kernels only)
        p += -lr(count)·u

    The state is optax's ``ScaleByAdamState`` by name: ``count`` (a host
    int), ``mu`` and ``nu`` (f32, one a parameter). :meth:`prepare`
    writes ``-lr`` and both bias corrections ``1 - b1ⁿ``, ``1 - b2ⁿ``
    into device scalars; :meth:`update` reads only those, so a replayed
    graph follows the count. The decay mask is fixed by :meth:`init`
    (``decay_mask``: True for a kernel), as optax's ``mask`` tree."""

    phases = 1

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay_index: Optional[List[int]] = None
        self._scalars: Dict[torch.device, torch.Tensor] = {}

    def init(self, params: Sequence[torch.Tensor],
             decay_mask: Optional[Sequence[bool]] = None) -> Dict:
        """Zero moments; ``decay_mask`` (one bool a parameter) says which
        parameters decay, and is required when ``weight_decay`` is set."""
        if self.weight_decay:
            if decay_mask is None or len(decay_mask) != len(params):
                raise ValueError("decoupled weight decay needs a decay_mask, one bool "
                                 "a parameter (the model's kernel_parameters())")
            self.decay_index = [i for i, m in enumerate(decay_mask) if m]
        zeros = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]
        return {"count": 0, "mu": zeros,
                "nu": [torch.zeros_like(z) for z in zeros]}

    def scalars(self, device) -> torch.Tensor:
        """The f32 device scalars ``[-lr, 1 - b1ⁿ, 1 - b2ⁿ]`` of
        ``device``'s updates (made on first use)."""
        device = torch.device(device)
        t = self._scalars.get(device)
        if t is None:
            t = self._scalars[device] = torch.zeros(3, dtype=torch.float32, device=device)
        return t

    def phase(self, state: Dict) -> int:
        return 0

    @torch.no_grad()
    def prepare(self, state: Dict) -> float:
        """The host part: the rate at ``count`` and the bias corrections
        at ``count + 1`` into the device scalars (three ``fill_``, no
        sync), ``count`` advanced. Returns the rate."""
        lr = self.schedule(state["count"])
        n = state["count"] + 1
        s = self.scalars(state["mu"][0].device)
        s[0].fill_(-lr)
        s[1].fill_(1.0 - self.b1 ** n)
        s[2].fill_(1.0 - self.b2 ** n)
        state["count"] = n
        return lr

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
               token=None) -> None:
        """The device part, one fused ``_foreach`` pass a stage."""
        mu, nu = state["mu"], state["nu"]
        s = self.scalars(mu[0].device)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        den = torch._foreach_div(nu, s[2])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(mu, s[1])
        torch._foreach_div_(u, den)
        if self.weight_decay:
            idx = self.decay_index
            torch._foreach_add_([u[i] for i in idx], [params[i] for i in idx],
                                alpha=self.weight_decay)
        torch._foreach_mul_(u, s[0])
        torch._foreach_add_(params, u)

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

    def __init__(self, inner, every_k: int) -> None:
        if every_k < 1:
            raise ValueError(f"GRAD_ACCUM_STEPS must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k
        self.phases = every_k

    def init(self, params: Sequence[torch.Tensor],
             decay_mask: Optional[Sequence[bool]] = None) -> Dict:
        return {"mini_step": 0, "gradient_step": 0,
                "acc": [torch.zeros_like(p, memory_format=torch.preserve_format)
                        for p in params],
                "inner": self.inner.init(params, decay_mask)}

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
    (``step // k``). ``config.optimizer`` is ``"sgd"`` or ``"adamw"``."""
    k = max(config.grad_accum_steps, 1)
    schedule = create_lr_schedule(config, max(steps_per_epoch // k, 1), world_size)
    if config.optimizer == "sgd":
        tx = MomentumSGD(schedule, config.momentum)
    elif config.optimizer == "adamw":
        tx = AdamW(schedule, config.adam_beta1, config.adam_beta2, config.adam_eps,
                   config.decoupled_weight_decay)
    else:
        raise ValueError(f"unknown optimizer {config.optimizer!r}; use sgd | adamw")
    if k > 1:
        return MultiSteps(tx, k), (lambda step: schedule(step // k))
    return tx, schedule
