"""Learning-rate schedules: the JAX package's ``training/schedules.py``
as plain functions ``step -> lr`` with optax's semantics.

Base LR × world size; a linear warmup from ``peak / world`` to ``peak``
over ``warmup_epochs``; then ``"step"`` (×0.1 at 30/60/80 epochs, the
boundaries offset by the warmup as ``optax.join_schedules`` passes the
post-warmup schedule ``step - warmup``), ``"cosine"`` (to 0 over
``epochs``) or ``"constant"``. The optimizer evaluates the schedule at
its update count *before* the update, as optax's ``scale_by_schedule``
does (``torch.optim.lr_scheduler`` steps on another convention and is
not used). Values are computed in float32, where optax computes them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

from distributeddeeplearning_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]
_F = np.float32


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """``optax.linear_schedule``."""
    if transition_steps <= 0:
        return lambda count: float(_F(init_value))

    def schedule(count: int) -> float:
        c = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return float(_F(init_value - end_value) * frac + _F(end_value))

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F(value))


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: dict) -> Schedule:
    """``optax.piecewise_constant_schedule``: each scale applies from its
    boundary on (``count >= boundary``)."""

    def schedule(count: int) -> float:
        v = _F(init_value)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v = _F(scale) * v
        return float(v)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = _F(min(count, decay_steps))
        cosine = _F(0.5) * (_F(1) + _F(math.cos(_F(math.pi) * c / _F(decay_steps))))
        return float(_F(init_value) * (_F(1 - alpha) * cosine + _F(alpha)))

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule
    runs on ``step - boundary``."""

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def create_lr_schedule(config: TrainConfig, steps_per_epoch: int,
                       world_size: Optional[int] = None) -> Schedule:
    """Linear warmup into ``config.lr_schedule``; peak LR = base_lr ×
    world_size (the data-parallel width unless given)."""
    if world_size is None:
        world_size = config.data_parallel_width
    peak = config.base_lr * (world_size if config.scale_lr_by_world_size else 1)
    warmup_steps = config.warmup_epochs * steps_per_epoch
    if config.lr_schedule not in ("step", "cosine", "constant"):
        raise ValueError(
            f"unknown lr_schedule {config.lr_schedule!r}; use step | cosine | constant")
    if config.lr_schedule == "cosine":
        total_steps = max(config.epochs * steps_per_epoch, warmup_steps + 1)
        init = peak / max(world_size, 1) if warmup_steps > 0 else peak
        return join_schedules(
            [linear_schedule(init, peak, warmup_steps),
             cosine_decay_schedule(peak, total_steps - warmup_steps, 0.0)],
            [warmup_steps])
    if config.lr_schedule == "constant":
        if warmup_steps <= 0:
            return constant_schedule(peak)
        return join_schedules(
            [linear_schedule(peak / max(world_size, 1), peak, warmup_steps),
             constant_schedule(peak)], [warmup_steps])

    factors = config.lr_decay_factors or (
        (config.lr_decay_factor,) * len(config.lr_decay_epochs))
    if len(factors) != len(config.lr_decay_epochs):
        raise ValueError(
            f"lr_decay_factors {factors} must match lr_decay_epochs "
            f"{config.lr_decay_epochs} in length")

    def decay_boundaries(offset: int):
        return {int(e * steps_per_epoch) - offset: f
                for e, f in zip(config.lr_decay_epochs, factors)
                if int(e * steps_per_epoch) - offset > 0}

    if warmup_steps <= 0:
        return piecewise_constant_schedule(peak, decay_boundaries(0))
    decay = piecewise_constant_schedule(peak, decay_boundaries(warmup_steps))
    warmup = linear_schedule(peak / max(world_size, 1), peak, warmup_steps)
    return join_schedules([warmup, decay], [warmup_steps])
