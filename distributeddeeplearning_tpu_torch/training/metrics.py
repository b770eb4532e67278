"""On-device metric accumulation: true epoch means with one host sync.
The port of the JAX package's ``training/metrics.py``.

The train step threads a small accumulator through the epoch: the f32
sums of :data:`METRIC_KEYS`, a step count and the non-finite-loss
counter, all on the device, so the loop materialises ONE tensor an
epoch. Contract (``training/train_step.make_train_step`` returns a
:class:`StepFn`)::

    step(state, batch)          -> (state, metrics)
    step(state, batch, acc)     -> (state, metrics, acc)

In JAX the update is fused into the compiled step. Eager torch pays a
launch per op and the fused ResNet step is host-bound, so the update is
kept to four launches: the accumulator is ONE f32 vector ``[Σloss,
Σaccuracy, Σgrad_norm, count, nonfinite]``, updated in place with one
``torch.stack`` of the step's values and one add. The adds are f32 in
step order, so the finalized mean equals, bit for bit, a host-side f32
running mean of the same per-step values.

With in-step accumulation (``ACCUM_STEPS``) a dispatch still emits ONE
metric sample (the f32 mean over its microbatches, ``grad_norm`` of the
final mean gradient), so the accumulator counts optimizer steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

# Every train step emits exactly these (cross-rank-reduced, f32 scalar)
# metrics; the accumulator is sized from this tuple.
METRIC_KEYS: Tuple[str, ...] = ("loss", "accuracy", "grad_norm")


def init_accumulator(device=None, keys: Tuple[str, ...] = METRIC_KEYS) -> torch.Tensor:
    """A fresh zeroed accumulator on ``device``: ``len(keys)`` sums, the
    step count, then the count of steps whose loss was NaN or Inf (the
    non-finite guard, materialised with the rest at the epoch
    boundary, so detection costs no extra host sync)."""
    return torch.zeros(len(keys) + 2, dtype=torch.float32, device=device)


def accumulate_metrics(acc: torch.Tensor, metrics: Dict[str, torch.Tensor],
                       keys: Tuple[str, ...] = METRIC_KEYS) -> torch.Tensor:
    """One update, in place: ``sums += metrics``, ``count += 1``,
    ``nonfinite += [loss is NaN/Inf]``. Returns ``acc``."""
    loss = metrics["loss"].float()
    one = torch.ones((), dtype=torch.float32, device=acc.device)
    step = torch.stack([metrics[k].float() for k in keys]
                       + [one, (~torch.isfinite(loss)).float()])
    return acc.add_(step)


def finalize_accumulator(acc: torch.Tensor) -> torch.Tensor:
    """Epoch means on the device (the caller owns the one host sync):
    ``[mean_k for k in keys] + [nonfinite_steps]``, the non-finite step
    COUNT last (a count, not a mean: one poisoned step must trip the
    guard even in a long epoch). :func:`accumulator_logs` names them."""
    n = acc.shape[0] - 2
    means = acc[:n] / torch.clamp(acc[n:n + 1], min=1.0)
    return torch.cat([means, acc[n + 1:]])


def accumulator_logs(host_values, keys: Tuple[str, ...] = METRIC_KEYS) -> Dict[str, float]:
    """Name the host copy of :func:`finalize_accumulator`'s tensor."""
    vals = [float(v) for v in host_values.tolist()]
    out = dict(zip(keys, vals))
    out["nonfinite_steps"] = vals[len(keys)]
    return out


class StepFn:
    """The step contract: arity dispatch over one callable
    ``fn(state, batch) -> (state, metrics)``; with ``acc`` the metrics
    are also added to the accumulator after the step. ``accum_steps``
    (the in-step microbatch count) and ``accumulates_metrics`` are
    probed by the loop."""

    accumulates_metrics = True

    def __init__(self, fn: Callable, accum_steps: int = 1):
        self._fn = fn
        self.accum_steps = accum_steps

    def __call__(self, state, batch, acc: Optional[torch.Tensor] = None):
        state, metrics = self._fn(state, batch)
        if acc is None:
            return state, metrics
        return state, metrics, accumulate_metrics(acc, metrics)
