"""In-step microbatched gradient accumulation (``ACCUM_STEPS``): the port
of the JAX package's ``training/accum.py``.

``ACCUM_STEPS=k`` splits each dispatch's batch into ``k`` equal
microbatches inside the step: a Python loop runs the forward and
backward once per microbatch, sums the gradients into f32 buffers, and
the optimizer applies the mean gradient ONCE. The effective batch stays
the dispatch's batch while activation memory scales with the
microbatch. ``GRAD_ACCUM_STEPS`` (``training/optimizer.MultiSteps``)
accumulates across k dispatches instead.

Semantics, as in JAX:

* gradients are mean-weighted: each microbatch's loss is its own mean,
  the f32 sum of the k gradients is divided by k, then cast back to
  each parameter's dtype;
* metrics (loss, accuracy) are f32 means over the k microbatches, so
  one dispatch still emits one metric sample;
* BatchNorm models get ghost batch norm: each microbatch normalises
  with its own statistics, and the running statistics fold in
  microbatch order, exactly as k sequential steps would fold them;
* the cross-rank all-reduce runs once, on the mean, after the loop;
* dropout draws per microbatch (the step folds the microbatch index
  into its dropout seed when k > 1).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

# The per-microbatch metric scalars; grad_norm is taken once, on the
# final mean gradient (the norm of THE batch gradient).
MICRO_METRIC_KEYS: Tuple[str, ...] = ("loss", "accuracy")


def resolve_accum_steps(config) -> int:
    """``config.accum_steps`` as a validated positive int."""
    raw = getattr(config, "accum_steps", 1)
    k = int(1 if raw is None else raw)
    if k < 1:
        raise ValueError(f"ACCUM_STEPS must be >= 1, got {k}")
    return k


def validate_accum_config(config, world: int = 1) -> int:
    """``accum_steps`` must divide the per-rank batch
    (``batch_size_per_device``); raises ``ValueError`` naming the three
    numbers. Returns ``k``."""
    k = resolve_accum_steps(config)
    if k == 1:
        return k
    per_shard = config.batch_size_per_device
    if per_shard % k:
        raise ValueError(
            f"ACCUM_STEPS={k} does not divide the per-shard batch: "
            f"global batch {per_shard * world} over {world} data-parallel "
            f"shard(s) leaves {per_shard} samples per shard, which is not "
            f"divisible by accum_steps={k}. Pick ACCUM_STEPS dividing "
            f"{per_shard}, or raise BATCHSIZE.")
    return k


def split_microbatches(tensors: Sequence[torch.Tensor], k: int) -> List[Tuple[torch.Tensor, ...]]:
    """``k`` microbatches of ``tensors`` (each ``[B, ...]``): the j-th is
    every tensor's j-th contiguous ``B // k`` rows (views, no copy), the
    rows k sequential small dispatches would have seen."""
    b = tensors[0].shape[0]
    if b % k:
        raise ValueError(f"cannot split leading dim {b} into {k} microbatches")
    return list(zip(*(t.split(b // k) for t in tensors)))


def accumulate_microbatches(
    micro_fn: Callable[[Tuple[torch.Tensor, ...], int],
                       Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]],
    tensors: Sequence[torch.Tensor],
    k: int,
    grads_like: Sequence[torch.Tensor],
    metric_keys: Tuple[str, ...] = MICRO_METRIC_KEYS,
) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The accumulation loop: ``micro_fn(microbatch, idx) -> (grads,
    metrics)`` computes one microbatch's raw gradients (before any
    cross-rank reduction) and its scalar ``metric_keys``; BatchNorm
    running statistics fold inside it, in order. Gradients accumulate
    in f32 and the mean ``Σ/k`` is cast back to each ``grads_like``
    tensor's dtype; metrics come back as f32 means."""
    gacc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in grads_like]
    macc = {m: None for m in metric_keys}
    for idx, mb in enumerate(split_microbatches(tensors, k)):
        grads, metrics = micro_fn(mb, idx)
        torch._foreach_add_(gacc, [g.float() for g in grads])
        for m in metric_keys:
            v = metrics[m].float()
            macc[m] = v if macc[m] is None else macc[m] + v
    torch._foreach_div_(gacc, float(k))
    grads = [a.to(g.dtype) for a, g in zip(gacc, grads_like)]
    return grads, {m: v / k for m, v in macc.items()}
