"""BatchNorm with flax semantics (the JAX package's ``models/norm.py``
under the dp engine, i.e. flax ``nn.BatchNorm`` on each replica's batch).

``torch.nn.BatchNorm2d`` differs in three ways, so the port has its own:

* batch statistics are reduced in f32 with the fast variance
  ``max(0, E[x²] - E[x]²)``;
* normalisation is ``(x - μ)·(rsqrt(σ²+eps)·γ) + β`` in f32, cast to
  the compute dtype;
* the running statistics move as ``0.9·r + 0.1·batch`` with the
  **biased** batch variance (torch uses the unbiased one).

``stats_dtype`` other than f32 is flax's ``force_float32_reductions=
False`` (the JAX ResNet's ``stats_dtype``): the batch statistics are
reduced in the compute dtype (each mean summed in f32 and rounded, as
``jnp.mean`` does), ``x - μ`` and ``rsqrt(σ² + eps)`` stay in it, and
the product with γ, β promotes to f32 before the cast; the running
statistics stay f32. In an f32 model it changes nothing.

:meth:`BatchNorm2d.split` is the fused bottleneck's ``_SplitBN``: the
batch moments come from elsewhere (a kernel's epilogue or a plain
pass), and the module owns γ, β and the running-statistics update.

Under the pjit engine (JAX's ``per_replica_bn``, ``:106-161``) each
rank holds its own data shard, so the default, per-replica statistics
are what every BatchNorm computes anyway: the dp engine's. Inside
:func:`sync_bn` (``ALLOW_SYNC_BN=1``) the batch sums (Σx, Σx², the
fused kernels' epilogue sums among them, :func:`reduce_moments`) are
all-reduced over the data group before the normalize, forward and
backward (``collectives.sum_both_ways``): global-batch statistics.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.parallel import collectives

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax convention: the running stats keep 0.9 of themselves

# The data group whose batch sums BatchNorm all-reduces (None: per replica).
_SYNC_GROUP: contextvars.ContextVar = contextvars.ContextVar("sync_bn_group", default=None)


@contextlib.contextmanager
def sync_bn(group):
    """BatchNorm statistics over ``group``'s whole batch inside (sync
    BN); ``None`` keeps them per replica."""
    token = _SYNC_GROUP.set(group)
    try:
        yield
    finally:
        _SYNC_GROUP.reset(token)


def sync_group():
    return _SYNC_GROUP.get()


def reduce_moments(s: torch.Tensor, ss: torch.Tensor, count: int):
    """Mean and fast variance from f32 column sums over ``count`` rows,
    the sums all-reduced over the :func:`sync_bn` group first when one
    is active (the rows of every rank of it)."""
    group = _SYNC_GROUP.get()
    if group is not None:
        both = collectives.sum_both_ways(torch.stack([s, ss]), group)
        s, ss = both[0], both[1]
        count = count * collectives.group_size(group)
    return moments(s, ss, count)


class BatchNorm2d(nn.Module):
    """Per-replica BatchNorm over channel dim 1 of an ``[N, C, H, W]``
    tensor (any memory format). ``zero_init`` starts γ at 0."""

    def __init__(self, features: int, dtype: torch.dtype, zero_init: bool = False,
                 eps: float = BN_EPS, device=None,
                 stats_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        # flax reduces in the compute dtype once f32 is not forced
        self.reduce_dtype = torch.float32 if stats_dtype == torch.float32 else dtype
        self.eps = eps
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """``m·r + (1 - m)·batch``: the batch statistic is scaled in its
        own dtype (flax's weak-typed ``(1 - m)``), then added in f32."""
        m = BN_MOMENTUM
        rest = torch.tensor(1.0 - m, dtype=mean.dtype)
        self.running_mean.copy_(m * self.running_mean + (rest * mean.detach()).float())
        self.running_var.copy_(m * self.running_var + (rest * var.detach()).float())

    def split(self, batch_mean: torch.Tensor, batch_var: torch.Tensor):
        """``(mean, var, γ, β)`` to normalise with: the running stats in
        eval mode, else the given f32 batch moments, which also move
        the running stats (``_SplitBN``)."""
        if not self.training:
            return self.running_mean, self.running_var, self.weight, self.bias
        mean, var = batch_mean.float(), batch_var.float()
        self._update(mean, var)
        return mean, var, self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Training reduces the batch statistics in ``reduce_dtype`` (each
        mean summed in f32, as ``jnp.mean`` does); in f32 the casts are
        no-ops. Eval normalises in f32 with the running statistics."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xr = x.to(self.reduce_dtype)
            if _SYNC_GROUP.get() is not None:
                count = x.numel() // x.shape[1]
                mean, var = reduce_moments(xr.float().sum(axes), (xr * xr).float().sum(axes),
                                           count)
                mean, var = mean.to(xr.dtype), torch.clamp(var, min=0.0).to(xr.dtype)
            else:
                mean = xr.float().mean(axes).to(xr.dtype)
                var = torch.clamp((xr * xr).float().mean(axes).to(xr.dtype) - mean * mean,
                                  min=0.0)
            self._update(mean, var)
        else:
            xr, mean, var = x.float(), self.running_mean, self.running_var
        mul = torch.rsqrt(var + torch.tensor(self.eps, dtype=var.dtype)).float() * self.weight
        y = (xr - mean.reshape(shape)).float() * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


def bn_apply(y: torch.Tensor, mean, var, scale, bias, eps: float, dtype) -> torch.Tensor:
    """The fused block's BN apply on ``[M, C]`` rows (``resnet._bn_apply``):
    ``y·inv + (β - μ·inv)`` in f32 with ``inv = rsqrt(σ²+eps)·γ``."""
    inv = torch.rsqrt(var + eps) * scale
    return (y.float() * inv + (bias - mean * inv)).to(dtype)


def moments(s: torch.Tensor, ss: torch.Tensor, count: int):
    """Mean and fast variance from column sums (``resnet._moments``)."""
    mean = s / count
    return mean, ss / count - mean * mean
