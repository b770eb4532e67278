"""BatchNorm with flax semantics (the JAX package's ``models/norm.py``
under the dp engine, i.e. flax ``nn.BatchNorm`` on each replica's batch).

``torch.nn.BatchNorm2d`` differs in three ways, so the port has its own:

* batch statistics are reduced in f32 with the fast variance
  ``max(0, E[x²] - E[x]²)``;
* normalisation is ``(x - μ)·(rsqrt(σ²+eps)·γ) + β`` in f32, cast to
  the compute dtype;
* the running statistics move as ``0.9·r + 0.1·batch`` with the
  **biased** batch variance (torch uses the unbiased one).

:meth:`BatchNorm2d.split` is the fused bottleneck's ``_SplitBN``: the
batch moments come from elsewhere (a kernel's epilogue or a plain
pass), and the module owns γ, β and the running-statistics update. The
grouped per-replica path of the pjit engine waits for that engine.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax convention: the running stats keep 0.9 of themselves


class BatchNorm2d(nn.Module):
    """Per-replica BatchNorm over channel dim 1 of an ``[N, C, H, W]``
    tensor (any memory format). ``zero_init`` starts γ at 0."""

    def __init__(self, features: int, dtype: torch.dtype, zero_init: bool = False,
                 eps: float = BN_EPS, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.detach())
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var.detach())

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
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            self._update(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
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
