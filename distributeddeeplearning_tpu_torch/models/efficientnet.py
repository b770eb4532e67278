"""EfficientNet B0-B7 (compound scaling): the port of the JAX package's
``models/efficientnet.py``.

The model takes NHWC images, as the JAX one does, and keeps every
activation in NHWC memory (``channels_last``). Parameters are f32;
compute runs in ``dtype`` (bf16 by default); BatchNorm is the port's
flax-semantics ``BatchNorm2d`` with ``eps=1e-3`` (momentum 0.9, the
flax convention); swish (``nn.swish``, ``x·sigmoid(x)``) is ``F.silu``
in the compute dtype, which saves only its input for the backward; the
logits are f32.

The depthwise convs are ``F.conv2d(groups=mid)`` (cuDNN's grouped
conv), as the JAX model's are ``nn.Conv(feature_group_count=mid)``:
neither model calls its hand-written depthwise kernel
(``ops/depthwise.py``); ``chip_smoke.py`` drives the port's on this
model's layers.

Parity traps, each held against flax in ``tests/test_torch_efficientnet*``:

* flax ``padding="SAME"`` with stride 2 pads ``total // 2`` low and the
  rest high (more at the bottom and right), so a strided conv pads
  explicitly with ``F.pad``; the stem pads ``(1, 1)`` on each side;
* drop-path is one keep mask per sample, scaled by ``1/keep``, only
  where ``stride == 1 and in_c == out_c``, at rate
  ``(1 - survival_prob)·block_idx / total_blocks`` over all stages;
  the head dropout is elementwise. Every mask comes from
  :func:`keep_mask`, drawn from the ``generator`` the training step
  passes;
* squeeze-excite reduces to ``max(1, int(in_c·0.25))`` channels of the
  block's *input*, with two biased 1×1 convs.

Module names follow the flax tree (``stem_conv``, ``stage2_block1.
expand_conv``, ``.dw_conv``, ``.se.reduce``, ``head_bn``, ``head``), so
``convert.efficientnet_params_from_flax`` maps paths one to one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.norm import BatchNorm2d
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

# (width_mult, depth_mult, resolution, dropout)
SCALING = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

# Base (B0) stage config: (expand, channels, layers, stride, kernel)
BASE_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

BN_EPS = 1e-3


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial dim: the total
    ``max((ceil(n/s) - 1)·s + k - n, 0)`` split ``total // 2`` low and
    the rest high."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def keep_mask(shape: Sequence[int], keep: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool keep mask of ``shape``, each entry kept with probability
    ``keep``, drawn from ``generator`` (the global generator when
    ``None``). The model's only source of dropout noise."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            mask_shape: Sequence[int]) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(mask, x / keep, 0)`` with the mask of
    ``mask_shape`` broadcast over ``x`` (``[N, 1, 1, 1]`` is drop-path)."""
    return apply_keep_mask(x, keep_mask(mask_shape, 1.0 - rate, generator, x.device), rate)


def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """``where(mask, x / keep, 0)`` with a mask drawn beforehand by
    :func:`keep_mask` (the blocks that are recomputed under ``REMAT``
    draw theirs before the checkpointed call)."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Conv2d(nn.Module):
    """flax ``nn.Conv`` with ``dtype``: f32 ``weight`` ``[out, in/groups,
    k, k]`` (and ``bias``) cast to the compute dtype per call; ``padding``
    ``"same"`` pads as flax's ``"SAME"``, an int pads that much on each
    side."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, dtype: torch.dtype,
                 groups: int = 1, bias: bool = False, padding="same", device=None) -> None:
        super().__init__()
        self.kernel, self.stride, self.groups = kernel, stride, groups
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in // groups, kernel, kernel,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(c_out, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pad = self.padding
        if pad == "same":
            (top, bottom), (left, right) = (same_pads(n, self.kernel, self.stride)
                                            for n in x.shape[2:])
            if top == bottom and left == right:
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(self.dtype), bias, stride=self.stride, padding=pad,
                        groups=self.groups)


class SqueezeExcite(nn.Module):
    """``x·sigmoid(expand(swish(reduce(mean_hw(x)))))``; the mean in the
    compute dtype, ``reduce`` and ``expand`` 1×1 convs with biases."""

    def __init__(self, c: int, reduced: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.reduce = Conv2d(c, reduced, 1, 1, dtype, bias=True, device=device)
        self.expand = Conv2d(reduced, c, 1, 1, dtype, bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """Expand 1×1 (when ``expand_ratio != 1``) → BN → swish → depthwise
    k×k (the stride) → BN → swish → squeeze-excite → project 1×1 → BN,
    plus drop-path and the residual where the shapes allow."""

    def __init__(self, c_in: int, expand_ratio: int, c_out: int, stride: int, kernel: int,
                 dtype: torch.dtype, drop_rate: float = 0.0, se_ratio: float = 0.25,
                 device=None) -> None:
        super().__init__()
        mid = c_in * expand_ratio
        self.drop_rate = drop_rate
        self.residual = stride == 1 and c_in == c_out
        self.has_expand = expand_ratio != 1
        if self.has_expand:
            self.expand_conv = Conv2d(c_in, mid, 1, 1, dtype, device=device)
            self.expand_bn = BatchNorm2d(mid, dtype, eps=BN_EPS, device=device)
        self.dw_conv = Conv2d(mid, mid, kernel, stride, dtype, groups=mid, device=device)
        self.dw_bn = BatchNorm2d(mid, dtype, eps=BN_EPS, device=device)
        self.has_se = se_ratio > 0
        if self.has_se:
            self.se = SqueezeExcite(mid, max(1, int(c_in * se_ratio)), dtype, device)
        self.project_conv = Conv2d(mid, c_out, 1, 1, dtype, device=device)
        self.project_bn = BatchNorm2d(c_out, dtype, eps=BN_EPS, device=device)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        residual = x
        if self.has_expand:
            x = F.silu(self.expand_bn(self.expand_conv(x)))
        x = F.silu(self.dw_bn(self.dw_conv(x)))
        if self.has_se:
            x = self.se(x)
        x = self.project_bn(self.project_conv(x))
        if self.residual:
            if self.drop_rate > 0 and self.training:
                x = dropout(x, self.drop_rate, generator, (x.shape[0], 1, 1, 1))
            x = x + residual
        return x


class EfficientNet(nn.Module):
    """EfficientNet ``variant`` (``"b0"`` … ``"b7"``) over NHWC images;
    returns f32 ``[N, num_classes]`` logits. In training mode the
    forward draws drop-path and head-dropout masks from ``generator``
    (the train step passes a per-step, per-rank one; see
    :attr:`stochastic`).

    Built with uninitialised parameters on ``device`` (``None`` means
    CUDA, and raises without it): load ``convert.init_efficientnet_params``
    or ``convert.efficientnet_params_from_flax``."""

    # The training forward draws dropout noise: make_train_step passes
    # it a per-step, per-rank generator.
    stochastic = True

    def __init__(self, variant: str = "b4", num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, survival_prob: float = 0.8,
                 device=None) -> None:
        super().__init__()
        if variant not in SCALING:
            raise ValueError(f"variant must be one of {sorted(SCALING)}")
        device = resolve_device(device)
        self.variant, self.num_classes, self.dtype = variant, num_classes, dtype
        width, depth, _, self.dropout_rate = SCALING[variant]
        c = round_filters(32, width)
        self.stem_conv = Conv2d(3, c, 3, 2, dtype, padding=1, device=device)
        self.stem_bn = BatchNorm2d(c, dtype, eps=BN_EPS, device=device)
        total_blocks = sum(round_repeats(r, depth) for _, _, r, _, _ in BASE_STAGES)
        self.block_names = []
        for stage, (expand, channels, repeats, stride, kernel) in enumerate(BASE_STAGES):
            out_c = round_filters(channels, width)
            for i in range(round_repeats(repeats, depth)):
                drop = (1 - survival_prob) * len(self.block_names) / total_blocks
                name = f"stage{stage + 1}_block{i + 1}"
                self.add_module(name, MBConv(c, expand, out_c, stride if i == 0 else 1, kernel,
                                             dtype, drop, device=device))
                self.block_names.append(name)
                c = out_c
        head_c = round_filters(1280, width)
        self.head_conv = Conv2d(c, head_c, 1, 1, dtype, device=device)
        self.head_bn = BatchNorm2d(head_c, dtype, eps=BN_EPS, device=device)
        self.head = nn.Linear(head_c, num_classes, device=device)

    @property
    def default_image_size(self) -> int:
        return SCALING[self.variant][2]

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # NHWC in, channels_last [N, C, H, W] from here on (a view)
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x, generator)
        x = F.silu(self.head_bn(self.head_conv(x)))
        x = x.mean(dim=(2, 3))
        if self.dropout_rate > 0 and self.training:
            x = dropout(x, self.dropout_rate, generator, x.shape)
        x = F.linear(x, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype))
        return x.float()

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The conv and Dense kernels (flax ``kernel`` leaves: every conv,
        the depthwise and squeeze-excite ones included, and the head):
        what the L2 penalty covers; biases and BN scales are exempt."""
        return tuple(p for name, p in self.named_parameters()
                     if name.endswith(".weight") and p.dim() in (2, 4))
