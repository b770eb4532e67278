"""ResNet v1 {18, 34, 50, 101, 152, 200}: the port of the JAX package's
``models/resnet.py``.

The model takes NHWC images, as the JAX one does, and keeps every
activation in NHWC memory (``channels_last``): a ``[N, C, H, W]``
tensor whose channels are innermost, so the fused bottleneck sees a
conv activation as a ``[M, C]`` row matrix without a copy. Parameters
are f32; compute runs in ``dtype`` (bf16 by default); BatchNorm keeps
f32 statistics with flax semantics (``models/norm.py``); logits are f32.

The architecture and its parity traps follow the JAX model:

* strided convs pad ``(k-1)//2`` on both sides ("fixed" padding),
  stride-1 convs pad SAME (the same for the odd kernels used here);
* the stem's 3×3/2 max pool pads SAME: ``(0, 1)`` at 112→56, with -inf;
* the bottleneck's stride sits in its 3×3 conv;
* the head is the mean over H, W, a Dense in the compute dtype, f32.

``s2d_stem=True`` is the MLPerf space-to-depth stem: the NHWC images go
through :func:`space_to_depth` (block 2, channel ``(bh·2 + bw)·3 + c``,
the JAX function's order, so a flax ``[4, 4, 12, 64]`` kernel maps to
``[64, 12, 4, 4]`` by the usual transpose) and a 4×4 stride-1 conv
(``stem_conv_s2d``) with SAME padding, 1 low and 2 high, padded before
the conv since ``F.conv2d`` pads symmetrically. ``stats_dtype``
(``torch.bfloat16``) reduces the BatchNorm statistics in the compute
dtype (``models/norm.py``); the fused bottleneck's own statistics stay
f32, as in JAX.

``fused=True`` runs each bottleneck's two 1×1 convs through
``ops/fused_block.py`` (``matmul_stats``: conv1 + BN0 statistics;
``bn_relu_matmul_stats``: BN1-apply → ReLU → conv3 + BN2 statistics),
with the fused and unfused blocks holding the same parameters under the
same names. Module names follow the flax tree (``stage1_block1.Conv_0``,
``BatchNorm_0``, ``proj_conv``, ``stem_conv``, ``head``), so
``convert.resnet_params_from_flax`` maps paths one to one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.norm import (
    BN_EPS,
    BatchNorm2d,
    bn_apply,
    moments,
)
from distributeddeeplearning_tpu_torch.ops.fused_block import (
    bn_relu_matmul_stats,
    matmul_stats,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

# Depth -> (block kind, stage sizes).
STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC ``(N, H, W, C) -> (N, H/b, W/b, C·b²)``, channel
    ``(bh·b + bw)·C + c`` (the JAX package's ``space_to_depth``)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block, c * block * block)


class Conv2d(nn.Module):
    """Bias-free conv with the JAX model's padding; f32 ``weight``
    ``[out, in, k, k]`` cast to the compute dtype per call. A 1×1 conv's
    weight viewed as ``[out, in]`` is the fused kernels' ``w``. Strided
    convs pad ``(k-1)//2`` on both sides; stride 1 pads SAME, which for
    an even kernel is ``(k-1)//2`` low and one more high."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.stride = stride
        low = (kernel - 1) // 2  # fixed for stride > 1, SAME for stride 1
        self.pads = (low, low) if stride > 1 else (low, kernel - 1 - low)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low, high = self.pads
        x = x.to(self.dtype)
        if low != high:
            x, low = F.pad(x, (low, high, low, high)), 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=low)

    def matrix(self) -> torch.Tensor:
        """The 1×1 kernel as ``[out, in]`` in the compute dtype."""
        return self.weight.reshape(self.weight.shape[0], -1).to(self.dtype)


def rows(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N·H·W, C]`` rows in NHWC order (a view for
    a channels_last tensor; a copy otherwise, with the same content)."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def unrows(y: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """The inverse of :func:`rows`: a channels_last ``[N, C, H, W]`` view."""
    return y.reshape(n, h, w, y.shape[1]).permute(0, 3, 1, 2)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), (s, s), "SAME")``: the total padding
    ``max((out-1)·s + k - n, 0)`` goes low = total//2, high = the rest,
    filled with -inf."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads, value=float("-inf"))
    return F.max_pool2d(x, k, s).contiguous(memory_format=torch.channels_last)


class BasicBlock(nn.Module):
    """Two 3×3 convs."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int, dtype, device=None,
                 stats_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        bn = dict(device=device, stats_dtype=stats_dtype)
        self.Conv_0 = Conv2d(c_in, filters, 3, stride, dtype, device)
        self.BatchNorm_0 = BatchNorm2d(filters, dtype, **bn)
        self.Conv_1 = Conv2d(filters, filters, 3, 1, dtype, device)
        self.BatchNorm_1 = BatchNorm2d(filters, dtype, zero_init=True, **bn)
        self.has_proj = stride != 1 or c_in != filters
        if self.has_proj:
            self.proj_conv = Conv2d(c_in, filters, 1, stride, dtype, device)
            self.proj_bn = BatchNorm2d(filters, dtype, **bn)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.has_proj else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 (×4), optionally through the fused kernels."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int, dtype, device=None,
                 fused: bool = False, stats_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.fused = fused
        self.dtype = dtype
        # The fused path's in-block statistics are f32 whatever stats_dtype.
        bn = dict(device=device, stats_dtype=torch.float32 if fused else stats_dtype)
        self.Conv_0 = Conv2d(c_in, filters, 1, 1, dtype, device)
        self.BatchNorm_0 = BatchNorm2d(filters, dtype, **bn)
        self.Conv_1 = Conv2d(filters, filters, 3, stride, dtype, device)
        self.BatchNorm_1 = BatchNorm2d(filters, dtype, **bn)
        self.Conv_2 = Conv2d(filters, 4 * filters, 1, 1, dtype, device)
        self.BatchNorm_2 = BatchNorm2d(4 * filters, dtype, zero_init=True, **bn)
        self.has_proj = stride != 1 or c_in != 4 * filters
        if self.has_proj:
            self.proj_conv = Conv2d(c_in, 4 * filters, 1, stride, dtype, device)
            self.proj_bn = BatchNorm2d(4 * filters, dtype, device=device,
                                       stats_dtype=stats_dtype)

    def forward(self, x):
        if self.fused:
            return self._forward_fused(x)
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.has_proj else x
        return F.relu(y + residual)

    def _forward_fused(self, x):
        """``resnet.py::BottleneckBlock._call_fused``, step for step."""
        n, _, h, w = x.shape
        dt = self.dtype
        # conv1 (1×1) with the BN0-statistics epilogue
        y1, s1, ss1 = matmul_stats(rows(x), self.Conv_0.matrix())
        mean1, var1, sc1, bi1 = self.BatchNorm_0.split(*moments(s1, ss1, y1.shape[0]))
        z1 = unrows(F.relu(bn_apply(y1, mean1, var1, sc1, bi1, BN_EPS, dt)), n, h, w)
        # conv2 (3×3, the stride) -> BN1 statistics in a plain f32 pass
        y2 = self.Conv_1(z1)
        _, _, ho, wo = y2.shape
        y2f = rows(y2)
        y2_32 = y2f.float()
        m2 = y2_32.mean(0)
        v2 = (y2_32 * y2_32).mean(0) - m2 * m2
        mean2, var2, sc2, bi2 = self.BatchNorm_1.split(m2, v2)
        # BN1-apply -> ReLU -> conv3 (1×1) -> BN2 statistics, one kernel
        y3, s3, ss3 = bn_relu_matmul_stats(y2f, mean2, var2, sc2, bi2,
                                           self.Conv_2.matrix(), BN_EPS)
        mean3, var3, sc3, bi3 = self.BatchNorm_2.split(*moments(s3, ss3, y3.shape[0]))
        y = unrows(bn_apply(y3, mean3, var3, sc3, bi3, BN_EPS, dt), n, ho, wo)
        residual = self.proj_bn(self.proj_conv(x)) if self.has_proj else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1: 7×7/2 conv(64) → BN → ReLU → 3×3/2 max pool; four
    stages of filters (64, 128, 256, 512) with strides (1, 2, 2, 2);
    global average pool; Dense head. ``forward(images NHWC)`` returns
    f32 logits ``[N, num_classes]``.

    Built with uninitialised parameters on ``device`` (``None`` means
    CUDA, and raises without it): load ``convert.init_resnet_params``
    or ``convert.resnet_params_from_flax``. ``fused`` applies to the
    bottleneck depths only, as in the JAX model; ``s2d_stem`` and
    ``stats_dtype`` as the module docstring says."""

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, fused: bool = False,
                 device=None, s2d_stem: bool = False,
                 stats_dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if depth not in STAGES:
            raise ValueError(f"depth must be one of {sorted(STAGES)}, got {depth}")
        device = resolve_device(device)
        if isinstance(stats_dtype, str):
            stats_dtype = getattr(torch, stats_dtype)
        self.depth, self.num_classes, self.dtype, self.fused = depth, num_classes, dtype, fused
        self.s2d_stem, self.stats_dtype = s2d_stem, stats_dtype
        kind, stage_sizes = STAGES[depth]
        if s2d_stem:
            self.stem_conv_s2d = Conv2d(12, 64, 4, 1, dtype, device)
        else:
            self.stem_conv = Conv2d(3, 64, 7, 2, dtype, device)
        self.stem_bn = BatchNorm2d(64, dtype, device=device, stats_dtype=stats_dtype)
        c = 64
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                filters = 64 * 2 ** stage
                if kind == "basic":
                    block = BasicBlock(c, filters, stride, dtype, device, stats_dtype)
                else:
                    block = BottleneckBlock(c, filters, stride, dtype, device, fused=fused,
                                            stats_dtype=stats_dtype)
                c = filters * block.expansion
                name = f"stage{stage + 1}_block{b + 1}"
                self.add_module(name, block)
                self.block_names.append(name)
        self.head = nn.Linear(c, num_classes, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        # NHWC in, channels_last [N, C, H, W] from here on (a view)
        x = images.to(self.dtype)
        if self.s2d_stem:
            x = self.stem_conv_s2d(space_to_depth(x, 2).permute(0, 3, 1, 2))
        else:
            x = self.stem_conv(x.permute(0, 3, 1, 2))
        x = F.relu(self.stem_bn(x))
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        x = F.linear(x, self.head.weight.to(self.dtype), self.head.bias.to(self.dtype))
        return x.float()

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The conv and Dense kernels (flax ``kernel`` leaves): what the
        L2 penalty covers; BN scales and all biases are exempt."""
        return tuple(p for name, p in self.named_parameters()
                     if name.endswith(".weight") and p.dim() in (2, 4))
