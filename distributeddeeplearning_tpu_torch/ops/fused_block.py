"""Fused bottleneck-segment ops: the port of
``distributeddeeplearning_tpu/ops/pallas/fused_block.py``.

* :func:`matmul_stats` — ``y = a @ w.T`` with per-column ``(Σy, Σy²)``
  computed from the rounded ``y`` in the same pass (a bottleneck's
  block-entry 1×1 conv and its BN statistics).
* :func:`bn_relu_matmul_stats` — the same after the prologue
  ``z = relu(a·γ/σ + (β − μγ/σ))`` (BN-apply → ReLU → conv3 → BN
  statistics); ``z`` never reaches device memory.

``a`` is ``[M, K]`` (an NHWC activation seen as rows) and ``w`` is
``[N, K]``: the 1×1 conv's ``[out, in]`` weight, in the layout the
port's ResNet keeps it (``models/resnet.py``), so no transpose runs per
call. On a CUDA tensor the forward launches the hand-written kernel
``csrc/fused_block.cu`` (bf16; counted in :data:`launches`) or raises;
on a CPU tensor it runs the plain version (``*_plain``), the same math
in plain PyTorch; any other device raises.

Each op is a ``torch.autograd.Function`` whose backward is the JAX
package's custom VJP line for line (``_matmul_stats_bwd``,
``_bn_bwd``): ``dy_eff = dy + dΣ + 2·y·dΣ²`` in f32 from the rounded
saved ``y``, cast to the compute dtype, and the BN-ReLU prologue
recomputed from the pre-norm input. Its products run as
``torch.matmul``, as JAX leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

# Op calls that launched the kernel since the last reset, in all and by
# op (chip_smoke.py zeroes them before driving the training path and
# reads them after).
launches = 0
launches_by_op: Dict[str, int] = {"matmul_stats": 0, "bn_relu_matmul_stats": 0}

_K_STEP = 32  # the kernel's K slice
_N_STEP = 64  # the kernel's narrowest column tile


def _affine_rows(mean, var, scale, bias, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The folded BN affine, f32 ``[K]`` each: ``inv = rsqrt(σ²+eps)·γ``
    and ``shift = β − μ·inv`` (``fused_block.py::_affine_rows``)."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    return inv, bias.float() - mean.float() * inv


def _plain(a, w, affine):
    if affine is None:
        z = a
    else:
        inv, shift = affine
        z = torch.clamp(a.float() * inv + shift, min=0.0).to(a.dtype)
    y = (z.float() @ w.float().t()).to(a.dtype)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


def matmul_stats_plain(a: torch.Tensor, w: torch.Tensor):
    """The kernel's math in plain PyTorch (any device): ``y`` rounded to
    ``a.dtype`` from an f32 product, statistics in f32 from it."""
    _check(a, w)
    return _plain(a, w, None)


def bn_relu_matmul_stats_plain(a, mean, var, scale, bias, w, eps: float = 1e-5):
    """:func:`matmul_stats_plain` after the BN-apply + ReLU prologue
    (``z`` rounded to ``a.dtype``, as the kernel feeds it to the MMA)."""
    _check(a, w)
    return _plain(a, w, _affine_rows(mean, var, scale, bias, eps))


def _check(a, w):
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(
            f"expected a [M, K] and w [N, K], got {tuple(a.shape)}, {tuple(w.shape)}"
        )
    if a.dtype != w.dtype:
        raise ValueError(f"a and w dtypes differ: {a.dtype}, {w.dtype}")


def _launch(a, w, affine, op: str):
    """Run the CUDA kernel: ``(y, Σy, Σy²)``."""
    _check(a, w)
    m, k = a.shape
    n = w.shape[0]
    if a.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 operands, got {a.dtype}")
    if m < 1 or k % _K_STEP or n % _N_STEP:
        raise ValueError(
            f"the kernel takes M >= 1, K % {_K_STEP} == 0 and N % {_N_STEP} == 0, "
            f"got M={m} K={k} N={n}"
        )
    tensors = [a, w] + (list(affine) if affine is not None else [])
    for x in tensors:
        if x.device != a.device:
            raise ValueError(f"tensors on {x.device} and {a.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    lib = _library()
    tiles = -(-m // lib.fused_block_row_tile())
    y = torch.empty(m, n, dtype=a.dtype, device=a.device)
    part = torch.empty(2, tiles, n, dtype=torch.float32, device=a.device)
    stats = torch.empty(2, n, dtype=torch.float32, device=a.device)
    scale_p = affine[0].data_ptr() if affine is not None else None
    shift_p = affine[1].data_ptr() if affine is not None else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.fused_block_matmul_stats(
            a.data_ptr(), w.data_ptr(), scale_p, shift_p, y.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(),
            stats[1].data_ptr(), m, k, n, int(affine is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_block_matmul_stats launch failed: CUDA error {rc}")
    global launches
    launches += 1
    launches_by_op[op] += 1
    return y, stats[0], stats[1]


def _forward(a, w, affine, op: str):
    if a.device.type == "cpu":
        return _plain(a, w, affine)
    if a.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {a.device}")
    return _launch(a, w, affine, op)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    fn = lib.fused_block_matmul_stats
    p, i = ctypes.c_void_p, ctypes.c_int
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    fn.argtypes = [p] * 9 + [i] * 4 + [p]
    fn.restype = ctypes.c_int
    lib.fused_block_row_tile.argtypes = []
    lib.fused_block_row_tile.restype = ctypes.c_int
    return lib


def _dy_eff(y, dy, dsum, dsumsq):
    """``dy + dΣ + 2·y·dΣ²`` in f32 from the rounded ``y``; absent
    cotangents count as zero."""
    out = dy.float() if dy is not None else torch.zeros_like(y, dtype=torch.float32)
    if dsum is not None:
        out = out + dsum[None, :]
    if dsumsq is not None:
        out = out + 2.0 * y.float() * dsumsq[None, :]
    return out


class _MatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w):
        y, s, ss = _forward(a, w, None, "matmul_stats")
        ctx.save_for_backward(a, w, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        a, w, y = ctx.saved_tensors
        dyc = _dy_eff(y, dy, dsum, dsumsq).to(a.dtype)
        da = torch.matmul(dyc, w)  # [M, N] @ [N, K]
        dw = torch.matmul(dyc.t(), a)  # [N, M] @ [M, K]
        return da, dw


class _BnReluMatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, mean, var, scale, bias, w, eps):
        y, s, ss = _forward(
            a, w, _affine_rows(mean, var, scale, bias, eps), "bn_relu_matmul_stats"
        )
        ctx.save_for_backward(a, mean, var, scale, bias, w, y)
        ctx.eps = eps
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        a, mean, var, scale, bias, w, y = ctx.saved_tensors
        cdt = a.dtype  # the big [M, ·] intermediates stay in the compute dtype
        dy_eff = _dy_eff(y, dy, dsum, dsumsq).to(cdt)
        inv = torch.rsqrt(var.float() + ctx.eps)
        g = inv * scale.float()
        pre = a.float() * g + (bias.float() - mean.float() * g)
        zmask = pre > 0.0
        z = torch.where(zmask, pre, 0.0).to(cdt)
        dw = torch.matmul(dy_eff.t(), z).to(w.dtype)  # [N, K]
        # JAX keeps dz in f32 and rounds it after the ReLU mask; rounding
        # first gives the same values.
        dz = torch.matmul(dy_eff, w)  # [M, K]
        dzb = torch.where(zmask, dz, 0.0).to(cdt)
        da = (dzb.float() * g).to(a.dtype)
        ahat = ((a.float() - mean.float()) * inv).to(cdt)
        dzb_ahat = (dzb * ahat).float().sum(0)
        dzb_sum = dzb.float().sum(0)
        dscale = dzb_ahat.to(scale.dtype)
        dbias = dzb_sum.to(bias.dtype)
        dmean = (-dzb_sum * g).to(mean.dtype)
        # dz/dσ² = (a−μ)·γ·(−½)σ⁻³ = −½·γ·x̂·inv²
        dvar = (-0.5 * dzb_ahat * scale.float() * inv * inv).to(var.dtype)
        return da, dmean, dvar, dscale, dbias, dw, None


def matmul_stats(a: torch.Tensor, w: torch.Tensor):
    """``[M, K] @ [N, K]ᵀ → (y [M, N], Σcol [N] f32, Σcol² [N] f32)``
    in one pass; differentiable in ``a`` and ``w``."""
    return _MatmulStats.apply(a, w)


def bn_relu_matmul_stats(a, mean, var, scale, bias, w, eps: float = 1e-5):
    """``y = relu((a − μ)·γ/σ + β) @ wᵀ`` plus ``(Σy, Σy²)``;
    differentiable in ``a``, ``mean``, ``var``, ``scale``, ``bias`` and
    ``w``."""
    return _BnReluMatmulStats.apply(a, mean, var, scale, bias, w, float(eps))


__all__ = [
    "bn_relu_matmul_stats",
    "bn_relu_matmul_stats_plain",
    "launches",
    "launches_by_op",
    "matmul_stats",
    "matmul_stats_plain",
]
