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
``csrc/fused_block.cu`` (bf16, TMA and wgmma, persistent, one launch a
call under :func:`plan_for`; counted in :data:`launches`) or raises; on
a CPU tensor it runs the plain version (``*_plain``), the same math in
plain PyTorch; any other device raises. :func:`plan` is the kernel's
plan (``csrc/fused_block_plan.h``) built for the host, :func:`walk` its
blocks' items.

Each op is a ``torch.autograd.Function`` whose backward is the JAX
package's custom VJP line for line (``_matmul_stats_bwd``,
``_bn_bwd``): ``dy_eff = dy + dΣ + 2·y·dΣ²`` in f32 from the rounded
saved ``y``, cast to the compute dtype, and the BN-ReLU prologue
recomputed from the pre-norm input. Its products run as
``torch.matmul``, as JAX leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.ops._counters import counters as _counters

# Op calls that launched the kernel since the last reset, in all and by
# op (chip_smoke.py zeroes them before driving the training path and
# reads them after).
launches = 0
launches_by_op: Dict[str, int] = {"matmul_stats": 0, "bn_relu_matmul_stats": 0}

_K_STEP = 32  # K a multiple of this (the kernel zero-fills its 64-column K box)
_N_STEP = 64  # the kernel's narrowest column panel

# csrc/fused_block_plan.h's fb_plan_ints, in order.
_PLAN_FIELDS = ("panel", "panels", "box_k", "kblocks", "stages", "row_tiles", "items", "grid",
                "blocks_per_panel", "items_per_block", "group", "groups",
                "transforms_per_element", "stat_depth", "smem", "part_floats", "counters",
                "per_sm")
_card_plans: Dict[tuple, dict] = {}


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


def _plan_library() -> ctypes.CDLL:
    lib = _build.load("fused_block_plan")
    for fn in (lib.fused_block_plan_host, lib.fused_block_walk_host):
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def plan(m: int, k: int, n: int, bn_relu: bool, sm_count: int = 132, per_sm: int = 1) -> dict:
    """How the kernel cuts ``y [m, n] = z [m, k] · wᵀ``, from shapes
    alone: items of 128 rows x one column ``panel`` of 256, 128 or 64
    columns (the widest that divides ``n`` and fits shared memory),
    ``kblocks`` ring stages of ``box_k`` K columns an item, a ring of
    ``stages``; a persistent ``grid`` of ``blocks_per_panel`` blocks a
    panel (``sm_count`` SMs at ``per_sm`` blocks each, rounded down to a
    multiple of the panels), each keeping its panel for at most
    ``items_per_block`` row tiles; the prologue applied
    ``transforms_per_element`` times to each element of ``a`` (once a
    panel); the statistics merged in ``groups`` groups of ``group``
    blocks, so that a column's sums pass through at most ``stat_depth``
    terms in a fixed order. The plan is ``csrc/fused_block_plan.h``'s,
    the one the card runs, built here for the host
    (``csrc/fused_block_plan.cpp``): it needs a C++ compiler but no
    card. On the card the kernel's occupancy sets ``per_sm``
    (:func:`plan_for`)."""
    ints = (ctypes.c_int * len(_PLAN_FIELDS))()
    if _plan_library().fused_block_plan_host(m, k, n, int(bn_relu), sm_count, per_sm, ints):
        raise ValueError(f"no fused-block plan for M={m} K={k} N={n} bn_relu={bn_relu}")
    return dict(zip(_PLAN_FIELDS, ints))


def walk(m: int, k: int, n: int, bn_relu: bool, sm_count: int = 132,
         per_sm: int = 1) -> List[List[Tuple[int, int]]]:
    """Each block's items of :func:`plan`'s grid, in the order the
    kernel takes them: ``(row tile, panel)`` pairs."""
    p = plan(m, k, n, bn_relu, sm_count, per_sm)
    ipb = p["items_per_block"]
    out = (ctypes.c_int * (p["grid"] * ipb * 2))()
    if _plan_library().fused_block_walk_host(m, k, n, int(bn_relu), sm_count, per_sm, out):
        raise ValueError(f"no fused-block plan for M={m} K={k} N={n} bn_relu={bn_relu}")
    return [[(out[(b * ipb + i) * 2], out[(b * ipb + i) * 2 + 1]) for i in range(ipb)
             if out[(b * ipb + i) * 2] >= 0] for b in range(p["grid"])]


def plan_for(a: torch.Tensor, w: torch.Tensor, bn_relu: bool) -> dict:
    """The plan a call on CUDA ``a [M, K]`` and ``w [N, K]`` runs: the
    card's SM count and the kernel's occupancy (one query a shape and
    device, then cached)."""
    (m, k), n = a.shape, w.shape[0]
    key = (a.device, m, k, n, bool(bn_relu))
    got = _card_plans.get(key)
    if got is None:
        ints = (ctypes.c_int * len(_PLAN_FIELDS))()
        with torch.cuda.device(a.device):
            rc = _library().fused_block_plan(m, k, n, int(bn_relu), ints)
        if rc != 0:
            raise RuntimeError(f"fused_block_plan failed: CUDA error {rc}")
        got = _card_plans[key] = dict(zip(_PLAN_FIELDS, ints))
    return got


def _launch(a, w, bn, op: str, drop_last_partial: bool = False):
    """Run the CUDA kernel: ``(y, Σy, Σy²)``. ``bn``: ``None``, or the
    prologue's ``(mean, var, scale, bias, eps)``, which the kernel folds
    into its affine itself (as :func:`_affine_rows`)."""
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
    stats_in = [] if bn is None else [x.float().contiguous() for x in bn[:4]]
    if any(x.shape != (k,) for x in stats_in):
        raise ValueError(f"the prologue's statistics must be [K] = [{k}] each")
    for x in [a, w] + stats_in:
        if x.device != a.device:
            raise ValueError(f"tensors on {x.device} and {a.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for x in (a, w):
        if x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    p = plan_for(a, w, bn is not None)
    if drop_last_partial and p["blocks_per_panel"] < 2:
        raise ValueError(f"drop_last_partial needs a plan of several blocks a panel, got {p}")
    y = torch.empty(m, n, dtype=a.dtype, device=a.device)
    stats = torch.empty(2, n, dtype=torch.float32, device=a.device)
    part = torch.empty(p["part_floats"], dtype=torch.float32, device=a.device)
    ptrs = [x.data_ptr() for x in stats_in] or [None] * 4
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        counters = _counters(a.device, stream, p["counters"])
        rc = _library().fused_block_matmul_stats(
            a.data_ptr(), w.data_ptr(), *ptrs, float(bn[4]) if bn is not None else 0.0,
            y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), part.data_ptr(),
            part.numel(), counters.data_ptr(), counters.numel(), m, k, n, int(bn is not None),
            int(drop_last_partial), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_block_matmul_stats launch failed: CUDA error {rc}")
    global launches
    launches += 1
    launches_by_op[op] += 1
    return y, stats[0], stats[1]


def _forward(a, w, bn, op: str, drop_last_partial: bool = False):
    if a.device.type == "cpu":
        if drop_last_partial:
            raise ValueError("drop_last_partial is a control of the CUDA kernel; the plain "
                             "version on the CPU has no partials to drop")
        return _plain(a, w, None if bn is None else _affine_rows(*bn))
    if a.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {a.device}")
    return _launch(a, w, bn, op, drop_last_partial)


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    p, i = ctypes.c_void_p, ctypes.c_int
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    lib.fused_block_matmul_stats.argtypes = ([p] * 6 + [ctypes.c_float] + [p] * 4
                                             + [ctypes.c_longlong, p] + [i] * 6 + [p])
    lib.fused_block_matmul_stats.restype = i
    lib.fused_block_plan.argtypes = [i] * 4 + [p]
    lib.fused_block_plan.restype = i
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
    def forward(ctx, a, w, drop_last_partial):
        y, s, ss = _forward(a, w, None, "matmul_stats", drop_last_partial)
        ctx.save_for_backward(a, w, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, dsum, dsumsq):
        a, w, y = ctx.saved_tensors
        dyc = _dy_eff(y, dy, dsum, dsumsq).to(a.dtype)
        da = torch.matmul(dyc, w)  # [M, N] @ [N, K]
        dw = torch.matmul(dyc.t(), a)  # [N, M] @ [M, K]
        return da, dw, None


class _BnReluMatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, mean, var, scale, bias, w, eps, drop_last_partial):
        y, s, ss = _forward(a, w, (mean, var, scale, bias, eps), "bn_relu_matmul_stats",
                            drop_last_partial)
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
        return da, dmean, dvar, dscale, dbias, dw, None, None


def matmul_stats(a: torch.Tensor, w: torch.Tensor, *, drop_last_partial: bool = False):
    """``[M, K] @ [N, K]ᵀ → (y [M, N], Σcol [N] f32, Σcol² [N] f32)``
    in one pass; differentiable in ``a`` and ``w``.
    ``drop_last_partial`` leaves each panel's last block out of the
    kernel's statistics: a wrong variant, only for negative controls (a
    CUDA call whose plan has several blocks a panel; a CPU tensor
    raises)."""
    return _MatmulStats.apply(a, w, drop_last_partial)


def bn_relu_matmul_stats(a, mean, var, scale, bias, w, eps: float = 1e-5, *,
                         drop_last_partial: bool = False):
    """``y = relu((a − μ)·γ/σ + β) @ wᵀ`` plus ``(Σy, Σy²)``;
    differentiable in ``a``, ``mean``, ``var``, ``scale``, ``bias`` and
    ``w``. ``drop_last_partial`` as :func:`matmul_stats`'s."""
    return _BnReluMatmulStats.apply(a, mean, var, scale, bias, w, float(eps), drop_last_partial)


__all__ = [
    "bn_relu_matmul_stats",
    "bn_relu_matmul_stats_plain",
    "launches",
    "launches_by_op",
    "matmul_stats",
    "matmul_stats_plain",
    "plan",
    "plan_for",
    "walk",
]
