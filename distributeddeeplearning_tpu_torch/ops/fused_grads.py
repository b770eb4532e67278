"""Fused dW + db backward of a Dense layer: the port of
``distributeddeeplearning_tpu/ops/pallas/fused_grads.py``.

:func:`matmul_dw_db` computes a Dense layer's weight and bias gradients
in one pass over the upstream gradient ``g`` (a plain matmul followed by
a column sum reads ``g`` twice). :func:`bias_dense` is the Dense forward
whose backward uses it, a ``torch.autograd.Function`` (the JAX custom
VJP ``bias_dense`` / ``_bias_dense_bwd``); ViT's ``FusedGradDense``
calls it under ``FUSED_DENSE_GRAD=1``.

Layout: ``dW`` comes back in the port's ``[out, in]`` Linear layout,
``gᵀ·x`` (JAX returns ``xᵀ·g`` as ``[K, M]``), so no transpose copy
runs; both are f32.

On a CUDA tensor :func:`matmul_dw_db` launches the hand-written Hopper
kernel of ``csrc/fused_grads.cu`` (``matmul_dw_db``, counted in
:data:`launches`): bf16 through the tensor cores (wgmma under
:func:`dw_db_plan` where a tensor map can describe x and g, mma.sync
else), or f32 in full f32 FMA (ViT's head is an f32 Dense); any other
dtype raises ``NotImplementedError``. On a CPU tensor it runs
:func:`matmul_dw_db_plain`; any other device raises. The kernel keeps
its accumulators per output tile, so it takes every shape: JAX's
``_fits_vmem`` fallback to a two-pass XLA path has no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.ops._counters import counters as _counters

# Kernel launches since the last reset (chip_smoke.py zeroes it before
# driving the training path and reads it after).
launches = 0

_PATHS = {"wgmma": 0, "mma_sync": 1, "f32": 2}  # csrc/fused_grads.cu's `path`
_TILE_M, _CHUNK = 128, 64  # the wgmma path's dW tile rows, and rows of N a stage
_MAX_SPLITS = 32
# dw_db_plan's cost model, in microseconds, fitted to the split sweep of
# scripts/fused_grads_ablation.py at ViT-B/16's Dense shapes on an H100
# (PERF.md; within about 5 % of most of its 128 plans): a 64-row chunk of
# a 128 x bk tile takes the larger of its tensor-core time at 75 % of an
# SM's share of 989 TFLOP/s and its (128 + bk) x 64 bf16 operands at 70
# GB/s of L2 an SM; a block costs 3 more (pipeline fill, epilogue); with
# splits, every block writes its f32 partial tile (all of them at 6 TB/s
# for the card) and the last block of a tile writes its own and reads
# them all back at 40 GB/s, after every product.
_SM_FLOPS_US = 0.75 * 989e6 / 132
_SM_L2_BYTES_US = 70e3
_BLOCK_US = 3.0
_MERGE_SM_BYTES_US = 40e3
_MERGE_BYTES_US = 6e6


def dw_db_plan(n: int, k: int, m: int, sm_count: int, *, tile_k: int = 0,
               one_split: bool = False) -> dict:
    """How the wgmma kernel cuts ``dW [m, k] = gᵀ·x`` over ``n`` rows,
    from shapes alone: a dW tile of 128 rows x ``tile_k`` (128 or 256)
    columns, and the rows in ``splits`` runs of ``chunks_per_split``
    chunks of 64 (every split non-empty); ``tiles x splits`` blocks, one
    an SM. Of the tiles and split counts, the one the cost model above
    rates fastest: waves of blocks over the ``sm_count`` SMs (so a tail
    wave costs a whole wave), and each split's partial tile written and
    read back once (the last block of each tile sums the tile's partials
    in split order), which favours few splits where dW is large. ``tile_k`` and ``one_split`` force the tile and one
    split (the source's build constants, for ablations)."""
    chunks = max(1, -(-n // _CHUNK))
    best = None
    for bk in (tile_k,) if tile_k else (256, 128):
        ktiles = -(-k // bk)
        tiles = -(-m // _TILE_M) * ktiles
        chunk_us = max(2 * _TILE_M * bk * _CHUNK / _SM_FLOPS_US,
                       2 * (_TILE_M + bk) * _CHUNK / _SM_L2_BYTES_US)
        for want in range(1, 1 + (1 if one_split else min(chunks, _MAX_SPLITS))):
            cps = -(-chunks // want)
            splits = -(-chunks // cps)
            blocks = tiles * splits
            waves = -(-blocks // sm_count)
            cost = waves * (cps * chunk_us + _BLOCK_US)
            if splits > 1:
                partial = 4 * _TILE_M * bk
                cost += ((splits + 1) * partial / _MERGE_SM_BYTES_US
                         + blocks * 2 * partial / _MERGE_BYTES_US)
            if best is None or cost < best[0]:
                best = (cost, {"tile_m": _TILE_M, "tile_k": bk, "ktiles": ktiles, "tiles": tiles,
                               "splits": splits, "chunks_per_split": cps,
                               "blocks": tiles * splits, "waves": waves,
                               "merge": "last_block" if splits > 1 else "none"})
    return best[1]


def matmul_dw_db_plain(x2d: torch.Tensor, g2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db) = (g2dᵀ·x2d [M, K], Σ_rows g2d [M])`` in f32 (products
    of the inputs' values, f32 sums), any device."""
    g = g2d.float()
    return g.t() @ x2d.float(), g.sum(0)


def _check(x2d: torch.Tensor, g2d: torch.Tensor) -> None:
    if x2d.dim() != 2 or g2d.dim() != 2 or x2d.shape[0] != g2d.shape[0]:
        raise ValueError(
            f"expected x [N, K] and g [N, M], got {tuple(x2d.shape)} and {tuple(g2d.shape)}")
    if x2d.device != g2d.device:
        raise ValueError(f"tensors on {x2d.device} and {g2d.device}")


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_grads")
    p, i = ctypes.c_void_p, ctypes.c_int
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    lib.matmul_dw_db.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.matmul_dw_db.restype = ctypes.c_int
    for fn in (lib.matmul_dw_db_tile_k, lib.matmul_dw_db_one_split):
        fn.argtypes = []
        fn.restype = i
    return lib


def _aligned(x2d: torch.Tensor, g2d: torch.Tensor) -> bool:
    """Rows of 16-byte multiples from 16-byte aligned starts (bf16)."""
    return (x2d.shape[1] % 8 == 0 and g2d.shape[1] % 8 == 0 and x2d.data_ptr() % 16 == 0
            and g2d.data_ptr() % 16 == 0)


def kernel_path(x2d: torch.Tensor, g2d: torch.Tensor) -> str:
    """Which kernel a call takes: ``"f32"`` for f32 operands; for bf16,
    ``"wgmma"`` where a tensor map can describe x and g (K and M
    multiples of 8, both 16-byte aligned, N >= 1), else ``"mma_sync"``."""
    if x2d.dtype == torch.float32:
        return "f32"
    return "wgmma" if _aligned(x2d, g2d) and x2d.shape[0] > 0 else "mma_sync"


def plan_for(x2d: torch.Tensor, g2d: torch.Tensor) -> dict:
    """The path of a call on CUDA operands and, on the wgmma path, its
    :func:`dw_db_plan` (the SM count of x's card, the loaded library's
    build constants)."""
    path = kernel_path(x2d, g2d)
    if path != "wgmma":
        return {"path": path, "splits": 1}
    lib = _library()
    (n, k), m = x2d.shape, g2d.shape[1]
    plan = dw_db_plan(n, k, m, torch.cuda.get_device_properties(x2d.device).multi_processor_count,
                      tile_k=lib.matmul_dw_db_tile_k(), one_split=bool(lib.matmul_dw_db_one_split()))
    return dict(plan, path=path)


def matmul_dw_db_cuda(x2d: torch.Tensor, g2d: torch.Tensor, *,
                      drop_last_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``matmul_dw_db`` on CUDA tensors, both bf16 or both f32:
    ``(dW [M, K], db [M])`` f32. ``drop_last_split`` leaves each dW
    tile's last row split out of the merge: a wrong variant, only for
    negative controls (a call whose plan has more than one split)."""
    global launches
    _check(x2d, g2d)
    if x2d.dtype != g2d.dtype or x2d.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the dW+db kernel takes bf16 or f32 operands of one dtype, got "
            f"{x2d.dtype} and {g2d.dtype}")
    (n, k), m = x2d.shape, g2d.shape[1]
    if k == 0 or m == 0:
        raise ValueError(f"empty dW: K={k}, M={m}")
    x2d, g2d = x2d.contiguous(), g2d.contiguous()
    plan = plan_for(x2d, g2d)
    if drop_last_split and plan["splits"] < 2:
        raise ValueError(f"drop_last_split needs a plan of several splits, got {plan}")
    dev = x2d.device
    dw = torch.empty(m, k, dtype=torch.float32, device=dev)
    db = torch.empty(m, dtype=torch.float32, device=dev)
    part = counters = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan["splits"] > 1:
            mtiles = -(-m // _TILE_M)
            part = torch.empty(plan["splits"] * (plan["tiles"] * _TILE_M * plan["tile_k"]
                                                 + mtiles * _TILE_M),
                               dtype=torch.float32, device=dev)
            counters = _counters(dev, stream, plan["tiles"])
        rc = _library().matmul_dw_db(
            x2d.data_ptr(), g2d.data_ptr(), dw.data_ptr(), db.data_ptr(),
            part.data_ptr() if part is not None else None,
            counters.data_ptr() if counters is not None else None, n, k, m,
            _PATHS[plan["path"]], int(_aligned(x2d, g2d)), plan.get("tile_k", 0), plan["splits"],
            plan.get("chunks_per_split", 0), int(drop_last_split), stream)
    if rc != 0:
        raise RuntimeError(f"matmul_dw_db ({plan['path']}) launch failed: CUDA error {rc}")
    launches += 1
    return dw, db


def matmul_dw_db(x2d: torch.Tensor, g2d: torch.Tensor, *,
                 drop_last_split: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db) = (g2dᵀ·x2d, Σ_rows g2d)`` in one pass over ``g2d``:
    ``x2d [N, K]``, ``g2d [N, M]``; f32 ``[M, K]`` and ``[M]``. The
    kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``drop_last_split`` is :func:`matmul_dw_db_cuda`'s negative control;
    the plain version has no splits, so a CPU tensor raises."""
    _check(x2d, g2d)
    if x2d.device.type == "cpu":
        if drop_last_split:
            raise ValueError("drop_last_split is a control of the CUDA kernel; the plain "
                             "version on the CPU has no splits to drop")
        return matmul_dw_db_plain(x2d, g2d)
    if x2d.device.type == "cuda":
        return matmul_dw_db_cuda(x2d, g2d, drop_last_split=drop_last_split)
    raise ValueError(f"matmul_dw_db: unsupported device {x2d.device}")


class _BiasDense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, compute_dtype):
        ctx.save_for_backward(x, weight)
        ctx.compute_dtype = compute_dtype
        return F.linear(x.to(compute_dtype), weight.to(compute_dtype)) + bias.to(compute_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        cd = ctx.compute_dtype
        gc = gy.to(cd)
        dx = (gc @ weight.to(cd)).to(x.dtype)
        dw, db = matmul_dw_db(x.reshape(-1, x.shape[-1]).to(cd), gc.reshape(-1, gy.shape[-1]))
        return dx, dw.to(weight.dtype), db.to(weight.dtype), None


def bias_dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """``x·weightᵀ + bias`` (``weight`` ``[out, in]``) with the fused
    dW+db backward. The forward is flax ``nn.Dense``'s with
    ``dtype=compute_dtype``: operands cast to the compute dtype, the
    bias added in it. The backward: ``dx = g·W`` in the compute dtype
    (a plain matmul), cast to ``x.dtype``; ``dW`` and ``db`` from
    :func:`matmul_dw_db`, cast to the parameters' dtype (f32), as
    ``_bias_dense_bwd``."""
    return _BiasDense.apply(x, weight, bias, compute_dtype)


__all__ = ["bias_dense", "dw_db_plan", "kernel_path", "launches", "matmul_dw_db",
           "matmul_dw_db_cuda", "matmul_dw_db_plain", "plan_for"]
