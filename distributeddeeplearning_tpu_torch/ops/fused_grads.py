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
:data:`launches`): bf16 through the tensor cores, or f32 in full f32
FMA (ViT's head is an f32 Dense); any other dtype raises
``NotImplementedError``. On a CPU tensor it runs
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

# Kernel launches since the last reset (chip_smoke.py zeroes it before
# driving the training path and reads it after).
launches = 0

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # csrc/fused_grads.cu's `dtype`


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
    lib.matmul_dw_db.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.matmul_dw_db.restype = ctypes.c_int
    return lib


def matmul_dw_db_cuda(x2d: torch.Tensor, g2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``matmul_dw_db`` on CUDA tensors, both bf16 or both f32:
    ``(dW [M, K], db [M])`` f32."""
    global launches
    _check(x2d, g2d)
    if x2d.dtype != g2d.dtype or x2d.dtype not in _DTYPES:
        raise NotImplementedError(
            f"the dW+db kernel takes bf16 or f32 operands of one dtype, got "
            f"{x2d.dtype} and {g2d.dtype}")
    (n, k), m = x2d.shape, g2d.shape[1]
    if k == 0 or m == 0:
        raise ValueError(f"empty dW: K={k}, M={m}")
    x2d, g2d = x2d.contiguous(), g2d.contiguous()
    dw = torch.empty(m, k, dtype=torch.float32, device=x2d.device)
    db = torch.empty(m, dtype=torch.float32, device=x2d.device)
    aligned = int(k % 8 == 0 and m % 8 == 0 and x2d.data_ptr() % 16 == 0
                  and g2d.data_ptr() % 16 == 0)
    with torch.cuda.device(x2d.device):
        rc = _library().matmul_dw_db(
            x2d.data_ptr(), g2d.data_ptr(), dw.data_ptr(), db.data_ptr(), n, k, m,
            _DTYPES[x2d.dtype], aligned, torch.cuda.current_stream(x2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"matmul_dw_db launch failed: CUDA error {rc}")
    launches += 1
    return dw, db


def matmul_dw_db(x2d: torch.Tensor, g2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dW, db) = (g2dᵀ·x2d, Σ_rows g2d)`` in one pass over ``g2d``:
    ``x2d [N, K]``, ``g2d [N, M]``; f32 ``[M, K]`` and ``[M]``. The
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    _check(x2d, g2d)
    if x2d.device.type == "cpu":
        return matmul_dw_db_plain(x2d, g2d)
    if x2d.device.type == "cuda":
        return matmul_dw_db_cuda(x2d, g2d)
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


__all__ = ["bias_dense", "launches", "matmul_dw_db", "matmul_dw_db_cuda", "matmul_dw_db_plain"]
