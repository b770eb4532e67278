"""Fused paged/dense decode attention: the port of
``distributeddeeplearning_tpu/ops/pallas/paged_decode.py``.

:func:`fused_decode_attention` is the serving tier's decode hot path
(``models/vit.Attention`` under ``decode_kernel="fused"``): masked
online-softmax attention of per-row query windows over a dense
``[B, L, H, d]`` row cache or a paged ``[nb, bs, H, d]`` block pool read
through an int32 ``[B, mb]`` block table. On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/paged_decode.cu`` (and counts the
launch in :data:`launches`) or raises; on a CPU tensor it runs
:func:`fused_decode_attention_plain`, the same math in plain PyTorch.

Numerics follow the TPU kernel: q pre-scaled by ``d**-0.5`` and rounded
to the compute dtype, f32 scores, masked keys (``k_idx > q_pos`` or
``k_idx >= kv_len``) at ``finfo(f32).min``, V zeroed past ``kv_len``,
``p`` rounded to the storage dtype before P·V with f32 accumulation,
``l == 0`` mapped to 1. A quantized cache (int8 or ``float8_e4m3fn``
codes with f32 ``k_scale``/``v_scale`` ``[..., H, 1]``, as
``ops/quant.py`` writes them) is dequantized as the TPU kernel does it,
``(code.float() * scale).to(q.dtype)``, in registers on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.ops import _build

# Kernel launches since the last reset (chip_smoke.py zeroes both before
# driving the serving path and reads them after): the total, and the
# same launches by the cache's storage dtype.
launches = 0
launches_by_store = {"bf16": 0, "f32": 0, "int8": 0, "fp8": 0}

_MASK_VALUE = torch.finfo(torch.float32).min
_NEG_INIT = -1e30  # the online softmax's running-max init
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# Quantized storage dtypes -> (C entry's store code, launch-count key).
_STORE_CODE = {torch.int8: (1, "int8"), torch.float8_e4m3fn: (2, "fp8")}
_HEAD_DIMS = (32, 64, 128)


def _check_args(q, k_cache, v_cache, q_pos, block_table, block_size,
                k_scale=None, v_scale=None):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    if k_scale is not None:
        want = tuple(k_cache.shape[:-1]) + (1,)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(
                f"scales must be {want} (the cache without its last axis), "
                f"got {tuple(k_scale.shape)}, {tuple(v_scale.shape)}"
            )
    if q_pos.dim() != 2:
        raise ValueError(
            f"q_pos must be [B, t] per-row positions, got shape "
            f"{tuple(q_pos.shape)} (the fused kernel serves the vector-index "
            f"decode paths; scalar-index callers use the plain masked path)"
        )
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"expected q [B,t,H,d] and matching 4-D k/v caches, got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    b, t, h, d = q.shape
    if tuple(q_pos.shape) != (b, t):
        raise ValueError(f"q_pos shape {tuple(q_pos.shape)} != {(b, t)}")
    if k_cache.shape[2:] != (h, d):
        raise ValueError(
            f"cache heads/head_dim {tuple(k_cache.shape[2:])} != {(h, d)}"
        )
    if block_table is not None:
        if block_size <= 0:
            raise ValueError("paged layout requires block_size > 0")
        if k_cache.shape[1] != block_size:
            raise ValueError(
                f"pool block size {k_cache.shape[1]} != block_size {block_size}"
            )
        if block_table.dim() != 2 or block_table.shape[0] != b:
            raise ValueError(
                f"block_table must be [B, mb], got {tuple(block_table.shape)}"
            )
    elif k_cache.shape[0] != b:
        raise ValueError(f"dense cache batch {k_cache.shape[0]} != {b}")


def _length(k_cache, block_table, block_size) -> int:
    if block_table is not None:
        return block_table.shape[1] * block_size
    return k_cache.shape[1]


def fused_decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    block_size: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's math in plain PyTorch (any device, bf16 or f32):
    gather the table's logical view, dequantize it when scales are given
    (``(code.float() * scale).to(q.dtype)``), two-pass masked softmax
    with the kernel's roundings. Returns ``[B, t, H, d]`` in
    ``q.dtype``."""
    _check_args(q, k_cache, v_cache, q_pos, block_table, block_size,
                k_scale, v_scale)
    b, t, h, d = q.shape
    length = _length(k_cache, block_table, block_size)
    if kv_len is None:
        kv_len = length

    def logical(x):
        if block_table is None:
            return x
        return x[block_table.long()].reshape(b, length, h, x.shape[-1])

    k_all, v_all = logical(k_cache), logical(v_cache)
    if k_scale is not None:
        k_all = (k_all.float() * logical(k_scale)).to(q.dtype)
        v_all = (v_all.float() * logical(v_scale)).to(q.dtype)
    else:
        k_all = k_all.to(q.dtype)
        v_all = v_all.to(q.dtype)
    qs = (q * d ** -0.5).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k_all.float())
    k_idx = torch.arange(length, device=q.device)
    mask = (k_idx[None, None, :] <= q_pos.long()[:, :, None]) & (
        k_idx < kv_len
    )[None, None, :]
    s = torch.where(mask[:, None], s, _MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True).clamp(min=_NEG_INIT)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v_all = torch.where((k_idx < kv_len)[None, :, None, None], v_all, 0)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v_all.float())
    out = acc / torch.where(l == 0, 1.0, l)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def fused_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    block_table: Optional[torch.Tensor] = None,
    block_size: int = 0,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Fused masked decode attention over a dense row cache or a paged
    block pool.

    Args:
      q: ``[B, t, H, d]`` queries in the compute dtype (``t`` is 1 for
        plain decode, ``K+1`` for a verify window, or the bucket length
        for the paged prefill).
      k_cache / v_cache: dense ``[B, L, H, d]`` or (with
        ``block_table``) the pool ``[nb, block_size, H, d]``, in the
        compute dtype, or int8 / ``float8_e4m3fn`` codes.
      q_pos: ``[B, t]`` int absolute positions of the query rows.
      k_scale / v_scale: f32 scales ``[..., H, 1]`` of quantized caches
        (the cache's shape without its last axis); both or neither.
      block_table: ``[B, mb]`` int32 physical-block ids (paged only);
        entry 0 is the trash block.
      block_size: positions per pool block (paged only).
      kv_len: logical key length (dense default ``L``; paged default
        ``mb * block_size``).

    CPU tensors run :func:`fused_decode_attention_plain`. CUDA tensors
    launch ``csrc/paged_decode.cu`` on the current stream (bf16 or f32
    q; caches in q's dtype, or int8 / fp8 e4m3 with f32 scales; head_dim
    32/64/128) and raise on anything the kernel does not take.
    Returns ``[B, t, H, d]`` in ``q.dtype``.
    """
    if q.device.type == "cpu":
        return fused_decode_attention_plain(
            q, k_cache, v_cache, q_pos, k_scale=k_scale, v_scale=v_scale,
            block_table=block_table, block_size=block_size, kv_len=kv_len,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_decode_attention: unsupported device {q.device}")
    _check_args(q, k_cache, v_cache, q_pos, block_table, block_size,
                k_scale, v_scale)
    b, t, h, d = q.shape
    length = _length(k_cache, block_table, block_size)
    if kv_len is None:
        kv_len = length
    if not 0 <= kv_len <= length:
        raise ValueError(f"kv_len {kv_len} outside [0, {length}]")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes bf16 or f32 q, got {q.dtype}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError(f"k and v caches differ: {k_cache.dtype}, {v_cache.dtype}")
    if k_scale is None:
        if k_cache.dtype != q.dtype:
            raise ValueError(
                f"an unscaled cache must be in q's dtype {q.dtype}, got "
                f"{k_cache.dtype} (quantized caches need k_scale/v_scale)"
            )
        store, key = 0, "bf16" if q.dtype == torch.bfloat16 else "f32"
    else:
        if k_cache.dtype not in _STORE_CODE:
            raise ValueError(
                f"a scaled cache must be int8 or float8_e4m3fn, got {k_cache.dtype}"
            )
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError(
                f"scales must be float32, got {k_scale.dtype}, {v_scale.dtype}"
            )
        store, key = _STORE_CODE[k_cache.dtype]
    if d not in _HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of {_HEAD_DIMS}, got {d}")
    pos = q_pos
    if pos.dtype != torch.int32:
        pos = pos.to(torch.int32)
    pos = pos.contiguous()
    table = block_table
    if table is not None:
        if table.dtype != torch.int32:
            table = table.to(torch.int32)
        table = table.contiguous()
    scales = [k_scale, v_scale] if k_scale is not None else []
    tensors = [q, k_cache, v_cache, pos] + scales + ([table] if table is not None else [])
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"tensors on {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    for x in (q, k_cache, v_cache):
        if x.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if scales else None,
            v_scale.data_ptr() if scales else None,
            pos.data_ptr(), table.data_ptr() if table is not None else None,
            out.data_ptr(), b, t, h, d, int(table is not None),
            int(block_size), table.shape[1] if table is not None else 0,
            k_cache.shape[1], int(kv_len), _DTYPE_CODE[q.dtype], store,
            float(d) ** -0.5, stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA error {rc}")
    global launches
    launches += 1
    launches_by_store[key] += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("paged_decode")
    fn = lib.paged_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    fn.argtypes = [p] * 8 + [i] * 11 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return lib
