"""Fused paged/dense decode attention: the port of
``distributeddeeplearning_tpu/ops/pallas/paged_decode.py``.

:func:`fused_decode_attention` is the serving tier's decode hot path
(``models/vit.Attention`` under ``decode_kernel="fused"``): masked
online-softmax attention of per-row query windows over a dense
``[B, L, H, d]`` row cache or a paged ``[nb, bs, H, d]`` block pool read
through an int32 ``[B, mb]`` block table. On a CUDA tensor it launches
the hand-written Hopper kernel ``csrc/paged_decode.cu`` under
:func:`split_plan` (the key axis split across blocks, the splits'
partials merged in the same launch by the last block of each query
tile; one call counts one launch in :data:`launches`) or raises; on a CPU tensor it runs
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
# The merge's counters (one per row, tile and head group), per (device, stream).
from distributeddeeplearning_tpu_torch.ops._counters import counters as _counters

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
_HEAD_DIMS = (32, 64, 96, 128)


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


# The kernel's split plan (csrc/paged_decode.cu): 16 key positions per
# ring stage, twelve consumer warps, heads per warp by head dim, query
# rows per tile by compute dtype, and the shared memory a block may use.
_CHUNK = 16
_CONSUMER_WARPS = 12
_HEADS_PER_WARP = {32: 2, 64: 1, 96: 1, 128: 1}
_MAX_SMEM = 232_448  # dynamic shared memory of one block (227 KB)
_SM_SMEM = 233_472  # one SM's shared memory (228 KB); each block reserves 1 KB
_MAX_CHUNKS_PER_SPLIT = 8  # at most 128 keys a block
_STAGES = 4  # ring stages of the source's default build (PD_STAGES)
_ELEM = {"bf16": 2, "f32": 4, "int8": 1, "fp8": 1}


def _align128(x: int) -> int:
    return (x + 127) & ~127


def _smem_bytes(g: int, d: int, store: str, compute: str, stages: int) -> int:
    """A block's dynamic shared memory at most (``layout`` in the source,
    which drops the rows' padding where a quantized stage is one copy):
    the mbarriers and the merge's flag, the f32 q tile, ``stages`` ring
    stages of 16 K and V position rows (and their scales when
    quantized), and, quantized, two dequantized tiles in the compute
    dtype."""
    quant = store in ("int8", "fp8")
    stride_s = g * d * _ELEM[store] + 16
    stride_c = g * d * _ELEM[compute] + 16
    stage = _align128(2 * _CHUNK * stride_s + (2 * _CHUNK * g * 4 if quant else 0))
    q_off = _align128(2 * stages * 8 + 4)
    ring_off = _align128(q_off + (4 * stride_c if compute == "f32" else 0))
    return ring_off + stages * stage + (4 * _CHUNK * stride_c if quant else 0)


def split_plan(b: int, t: int, h: int, d: int, length: int, store: str, sm_count: int, *,
               compute: str = "bf16", stages: int = _STAGES) -> dict:
    """How the kernel cuts a call into blocks, from shapes alone (never
    from ``q_pos``'s values, so the wrapper reads nothing back from the
    device): a block is (cache row, tile of ``tile_q`` query rows, group
    of ``group_heads`` heads, split of ``chunks_per_split`` chunks of 16
    key positions). Heads are grouped only where one group's ring does
    not fit a block's shared memory. Splits: enough that the blocks of a
    full-length call fill the card once (at the occupancy the shared
    memory allows), and at most 128 keys a block; with more than one
    split the last block of each query tile to finish merges them
    (``combine``). A split that starts past its tile's live length does
    no work, and a tile with nothing live still runs its first split.
    ``stages`` is the ring depth the library was built with."""
    if store not in _ELEM or compute not in ("bf16", "f32") or d not in _HEAD_DIMS:
        raise ValueError(f"no plan for store {store!r}, compute {compute!r}, head_dim {d}")
    tile_q = 16 if compute == "bf16" else 4
    tiles = -(-t // tile_q)
    groups = -(-h // (_CONSUMER_WARPS * _HEADS_PER_WARP[d]))
    while True:
        g = -(-h // groups)
        groups = -(-h // g)
        smem = _smem_bytes(g, d, store, compute, stages)
        if smem <= _MAX_SMEM:
            break
        if g == 1:
            raise ValueError(f"one head of d {d} in {store} does not fit {stages} stages")
        groups += 1
    per_sm = max(1, min(2, _SM_SMEM // (smem + 1024)))
    nchunks = max(1, -(-length // _CHUNK))
    items = b * tiles * groups
    splits = max(sm_count * per_sm // items, -(-nchunks // _MAX_CHUNKS_PER_SPLIT))
    splits = min(max(splits, 1), nchunks)
    cps = -(-nchunks // splits)
    splits = -(-nchunks // cps)
    return {"tile_q": tile_q, "tiles": tiles, "groups": groups, "group_heads": g,
            "splits": splits, "chunks_per_split": cps, "stages": stages,
            "smem_bytes": smem, "blocks": b * tiles * groups * splits,
            "combine": "last_block" if splits > 1 else "none"}


def _store_name(q_dtype, k_dtype, quantized: bool) -> str:
    if quantized:
        return _STORE_CODE[k_dtype][1]
    return "bf16" if q_dtype == torch.bfloat16 else "f32"


def plan_for(q, k_cache, block_table=None, block_size: int = 0,
             quantized: bool = False) -> dict:
    """:func:`split_plan` of a call's operands (the SM count of q's card,
    the ring depth of the loaded library)."""
    b, t, h, d = q.shape
    return split_plan(b, t, h, d, _length(k_cache, block_table, block_size),
                      _store_name(q.dtype, k_cache.dtype, quantized),
                      torch.cuda.get_device_properties(q.device).multi_processor_count,
                      compute="bf16" if q.dtype == torch.bfloat16 else "f32",
                      stages=_library().paged_decode_ring_stages())


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
    drop_last_split: bool = False,
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
      drop_last_split: drop each query tile's last live key split: a
        wrong variant, only for negative controls (CUDA only; a CPU
        tensor raises).

    CPU tensors run :func:`fused_decode_attention_plain`. CUDA tensors
    launch ``csrc/paged_decode.cu`` on the current stream under
    :func:`split_plan` (bf16 or f32 q; caches in q's dtype, or int8 /
    fp8 e4m3 with f32 scales; head_dim 32/64/96/128) and raise on anything
    the kernel does not take. The merge's counters are kept per (device,
    stream): calls on one stream run in order, and calls on two streams
    never share a buffer. Returns ``[B, t, H, d]`` in ``q.dtype``.
    """
    if q.device.type == "cpu":
        if drop_last_split:
            raise ValueError("drop_last_split is a control of the CUDA kernel; the plain "
                             "version on the CPU has no splits to drop")
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
    plan = plan_for(q, k_cache, block_table, block_size, k_scale is not None)
    out = torch.empty_like(q)
    part_acc = part_ml = counters = None
    if plan["splits"] > 1:
        rows = plan["splits"] * b * t * h
        part_acc = torch.empty(rows * d, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan["splits"] > 1:
            counters = _counters(q.device, stream, b * plan["tiles"] * plan["groups"])
        rc = lib.paged_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr() if scales else None,
            v_scale.data_ptr() if scales else None,
            pos.data_ptr(), table.data_ptr() if table is not None else None,
            out.data_ptr(), part_acc.data_ptr() if part_acc is not None else None,
            part_ml.data_ptr() if part_ml is not None else None,
            counters.data_ptr() if counters is not None else None, b, t, h, d,
            int(table is not None), int(block_size),
            table.shape[1] if table is not None else 0, k_cache.shape[1], int(kv_len),
            _DTYPE_CODE[q.dtype], store, plan["group_heads"], plan["groups"],
            plan["splits"], plan["chunks_per_split"], int(drop_last_split),
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
    fn.argtypes = [p] * 11 + [i] * 16 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int
    lib.paged_decode_ring_stages.argtypes = []
    lib.paged_decode_ring_stages.restype = ctypes.c_int
    return lib
