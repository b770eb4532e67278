"""Packed-QKV attention for short sequences: the port of
``distributeddeeplearning_tpu/ops/pallas/flash_packed.py``.

:func:`fused_qkv_attention` takes the QKV projection's raw output
``[B, T, 3·H·d]`` (column ``part·H·d + h·d + i``, exactly what
``reshape(B, T, 3, H, d)`` means) and returns ``[B, T, H·d]``, the proj
Dense's input, with no reshape, slice or transpose around it. It is a
``torch.autograd.Function`` whose forward saves ``(qkv, out)`` and whose
backward recomputes the softmax (no saved statistics) and returns one
packed ``dqkv`` (the JAX custom VJP ``_packed_fwd_rule`` /
``_packed_bwd_rule``). ViT's ``attn_impl="fused"`` calls it, and
``"auto"`` does on the card where :func:`supports` holds.

On a CUDA tensor each step launches hand-written Hopper kernels, on the
route :func:`route` picks before any launch (each call counted once in
:data:`launches`, :data:`launches_by_op` and :data:`launches_by_route`,
a generic one also in :data:`generic_launches_by_op`). bf16 at head dim
32, 64 or 128 takes ``csrc/flash_packed.cu`` (``"wgmma"``:
``fused_qkv_fwd``, ``fused_qkv_bwd``); its backward is two kernels on
one stream: dq, which also writes each row's ``m``, ``1/l`` and ``Δ`` to
an f32 scratch (:func:`backward_row_stats_plain` is its plain version),
then dk/dv, which reads them. f32 at any head dim up to 256, and bf16 at
another head dim up to 256 (JAX's 16 or 256), take
``csrc/flash_generic.cu`` (``"generic"``): its forward, with packed
numerics (``p`` over the row's full max), reads q, k and v as strided
column views of the projection and writes ``out`` as a ``[B, T, H, d]``
view of ``[B, T, H·d]``, and also the rows' LSE, which the Function
saves beside ``(qkv, out)``; the backward computes ``Δ`` as a torch op,
then the generic dq and dk/dv kernels write into strided views of one
``dqkv``: no reshape and no copy, as JAX's packed kernel. T past
:data:`MAX_T`, f16 and head dims past 256 raise ``NotImplementedError``;
neither route gives way to the other or to the plain version. On a CPU
tensor it runs the plain versions, :func:`fused_qkv_attention_plain`
and :func:`fused_qkv_attention_backward_plain`; any other device
raises.

Numerics (the JAX kernels' rounding points): scores ``f32(q·kᵀ)·scale``,
masked entries (keys past T; later keys when causal) at the finite
``-1e30``, ``p = exp(s − m)`` over the row's full max, rounded to the
input dtype before ``p·v``, the division by ``l = Σp`` after (``l == 0``
taken as 1); backward ``pn = p/l`` in f32, ``Δ = rowsum(f32(do)·f32(o))``,
``ds = round(pn·(dp − Δ)·scale)``, ``dq = ds·k``, ``dk = dsᵀ·q``,
``dv = round(pn)ᵀ·do``, f32 sums each rounded once to the input dtype.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from distributeddeeplearning_tpu_torch.ops import _build, flash

# Kernel launches since the last reset, in all and by kernel
# (chip_smoke.py zeroes them before driving the training path and reads
# them after).
launches = 0
launches_by_op: Dict[str, int] = {"fused_qkv_fwd": 0, "fused_qkv_bwd": 0}
launches_by_route: Dict[str, int] = {"wgmma": 0, "generic": 0}
generic_launches_by_op: Dict[str, int] = {"fused_qkv_fwd": 0, "fused_qkv_bwd": 0}

MAX_T = 512  # the JAX kernel's whole-sequence limit (flash_packed.MAX_T)
NEG_INF = -1e30  # the kernels' finite mask value
HEAD_DIMS = (32, 64, 128)  # csrc/flash_packed.cu's instances (bf16)
STATS_TILE = 128  # the backward's scratch pads T to whole 128-row blocks
_LANES = 128
_VMEM_BUDGET = 13 * 2 ** 20  # JAX's flash_packed._VMEM_BUDGET


def heads_per_block(head_dim: int) -> int:
    """How many heads share one 128-lane block in the JAX kernel."""
    return max(1, _LANES // head_dim)


def _bwd_vmem_bytes(tp: int, width: int) -> int:
    """JAX's backward VMEM estimate (``flash_packed._bwd_vmem_bytes`` at
    one sample a block, bf16 blocks): 15 blocks of ``[tp, width]`` and
    six ``[tp, tp]`` f32 score intermediates, with 30 % slack."""
    return int(((5 * 2 + 2 + 3) * tp * width * 2 + 6 * tp * tp * 4) * 1.3)


def supports(seq_len: int, num_heads: int, head_dim: int) -> bool:
    """JAX's shape rule (``flash_packed.supports``), term for term, so
    that ``auto`` resolves as in JAX: T ≤ 512, whole 128-lane head groups
    (``H % max(1, 128 // d) == 0``), d dividing 128 or a multiple of it,
    and JAX's backward VMEM estimate within its budget. Where it holds
    and d ≤ 256 the card has a kernel (:func:`route`)."""
    hp = heads_per_block(head_dim)
    return (
        seq_len <= MAX_T
        and num_heads % hp == 0
        and (head_dim % _LANES == 0 or _LANES % head_dim == 0)
        and _bwd_vmem_bytes(-(-seq_len // 16) * 16, hp * head_dim) <= _VMEM_BUDGET
    )


def route(dtype: torch.dtype, seq_len: int, head_dim: int) -> str:
    """The kernel route of a CUDA call, from the dtype and shape alone:
    ``"wgmma"`` (``csrc/flash_packed.cu``) for bf16 at :data:`HEAD_DIMS`,
    ``"generic"`` (``csrc/flash_generic.cu``) for f32, or bf16 at another
    head dim, up to 256; raises ``NotImplementedError`` naming what is
    taken for anything else (T past :data:`MAX_T`, f16, head dims past
    256)."""
    if seq_len > MAX_T:
        raise NotImplementedError(
            f"the packed attention kernels take T <= {MAX_T}, got T={seq_len}")
    if dtype not in (torch.bfloat16, torch.float32) or not 1 <= head_dim <= 256:
        raise NotImplementedError(
            f"the packed attention kernels take bf16 or f32 at head dims 1..256 on the card, "
            f"got {dtype} at head dim {head_dim}")
    return "wgmma" if dtype == torch.bfloat16 and head_dim in HEAD_DIMS else "generic"


def stats_rows(seq_len: int) -> int:
    """Rows per head of the backward's statistics scratch: T rounded up
    to whole 128-row blocks."""
    return -(-seq_len // STATS_TILE) * STATS_TILE


def _split(qkv: torch.Tensor, num_heads: int):
    """``q, k, v`` as ``[B, T, H, d]`` views of the packed projection."""
    b, t, three_hd = qkv.shape
    d = three_hd // 3 // num_heads
    return qkv.view(b, t, 3, num_heads, d).unbind(2)


def _probs(q, k, causal: bool, scale: float):
    """``(p [B, H, T, T] f32, l [B, H, T, 1] f32, m [B, H, T, 1] f32)``:
    ``exp(s − m)`` on the kept entries (0 elsewhere), its row sums (1
    where 0) and the row max of the masked scores."""
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask.tril()
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return p, torch.where(l == 0.0, 1.0, l), m


def fused_qkv_attention_plain(qkv: torch.Tensor, num_heads: int, causal: bool,
                              scale: float) -> torch.Tensor:
    """The forward kernel's math in plain PyTorch (any device):
    ``[B, T, H·d]`` in ``qkv.dtype``."""
    q, k, v = _split(qkv, num_heads)
    p, l, _ = _probs(q, k, causal, scale)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    b, t, _, _ = q.shape
    return (acc / l).to(qkv.dtype).permute(0, 2, 1, 3).reshape(b, t, -1)


def fused_qkv_attention_backward_plain(qkv: torch.Tensor, out: torch.Tensor,
                                       do: torch.Tensor, num_heads: int, causal: bool,
                                       scale: float) -> torch.Tensor:
    """The backward kernel's math in plain PyTorch (any device): the
    packed ``dqkv [B, T, 3·H·d]`` in ``qkv.dtype``."""
    q, k, v = _split(qkv, num_heads)
    b, t, h, d = q.shape
    o4, do4 = out.reshape(b, t, h, d).float(), do.reshape(b, t, h, d).float()
    p, l, _ = _probs(q, k, causal, scale)
    pn = p / l
    delta = _deltas(o4, do4)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", do4, v.float())
    ds = (pn * (dp - delta) * scale).to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pn.to(qkv.dtype).float(), do4)
    return torch.stack([dq, dk, dv], dim=2).to(qkv.dtype).reshape(b, t, 3 * h * d)


def _deltas(o4: torch.Tensor, do4: torch.Tensor) -> torch.Tensor:
    """``Δ = rowsum(f32(dO)·f32(o))`` of ``[B, T, H, d]`` views: ``[B, H, T]``."""
    return (do4.float() * o4.float()).sum(-1).permute(0, 2, 1)


def backward_row_stats_plain(qkv: torch.Tensor, out: torch.Tensor, do: torch.Tensor,
                             num_heads: int, causal: bool, scale: float) -> torch.Tensor:
    """The backward's per-row statistics in plain PyTorch (any device):
    ``[3, B·H, T]`` f32 holding the row max ``m`` of the masked scores,
    ``1/l`` (``l = Σ exp(s − m)`` over the kept keys, 1 where 0) and
    ``Δ = rowsum(f32(dO)·f32(o))``. The dq kernel writes these to its
    scratch (``[3, B·H, stats_rows(T)]``; rows past T hold m = −1e30,
    1/l = 1, Δ = 0) and the dk/dv kernel reads them."""
    q, k, _ = _split(qkv, num_heads)
    b, t, h, d = q.shape
    _, l, m = _probs(q, k, causal, scale)
    delta = _deltas(out.reshape(b, t, h, d), do.reshape(b, t, h, d))
    return torch.stack([m[..., 0], 1.0 / l[..., 0], delta]).reshape(3, b * h, t)


def _geometry(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3:
        raise ValueError(f"expected packed [B, T, 3*H*d], got {tuple(qkv.shape)}")
    b, t, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} not divisible by 3·{num_heads}")
    return b, t, three_hd // 3 // num_heads


def _check_cuda(qkv: torch.Tensor, num_heads: int, *rows: torch.Tensor):
    """What the kernels take: contiguous ``qkv`` (and ``out``, ``dout``
    shaped ``[B, T, H·d]``) of one dtype on one device, a dtype and shape
    :func:`route` sends to a kernel. Returns ``(b, t, d, route)``."""
    b, t, d = _geometry(qkv, num_heads)
    path = route(qkv.dtype, t, d)
    for x in (qkv,) + rows:
        if x.device != qkv.device:
            raise ValueError(f"tensors on {x.device} and {qkv.device}")
        if x.dtype != qkv.dtype:
            raise NotImplementedError(
                f"the packed attention kernels take one dtype, got {x.dtype} and {qkv.dtype}")
    for x in rows:
        if x.shape != (b, t, num_heads * d):
            raise ValueError(f"expected [{b}, {t}, {num_heads * d}], got {tuple(x.shape)}")
    return b, t, d, path


def _packed(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start (a copy only when
    not)."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _library() -> ctypes.CDLL:
    return bind(_build.load("flash_packed"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and return types on ``lib``
    (a build of ``csrc/flash_packed.cu``)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    lib.fused_qkv_fwd.argtypes = [p, p] + [i] * 5 + [f, i, p]
    lib.fused_qkv_bwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
    lib.fused_qkv_fwd.restype = lib.fused_qkv_bwd.restype = ctypes.c_int
    return lib


def _count(op: str, path: str) -> None:
    global launches
    launches += 1
    launches_by_op[op] += 1
    launches_by_route[path] += 1
    if path == "generic":
        generic_launches_by_op[op] += 1


def _launch(op: str, device: torch.device, *args) -> None:
    """Call the C entry point ``op`` of ``csrc/flash_packed.cu`` on
    ``device``'s current stream (the stream autograd runs the backward
    on), raise on a launch error and count the call (one, whatever
    kernels it launches)."""
    fn = getattr(_library(), op)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {rc}")
    _count(op, "wgmma")


def fused_qkv_forward(qkv: torch.Tensor, num_heads: int, causal: bool, scale: float, *,
                      drop_last_tile: bool = False, return_lse: bool = False):
    """Launch the forward of :func:`route`'s route on a CUDA
    ``[B, T, 3·H·d]``: ``out [B, T, H·d]`` (with ``return_lse``, ``(out,
    lse)``: the rows' f32 ``[B·H, T]`` LSE on the generic route, which
    its backward reads, and ``None`` on the wgmma route, whose backward
    recomputes its statistics). ``drop_last_tile`` skips each row's (the
    wgmma route: each 128-query block's) last key tile: a wrong variant,
    only for a negative control."""
    b, t, d, path = _check_cuda(qkv, num_heads)
    qkv = _packed(qkv)
    out = torch.empty(b, t, num_heads * d, dtype=qkv.dtype, device=qkv.device)
    lse = None
    if path == "wgmma":
        _launch("fused_qkv_fwd", qkv.device, qkv.data_ptr(), out.data_ptr(), b, t, num_heads, d,
                int(causal), scale, int(drop_last_tile))
    else:
        q, k, v = _split(qkv, num_heads)
        o4 = out.view(b, t, num_heads, d)
        lse = torch.empty(b * num_heads, t, dtype=torch.float32, device=qkv.device)
        flash.call_generic(
            "flash_generic_fwd", qkv.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o4.data_ptr(), lse.data_ptr(), flash._strides(q, k, v, o4), b, num_heads, t, t, d,
            int(causal), scale, flash._DTYPE_CODE[qkv.dtype], 1, int(drop_last_tile))
        _count("fused_qkv_fwd", "generic")
    return (out, lse) if return_lse else out


def fused_qkv_backward(qkv: torch.Tensor, out: torch.Tensor, do: torch.Tensor, num_heads: int,
                       causal: bool, scale: float, *, lse: Optional[torch.Tensor] = None,
                       return_stats: bool = False):
    """Launch the backward of :func:`route`'s route on CUDA tensors: the
    packed ``dqkv [B, T, 3·H·d]``. The generic route needs the forward's
    ``lse``; the wgmma route recomputes its statistics and, with
    ``return_stats``, also returns the rows < T of its statistics
    scratch, ``[3, B·H, T]`` as :func:`backward_row_stats_plain`."""
    b, t, d, path = _check_cuda(qkv, num_heads, out, do)
    qkv, out, do = _packed(qkv), _packed(out), _packed(do)
    dqkv = torch.empty_like(qkv)
    if path == "generic":
        if return_stats:
            raise ValueError("return_stats reads the wgmma route's statistics scratch")
        if lse is None or lse.shape != (b * num_heads, t) or lse.dtype != torch.float32:
            raise ValueError(f"the generic route's backward needs the forward's f32 LSE "
                             f"[{b * num_heads}, {t}]")
        q, k, v = _split(qkv, num_heads)
        dq, dk, dv = _split(dqkv, num_heads)
        o4, do4 = out.view(b, t, num_heads, d), do.view(b, t, num_heads, d)
        delta = flash.flash_delta(o4, do4)
        lse = lse.contiguous()
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do4.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        dims = (b, num_heads, t, t, d, int(causal), scale, flash._DTYPE_CODE[qkv.dtype])
        flash.call_generic("flash_generic_bwd_dq", qkv.device, *ptrs, dq.data_ptr(),
                           flash._strides(q, k, v, do4, dq), *dims)
        flash.call_generic("flash_generic_bwd_dkv", qkv.device, *ptrs, dk.data_ptr(),
                           dv.data_ptr(), flash._strides(q, k, v, do4, dk, dv), *dims)
        _count("fused_qkv_bwd", "generic")
        return dqkv
    stats = torch.empty(3, b * num_heads, stats_rows(t), dtype=torch.float32, device=qkv.device)
    _launch("fused_qkv_bwd", qkv.device, qkv.data_ptr(), out.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), b, t, num_heads, d, int(causal), scale)
    return (dqkv, stats[..., :t]) if return_stats else dqkv


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_qkv_attention: unsupported device {x.device}")
    return x.device.type == "cpu"


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, causal, scale):
        lse = None
        if _on_cpu(qkv):
            out = fused_qkv_attention_plain(qkv, num_heads, causal, scale)
        else:
            out, lse = fused_qkv_forward(qkv, num_heads, causal, scale, return_lse=True)
        # The generic route's backward reads the forward's LSE ([B·H, T]
        # f32); the wgmma route's recomputes its statistics (lse None).
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.causal, ctx.scale = num_heads, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        args = (ctx.num_heads, ctx.causal, ctx.scale)
        if _on_cpu(qkv):
            dqkv = fused_qkv_attention_backward_plain(qkv, out, do, *args)
        else:
            dqkv = fused_qkv_backward(qkv, out, do, *args, lse=lse)
        return dqkv, None, None, None


def fused_qkv_attention(qkv: torch.Tensor, num_heads: int, *, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over a packed ``[B, T, 3·H·d]`` QKV tensor,
    differentiable in ``qkv``: ``[B, T, H·d]``. Raises ``ValueError``
    where :func:`supports` does not hold (as JAX); ``scale`` defaults to
    ``d ** -0.5``."""
    _, t, d = _geometry(qkv, num_heads)
    if not supports(t, num_heads, d):
        raise ValueError(
            f"unsupported shape for packed attention: T={t}, H={num_heads}, d={d} "
            f"(need T <= {MAX_T}, whole 128-lane head groups)")
    scale = float(scale) if scale is not None else d ** -0.5
    return _FusedQKVAttention.apply(qkv, num_heads, bool(causal), scale)


__all__ = [
    "HEAD_DIMS",
    "MAX_T",
    "backward_row_stats_plain",
    "fused_qkv_attention",
    "fused_qkv_attention_backward_plain",
    "fused_qkv_attention_plain",
    "fused_qkv_backward",
    "fused_qkv_forward",
    "generic_launches_by_op",
    "launches",
    "launches_by_op",
    "launches_by_route",
    "route",
    "stats_rows",
    "supports",
]
