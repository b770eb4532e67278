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

On a CUDA tensor each step launches hand-written Hopper kernels of
``csrc/flash_packed.cu`` (``fused_qkv_fwd``, ``fused_qkv_bwd``; each
call counted once in :data:`launches` and :data:`launches_by_op`): bf16
only, head dim 32, 64 or 128, T ≤ :data:`MAX_T`; anything else raises
``NotImplementedError``. The backward is two kernels on one stream:
dq, which also writes each row's ``m``, ``1/l`` and ``Δ`` to an f32
scratch (:func:`backward_row_stats_plain` is its plain version), then
dk/dv, which reads them. On a CPU tensor it runs the plain versions,
:func:`fused_qkv_attention_plain` and
:func:`fused_qkv_attention_backward_plain`; any other device raises.

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

from distributeddeeplearning_tpu_torch.ops import _build

# Kernel launches since the last reset, in all and by kernel
# (chip_smoke.py zeroes them before driving the training path and reads
# them after).
launches = 0
launches_by_op: Dict[str, int] = {"fused_qkv_fwd": 0, "fused_qkv_bwd": 0}

MAX_T = 512  # the JAX kernel's whole-sequence limit (flash_packed.MAX_T)
NEG_INF = -1e30  # the kernels' finite mask value
HEAD_DIMS = (32, 64, 128)  # csrc/flash_packed.cu's instances
STATS_TILE = 128  # the backward's scratch pads T to whole 128-row blocks
_LANES = 128


def heads_per_block(head_dim: int) -> int:
    """How many heads share one 128-lane block in the JAX kernel."""
    return max(1, _LANES // head_dim)


def supports(seq_len: int, num_heads: int, head_dim: int) -> bool:
    """JAX's shape rule (``flash_packed.supports``), so that ``auto``
    resolves as in JAX: T ≤ 512, whole 128-lane head groups
    (``H % max(1, 128 // d) == 0``), d dividing 128 or a multiple of it;
    and d one of the kernel's :data:`HEAD_DIMS`. JAX's VMEM term is
    left out: its backward estimate stays under its budget for every
    T ≤ 512 and d ≤ 256, so it never binds where the others hold."""
    return (
        seq_len <= MAX_T
        and num_heads % heads_per_block(head_dim) == 0
        and (head_dim % _LANES == 0 or _LANES % head_dim == 0)
        and head_dim in HEAD_DIMS
    )


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
    """What the kernels take: contiguous bf16 ``qkv`` (and ``out``,
    ``dout`` shaped ``[B, T, H·d]``) on one device, a head dim they are
    built for and T ≤ MAX_T."""
    b, t, d = _geometry(qkv, num_heads)
    for x in (qkv,) + rows:
        if x.device != qkv.device:
            raise ValueError(f"tensors on {x.device} and {qkv.device}")
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the packed attention kernels take bf16 on the card, got {x.dtype}")
    for x in rows:
        if x.shape != (b, t, num_heads * d):
            raise ValueError(f"expected [{b}, {t}, {num_heads * d}], got {tuple(x.shape)}")
    if d not in HEAD_DIMS or t > MAX_T:
        raise NotImplementedError(
            f"the packed attention kernels take head dims {HEAD_DIMS} and T <= {MAX_T}, "
            f"got d={d}, T={t}")
    return b, t, d


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


def _launch(op: str, device: torch.device, *args) -> None:
    """Call the C entry point ``op`` on ``device``'s current stream (the
    stream autograd runs the backward on), raise on a launch error and
    count the call (one, whatever kernels it launches)."""
    global launches
    fn = getattr(_library(), op)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {rc}")
    launches += 1
    launches_by_op[op] += 1


def fused_qkv_forward(qkv: torch.Tensor, num_heads: int, causal: bool, scale: float, *,
                      drop_last_tile: bool = False) -> torch.Tensor:
    """Launch ``fused_qkv_fwd`` on a CUDA bf16 ``[B, T, 3·H·d]``: ``out
    [B, T, H·d]``. ``drop_last_tile`` skips each 128-query block's last
    key tile: a wrong variant, only for a negative control."""
    b, t, d = _check_cuda(qkv, num_heads)
    qkv = _packed(qkv)
    out = torch.empty(b, t, num_heads * d, dtype=qkv.dtype, device=qkv.device)
    _launch("fused_qkv_fwd", qkv.device, qkv.data_ptr(), out.data_ptr(), b, t, num_heads, d,
            int(causal), scale, int(drop_last_tile))
    return out


def fused_qkv_backward(qkv: torch.Tensor, out: torch.Tensor, do: torch.Tensor, num_heads: int,
                       causal: bool, scale: float, *, return_stats: bool = False):
    """Launch ``fused_qkv_bwd`` on CUDA bf16 tensors: the packed ``dqkv
    [B, T, 3·H·d]`` (and, with ``return_stats``, the rows < T of the
    statistics scratch, ``[3, B·H, T]`` as :func:`backward_row_stats_plain`)."""
    b, t, d = _check_cuda(qkv, num_heads, out, do)
    qkv, out, do = _packed(qkv), _packed(out), _packed(do)
    dqkv = torch.empty_like(qkv)
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
        if _on_cpu(qkv):
            out = fused_qkv_attention_plain(qkv, num_heads, causal, scale)
        else:
            out = fused_qkv_forward(qkv, num_heads, causal, scale)
        ctx.save_for_backward(qkv, out)
        ctx.num_heads, ctx.causal, ctx.scale = num_heads, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out = ctx.saved_tensors
        args = (ctx.num_heads, ctx.causal, ctx.scale)
        if _on_cpu(qkv):
            dqkv = fused_qkv_attention_backward_plain(qkv, out, do, *args)
        else:
            dqkv = fused_qkv_backward(qkv, out, do, *args)
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
            f"(need T <= {MAX_T}, whole 128-lane head groups, d in {HEAD_DIMS})")
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
    "launches",
    "launches_by_op",
    "stats_rows",
    "supports",
]
