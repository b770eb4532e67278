"""Flash attention: the port of ``distributeddeeplearning_tpu/ops/pallas/flash.py``.

:func:`flash_attention` is the ``impl="pallas"`` path of
``ops/attention.dot_product_attention`` (the LM's full-sequence
attention in training). Over BTHD ``[batch, seq, heads, head_dim]``
tensors, as in JAX; it is a ``torch.autograd.Function`` whose forward
saves ``(q, k, v, out, lse)`` and whose backward computes ``Δ =
rowsum(do·o)`` in f32, then the dq and dk/dv kernels (the JAX custom
VJP ``_flash_fwd_rule`` / ``_flash_bwd_rule``).

On a CUDA tensor each step launches a hand-written Hopper kernel of
``csrc/flash.cu`` (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``;
each launch counted in :data:`launches` and :data:`launches_by_op`):
bf16 only, head dim 32, 64, 96 or 128; any other dtype or head dim
raises ``NotImplementedError``. The kernels read q, k and v by TMA
through tensor maps over their strided views (the slices of the packed
qkv projection need no copy; LSE and Δ must start 16-byte aligned) and
write ``out`` BTHD. On a CPU tensor it runs the plain versions,
:func:`flash_forward_plain` and :func:`flash_backward_plain`; any other
device raises.

Numerics (the JAX kernels' rounding points): scores ``f32(q·kᵀ)·scale``,
masked keys at the finite ``-1e30``, online softmax in f32, ``p``
rounded to ``v.dtype`` before ``p·v``, ``lse = m + log l`` (``l == 0``
taken as 1); backward ``p = exp(s − lse)``, ``ds = p·(dp − Δ)·scale``,
``bf16(ds)`` before the dq and dk products and ``bf16(p)`` before dv.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.ops import _build

# Kernel launches since the last reset, in all and by kernel
# (chip_smoke.py zeroes them before driving the training path and reads
# them after).
launches = 0
launches_by_op: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

NEG_INF = -1e30  # the kernels' finite mask value (flash.py's _NEG_INF)
HEAD_DIMS = (32, 64, 96, 128)


def _mask(tq: int, tk: int, causal: bool, device) -> torch.Tensor:
    """``[tq, tk]`` bool: the keys each query may attend."""
    if not causal:
        return torch.ones(tq, tk, dtype=torch.bool, device=device)
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril()


def flash_forward_plain(q, k, v, causal: bool, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's math in plain PyTorch (any device):
    ``(out [B, Tq, H, d] in q.dtype, lse [B·H, Tq] f32)``. One softmax
    over all keys instead of the online recurrence (the same function;
    the sums run in another order)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(tq, tk, causal, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_safe)).reshape(b * h, tq)
    return out, lse


def flash_delta(out, do) -> torch.Tensor:
    """``Δ = rowsum(f32(do)·f32(out))`` as ``[B·H, Tq]`` f32."""
    b, tq, h, _ = out.shape
    return (do.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, tq).contiguous()


def _probs_plain(q, k, lse, causal: bool, scale: float):
    """``p [B, H, Tq, Tk]`` in f32: ``exp(s − lse)`` on the kept keys."""
    b, tq, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(tq, k.shape[1], causal, q.device)
    return torch.where(mask, torch.exp(s - lse.reshape(b, h, tq, 1)), 0.0)


def _ds_plain(p, v, do, delta, scale: float):
    b, tq, h, _ = do.shape
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p * (dp - delta.reshape(b, h, tq, 1)) * scale


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    """The dq kernel's function in f32 (``_flash_bwd_scan``'s math):
    ``dq = Σ_k ds·k`` in ``q.dtype``."""
    ds = _ds_plain(_probs_plain(q, k, lse, causal, scale), v, do, delta, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in f32: ``dk = Σ_q dsᵀ·q``, ``dv =
    Σ_q pᵀ·do`` in the dtypes of ``k`` and ``v``."""
    p = _probs_plain(q, k, lse, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    ds = _ds_plain(p, v, do, delta, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, out, lse, do, causal: bool,
                         scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtypes: the math of the JAX
    package's ``_flash_bwd_scan`` (all in f32), over all keys at once."""
    delta = flash_delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    return (dq, *flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a view the kernels read: last dim contiguous, 16-byte
    aligned rows (a copy only when the view is not)."""
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        return x.contiguous()
    return x


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 4:
        raise ValueError(f"expected BTHD [b, t, h, d], got shape {tuple(q.shape)}")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention requires equal q/k lengths")
    if k.shape != v.shape or k.dim() != 4 or (k.shape[0], k.shape[2], k.shape[3]) != (
            q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(
            f"k and v must be [b, tk, h, d] for q {tuple(q.shape)}, got "
            f"{tuple(k.shape)}, {tuple(v.shape)}")


def _check_cuda(q, k, v, causal: bool, do=None, rows=()) -> None:
    """What the kernels take: BTHD bf16 q, k, v (and dO shaped as q) on
    one device, a head dim they are built for, and f32 contiguous
    ``[B·H, Tq]`` per-row vectors (LSE, Δ)."""
    _check_shapes(q, k, v, causal)
    xs = (q, k, v) if do is None else (q, k, v, do)
    if do is not None and do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for x in xs + tuple(rows):
        if x.device != q.device:
            raise ValueError(f"tensors on {x.device} and {q.device}")
    for x in xs:
        if x.dtype != torch.bfloat16:
            raise NotImplementedError(
                f"the flash kernels take bf16 on the card, got {x.dtype}")
    b, tq, h, d = q.shape
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels take head dims {HEAD_DIMS}, got {d}")
    for r in rows:
        if (r.shape != (b * h, tq) or r.dtype != torch.float32 or not r.is_contiguous()
                or r.data_ptr() % 16):
            raise ValueError(
                f"LSE and delta must be contiguous 16-byte aligned f32 [{b * h}, {tq}], got "
                f"{r.dtype} {tuple(r.shape)}")


def _strides(*xs: torch.Tensor):
    vals = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _library() -> ctypes.CDLL:
    return bind(_build.load("flash"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures on a loaded ``flash.cu``
    library (the package's build, or an ablation build)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.POINTER(ctypes.c_longlong)
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    lib.flash_fwd.argtypes = [p] * 5 + [ll] + [i] * 6 + [f, i, p]
    lib.flash_bwd_dq.argtypes = [p] * 7 + [ll] + [i] * 6 + [f, p]
    lib.flash_bwd_dkv.argtypes = [p] * 8 + [ll] + [i] * 6 + [f, p]
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _launch(op: str, device: torch.device, *args) -> None:
    """Call the C entry point ``op`` on ``device``'s current stream (the
    stream autograd runs the backward on), raise on a launch error and
    count the launch."""
    global launches
    fn = getattr(_library(), op)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{op} launch failed: CUDA error {rc}")
    launches += 1
    launches_by_op[op] += 1


def flash_forward(q, k, v, causal: bool, scale: float, *,
                  drop_last_tile: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd`` on CUDA bf16 BTHD views: ``(out, lse)``.
    ``drop_last_tile`` skips each row's last key tile: a wrong variant,
    only for a negative control."""
    _check_cuda(q, k, v, causal)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, tq, h, d = q.shape
    out = torch.empty(b, tq, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b * h, tq, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, out), b, h, tq, k.shape[1], d, int(causal),
            scale, int(drop_last_tile))
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float) -> torch.Tensor:
    """Launch ``flash_bwd_dq`` on CUDA bf16 BTHD views: ``dq`` BTHD."""
    _check_cuda(q, k, v, causal, do, (lse, delta))
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do)
    b, tq, h, d = q.shape
    dq = torch.empty(b, tq, h, d, dtype=q.dtype, device=q.device)
    _launch("flash_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _strides(q, k, v, do, dq), b, h,
            tq, k.shape[1], d, int(causal), scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dkv`` on CUDA bf16 BTHD views: ``(dk, dv)``
    BTHD."""
    _check_cuda(q, k, v, causal, do, (lse, delta))
    q, k, v, do = _rows(q), _rows(k), _rows(v), _rows(do)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dk = torch.empty(b, tk, h, d, dtype=k.dtype, device=q.device)
    dv = torch.empty(b, tk, h, d, dtype=v.dtype, device=q.device)
    _launch("flash_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), b, h, tq, tk, d, int(causal), scale)
    return dk, dv


def flash_backward(q, k, v, out, lse, do, causal: bool,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``Δ`` (a torch op, as JAX computes it outside its kernels), then
    the dq and dk/dv kernels: ``(dq, dk, dv)`` BTHD."""
    delta = flash_delta(out, do)
    lse = lse.contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))


def _device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {x.device}")
    return x.device.type


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _device_type(q) == "cpu":
            out, lse = flash_forward_plain(q, k, v, causal, scale)
        else:
            out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if _device_type(q) == "cpu":
            grads = flash_backward_plain(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        else:
            grads = flash_backward(q, k, v, out, lse, do, ctx.causal, ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over BTHD ``[batch, seq, heads, head_dim]``
    tensors; differentiable in ``q``, ``k`` and ``v``. Causal use needs
    equal query and key lengths (self-attention); ``scale`` defaults to
    ``head_dim ** -0.5``."""
    _check_shapes(q, k, v, causal)
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), scale)


__all__ = [
    "bind",
    "flash_attention",
    "flash_backward",
    "flash_backward_plain",
    "flash_bwd_dkv",
    "flash_bwd_dkv_plain",
    "flash_bwd_dq",
    "flash_bwd_dq_plain",
    "flash_delta",
    "flash_forward",
    "flash_forward_plain",
    "launches",
    "launches_by_op",
]
