"""Stride-1 SAME depthwise convolution: the port of
``distributeddeeplearning_tpu/ops/pallas/depthwise.py``.

:func:`depthwise_conv2d` takes ``x`` ``[N, C, H, W]`` (kept in
``channels_last`` memory, so it is NHWC like the JAX input) and the
grouped-conv weight ``[C, 1, k, k]``, the arguments of
``F.conv2d(x, weight, padding=k // 2, groups=C)``, and returns the same
function with f32 accumulation, in ``x.dtype``. Inside, the weight
becomes JAX's ``[k², C]`` f32 tap table (``depthwise.py:247``). It is a
``torch.autograd.Function`` whose backward is JAX's custom VJP: ``dx``
is the same stencil on ``dy`` with the taps reversed, ``dw`` the sum
over images and positions of ``xpad·dy`` per tap, accumulated in f32 and
returned in the weight's dtype.

On a CUDA tensor each of the three launches the hand-written Hopper
kernels of ``csrc/depthwise.cu`` (bf16 or f32; the stencil by the path
:func:`stencil_path` picks, the wgrad by :func:`wgrad_path` under the
plan of ``csrc/depthwise_plan.h``; counted in
:data:`launches` and :data:`launches_by_op`); on a CPU tensor it runs
the plain version (:func:`stencil_plain`, :func:`wgrad_plain`); any
other device raises. An unsupported shape raises ``ValueError``, as
JAX's does: the function never hands a shape to ``F.conv2d``.

:func:`supports` keeps JAX's shape rule (stride 1, odd ``k > 1``,
``h, w >= k``) without its VMEM-fit term, which is the TPU's: the
kernels tile any image.

The JAX package keeps its kernel flag-off, and so does the port: no
model calls this function (EfficientNet's depthwise convs are cuDNN's
grouped convs, as they are XLA's in JAX). ``chip_smoke.py`` drives it
on EfficientNet-B4's own layers.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.ops import _build

# Kernel launches since the last reset, in all and by op; the forward
# and the dgrad are one stencil kernel (chip_smoke.py zeroes these
# before the pass it drives and reads them after).
launches = 0
launches_by_op: Dict[str, int] = {"depthwise_conv": 0, "depthwise_dgrad": 0,
                                  "depthwise_wgrad": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # csrc/depthwise.cu's `dtype`
_PATHS = {"tma": 0, "tile": 1, "direct": 2}  # csrc/depthwise.cu's `path`
_TMA_MAX_W = 1024  # the vector kernel's ring of whole rows, a 16-byte vector wide, fits
# csrc/depthwise_plan.h's wgrad_plan_ints, in order.
_WG_FIELDS = ("cs", "cslices", "tw", "ctiles", "rows", "strips", "box_w", "ring", "run", "vec",
              "consumers", "smem", "partials", "items")


def stencil_path(b: int, h: int, w: int, c: int, k: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """Which stencil kernel a shape takes (forward and dgrad): ``"tma"``,
    the row ring fed by a 4-D tensor map, where one can describe x (k in
    {3, 5, 7}, rows of C elements a multiple of 16 bytes, x 16-byte
    aligned, W at most 1024); else ``"tile"``, the staged-tile kernel,
    for k in {3, 5, 7}; else ``"direct"`` (one thread an output). A
    function of the shape, dtype and alignment alone."""
    if k not in (3, 5, 7):
        return "direct"
    elem = 2 if dtype == torch.bfloat16 else 4
    if (c * elem) % 16 or not aligned or w > _TMA_MAX_W:
        return "tile"
    return "tma"


_WGRAD_TILE_F32_MAX_W = 24  # f32 rows this narrow: the staged tile measured faster


def wgrad_path(b: int, h: int, w: int, c: int, k: int, dtype: torch.dtype,
               aligned: bool = True) -> str:
    """Which wgrad kernels a shape takes: :func:`stencil_path`'s rule,
    except that f32 rows of at most 24 columns take the staged tile
    (``"tile"``) where a tensor map could take them: on B4's layers in
    f32 at batch 8 the staged tile beat the TMA ring at every such layer
    and lost at every wider one (``scripts/depthwise_ablation.py``,
    PERF.md). A function of the shape, dtype and alignment alone."""
    path = stencil_path(b, h, w, c, k, dtype, aligned)
    if path == "tma" and dtype == torch.float32 and w <= _WGRAD_TILE_F32_MAX_W:
        return "tile"
    return path


def _plan_library() -> ctypes.CDLL:
    lib = _build.load("depthwise_plan")
    lib.depthwise_wgrad_plan_host.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.depthwise_wgrad_plan_host.restype = ctypes.c_int
    return lib


def _plan_dict(path: str, ints) -> dict:
    if path != "tma":
        return {"path": path, "partials": ints[12]}
    return dict(zip(_WG_FIELDS, ints), path=path)


def wgrad_plan(b: int, h: int, w: int, c: int, k: int, dtype: torch.dtype, aligned: bool = True,
               sm_count: int = 132, per_sm: int = 2) -> dict:
    """How the wgrad cuts a call, from shapes alone: ``path`` as
    :func:`wgrad_path`, and ``partials``, the partial rows (each
    ``[k², C]`` f32) its blocks write before one kernel sums them in a
    fixed order. The plan is ``csrc/depthwise_plan.h``'s, the one the
    card runs, built here for the host (``csrc/depthwise_plan.cpp``), so
    it needs a C++ compiler but no card.

    On the TMA path an item is (image, strip of ``rows`` output rows,
    column tile of ``tw`` columns, slice of ``cs`` channels); a compute
    thread owns ``run`` columns x ``vec`` channels and keeps their k²
    sums in registers across the strip; the ring holds ``ring`` slots of
    an x row and a dy row; one partial row per (image, strip, column
    tile), ``items`` blocks. The strips fill ``sm_count`` SMs at
    ``per_sm`` blocks each (the plan's aim, two; on the card the kernel's
    occupancy, :func:`wgrad_plan_for`). The staged-tile path writes one
    partial row per (image, 12 columns); the direct path none."""
    path = wgrad_path(b, h, w, c, k, dtype, aligned)
    ints = (ctypes.c_int * len(_WG_FIELDS))()
    if _plan_library().depthwise_wgrad_plan_host(b, h, w, c, k, _DTYPES[dtype], _PATHS[path],
                                                 sm_count, per_sm, ints) != 0:
        raise ValueError(f"no wgrad plan for {b}x{h}x{w}x{c} k{k} {dtype} on the {path} path")
    return _plan_dict(path, list(ints))


def supports(h: int, w: int, c: int, k: int, stride: int) -> bool:
    """Stride-1 SAME odd-k depthwise layers (``depthwise.py:85-98``
    without the VMEM term)."""
    return stride == 1 and k % 2 == 1 and k > 1 and h >= k and w >= k and c >= 1


def weight_taps(weight: torch.Tensor) -> torch.Tensor:
    """``[C, 1, k, k]`` -> the ``[k², C]`` f32 tap table, tap ``di·k + dj``."""
    c, _, k, _ = weight.shape
    return weight.reshape(c, k * k).t().float().contiguous()


def _check(x: torch.Tensor, k: int, c: int) -> None:
    if x.dim() != 4 or x.shape[1] != c:
        raise ValueError(f"expected [N, C={c}, H, W], got {tuple(x.shape)}")
    if not supports(x.shape[2], x.shape[3], c, k, 1):
        raise ValueError(f"unsupported depthwise shape {tuple(x.shape)} k={k}")


def stencil_plain(x: torch.Tensor, taps: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """``Σ_t xpad[:, :, i+di, j+dj]·taps[t]`` over the ``k²`` taps, the
    padded input and the sum in f32 (f64 for f64 inputs), in
    ``x.dtype``: ``_stencil_strip``'s arithmetic, any device. ``flip``
    reverses the taps (the dgrad)."""
    k = int(round(taps.shape[0] ** 0.5))
    _check(x, k, taps.shape[1])
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    p, (h, w) = k // 2, x.shape[2:]
    xp = F.pad(x.to(acc_dtype), (p, p, p, p))
    wt = (taps.flip(0) if flip else taps).to(acc_dtype)
    acc = torch.zeros(x.shape, dtype=acc_dtype, device=x.device)
    for di in range(k):
        for dj in range(k):
            acc = acc + xp[:, :, di:di + h, dj:dj + w] * wt[di * k + dj][None, :, None, None]
    return acc.to(x.dtype)


def wgrad_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """``dw[di·k + dj, c] = Σ_{n,i,j} xpad[n, c, i+di, j+dj]·dy[n, c, i, j]``,
    ``[k², C]`` in f32 (f64 for f64 inputs), any device."""
    _check(x, k, x.shape[1])
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    p, (h, w) = k // 2, x.shape[2:]
    xp = F.pad(x.to(acc_dtype), (p, p, p, p))
    g = dy.to(acc_dtype)
    return torch.stack([(xp[:, :, di:di + h, dj:dj + w] * g).sum((0, 2, 3))
                        for di in range(k) for dj in range(k)])


def _library() -> ctypes.CDLL:
    lib = _build.load("depthwise")
    p, i = ctypes.c_void_p, ctypes.c_int
    # Pointers as c_void_p: without argtypes ctypes would pass 32 bits.
    lib.depthwise_stencil.argtypes = [p] * 3 + [i] * 8 + [p]
    lib.depthwise_stencil.restype = i
    lib.depthwise_wgrad.argtypes = [p] * 4 + [i] * 8 + [p]
    lib.depthwise_wgrad.restype = i
    lib.depthwise_wgrad_plan.argtypes = [i] * 7 + [p]
    lib.depthwise_wgrad_plan.restype = i
    return lib


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def _cuda_args(x: torch.Tensor):
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"the depthwise kernels take bf16 or f32, got {x.dtype}")
    n, c, h, w = x.shape
    return n, h, w, c, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream


def stencil_cuda(x: torch.Tensor, taps: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """Launch the stencil kernel :func:`stencil_path` names on a CUDA
    ``x`` (bf16 or f32): the forward, or with ``flip`` the dgrad. On the
    TMA path the source picks its vector kernel (16-byte channel vectors,
    taps in shared memory) at k = 3 on rows wider than 12 and its lane
    kernel (a channel a lane, taps in registers) else. Returns
    ``x.dtype``, channels_last."""
    global launches
    k = int(round(taps.shape[0] ** 0.5))
    _check(x, k, taps.shape[1])
    if taps.device != x.device:
        raise ValueError(f"tensors on {x.device} and {taps.device}")
    x, taps = _nhwc(x), taps.float().contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    n, h, w, c, dtype, stream = _cuda_args(x)
    path = stencil_path(n, h, w, c, k, x.dtype, x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        rc = _library().depthwise_stencil(x.data_ptr(), taps.data_ptr(), y.data_ptr(),
                                          n, h, w, c, k, dtype, int(flip), _PATHS[path],
                                          stream)
    if rc != 0:
        raise RuntimeError(f"depthwise stencil ({path}) launch failed: CUDA error {rc}")
    launches += 1
    launches_by_op["depthwise_dgrad" if flip else "depthwise_conv"] += 1
    return y


def wgrad_plan_for(x: torch.Tensor, dy: torch.Tensor, k: int) -> dict:
    """The plan :func:`wgrad_cuda` runs on CUDA ``x`` and ``dy`` (NHWC),
    as the loaded library computes it on their card (its SM count, the
    kernel's occupancy, the library's build constants): the fields of
    :func:`wgrad_plan`."""
    n, c, h, w = x.shape
    path = wgrad_path(n, h, w, c, k, x.dtype, x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0)
    ints = (ctypes.c_int * len(_WG_FIELDS))()
    with torch.cuda.device(x.device):
        rc = _library().depthwise_wgrad_plan(n, h, w, c, k, _cuda_args(x)[4], _PATHS[path], ints)
    if rc != 0:
        raise RuntimeError(f"depthwise wgrad plan ({path}) failed: CUDA error {rc}")
    return _plan_dict(path, list(ints))


def wgrad_cuda(x: torch.Tensor, dy: torch.Tensor, k: int, *,
               drop_last_partial: bool = False) -> torch.Tensor:
    """Launch the wgrad kernels on CUDA ``x`` and ``dy`` of one dtype
    under :func:`wgrad_plan_for` (per-block partial rows, then their sum in
    a fixed order): ``[k², C]`` f32. ``drop_last_partial`` leaves the
    last partial row out of the sum: a wrong variant, only for negative
    controls (not on the direct path, which has none)."""
    global launches
    _check(x, k, x.shape[1])
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    x, dy = _nhwc(x), _nhwc(dy)
    n, h, w, c, dtype, stream = _cuda_args(x)
    plan = wgrad_plan_for(x, dy, k)
    if drop_last_partial and not plan["partials"]:
        raise ValueError("the direct wgrad has no partial rows to drop")
    part = torch.empty(max(plan["partials"], 1), k * k, c, dtype=torch.float32, device=x.device)
    dw = torch.empty(k * k, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().depthwise_wgrad(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h, w, c, k, dtype,
            _PATHS[plan["path"]], int(drop_last_partial), stream)
    if rc != 0:
        raise RuntimeError(f"depthwise wgrad ({plan['path']}) launch failed: CUDA error {rc}")
    launches += 1
    launches_by_op["depthwise_wgrad"] += 1
    return dw


def stencil(x: torch.Tensor, taps: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """The stencil: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if x.device.type == "cuda":
        return stencil_cuda(x, taps, flip)
    if x.device.type == "cpu":
        return stencil_plain(x, taps, flip)
    raise ValueError(f"depthwise: unsupported device {x.device}")


def wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, *,
          drop_last_partial: bool = False) -> torch.Tensor:
    """The wgrad: the kernels on CUDA tensors, the plain version on CPU
    tensors. ``drop_last_partial`` is :func:`wgrad_cuda`'s negative
    control; the plain version has no partials, so a CPU tensor raises."""
    if x.device.type == "cuda":
        return wgrad_cuda(x, dy, k, drop_last_partial=drop_last_partial)
    if x.device.type == "cpu":
        if drop_last_partial:
            raise ValueError("drop_last_partial is a control of the CUDA kernels; the plain "
                             "version on the CPU has no partial rows to drop")
        return wgrad_plain(x, dy, k)
    raise ValueError(f"depthwise: unsupported device {x.device}")


class _Depthwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        taps = weight_taps(weight)
        ctx.save_for_backward(x, taps)
        ctx.weight_dtype = weight.dtype
        return stencil(x, taps)

    @staticmethod
    def backward(ctx, dy):
        x, taps = ctx.saved_tensors
        c, k = taps.shape[1], int(round(taps.shape[0] ** 0.5))
        dy = dy.to(x.dtype)
        dx = stencil(dy, taps, flip=True) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = wgrad(x, dy, k).t().reshape(c, 1, k, k).to(ctx.weight_dtype)
        return dx, dw


def depthwise_conv2d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME depthwise conv of ``x`` ``[N, C, H, W]`` with the
    grouped-conv weight ``[C, 1, k, k]``; ``F.conv2d(x, weight,
    padding=k // 2, groups=C)`` with f32 accumulation, in ``x.dtype``.
    Raises ``ValueError`` where :func:`supports` does not hold."""
    if weight.dim() != 4 or weight.shape[1] != 1 or weight.shape[2] != weight.shape[3]:
        raise ValueError(f"expected a [C, 1, k, k] weight, got {tuple(weight.shape)}")
    _check(x, weight.shape[2], weight.shape[0])
    if weight.device != x.device:
        raise ValueError(f"tensors on {x.device} and {weight.device}")
    return _Depthwise.apply(x, weight)


def depthwise_conv2d_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """:func:`depthwise_conv2d`'s forward in plain PyTorch, any device."""
    return stencil_plain(x, weight_taps(weight))


__all__ = ["depthwise_conv2d", "depthwise_conv2d_plain", "launches", "launches_by_op",
           "stencil", "stencil_cuda", "stencil_path", "stencil_plain", "supports", "weight_taps",
           "wgrad", "wgrad_cuda", "wgrad_path", "wgrad_plain", "wgrad_plan", "wgrad_plan_for"]
