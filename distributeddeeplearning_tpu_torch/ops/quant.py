"""Symmetric int8 / fp8 quantization for the serving tier (port of
``distributeddeeplearning_tpu/ops/quant.py``).

Decode streams the whole parameter set and the whole KV pool every
step, so its speed follows the bytes it reads. This module stores both
in 8 bits with f32 scales:

* **weights** per output channel: every 2-D Dense ``weight`` (``[out,
  in]`` in the port, so the scale reduces the last axis, where flax's
  ``[in, out]`` kernel reduces the first) and the tied ``tok_embed``
  (``[V, H]``, one scale per vocab row). :func:`quantize_params` is a
  one-shot pass over a state dict; :func:`quantize_module_` swaps a
  module's parameter for ``<name>_q`` / ``<name>_scale`` buffers, and
  :func:`weight` dequantizes them on use;
* **KV cache** per head per position (``models/vit.Attention`` with a
  quantized :class:`~..models.vit.KVCache`): writes quantize, reads
  dequantize to the compute dtype (in registers, on the fused kernel).

The arithmetic is the JAX package's, operation for operation, so the
codes, scales and dequantized values are bitwise JAX's: ``x`` in f32,
``scale = amax / 127`` (``amax / 448`` for fp8 e4m3fn), 1 where
``amax == 0``; ``q = clip(round(x / scale))`` (round half to even) or
``clip(x / scale)`` cast to fp8 (nearest even; the pre-clip keeps
e4m3fn, which has no infinity, finite); dequantize ``q.float() *
scale``, then cast. Scales keep the reduced axes at size 1.

Dtype names go through one registry (``KV_DTYPES`` / ``WEIGHT_DTYPES``
and :func:`validate_store_dtype`), so every boundary names the same
supported list.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, Optional, Tuple

import torch

# Suffixes a quantized tensor's name takes in a state dict: ``<name>_q``
# holds the codes (int8 or float8_e4m3fn), ``<name>_scale`` the f32 scales.
Q = "_q"
SCALE = "_scale"

_QMAX = 127.0  # int8 range ±127: -128 is unused, so q == -q round-trips

FP8_E4M3 = torch.float8_e4m3fn
FP8_E5M2 = torch.float8_e5m2
FP8_WEIGHT_DTYPE = FP8_E4M3
FP8_KV_DTYPE = FP8_E4M3
_FP8_DTYPES = (FP8_E4M3, FP8_E5M2)

# "bf16" is the native tier: KV stores the compute dtype, weights stay
# as loaded.
KV_DTYPES = ("bf16", "int8", "fp8")
WEIGHT_DTYPES = ("bf16", "int8", "fp8")


def validate_store_dtype(kind: str, value: str, *, extra: Tuple[str, ...] = ()) -> str:
    """One rule for every dtype-name boundary: ``kind`` is the knob
    (``"kv_dtype"`` / ``"weight_dtype"``) and leads the error, ``extra``
    admits boundary-specific aliases. Returns ``value``."""
    table = KV_DTYPES if kind == "kv_dtype" else WEIGHT_DTYPES
    allowed = tuple(extra) + tuple(table)
    if value not in allowed:
        raise ValueError(f"{kind} must be one of {allowed}, got {value!r}")
    return value


@functools.lru_cache(maxsize=8)
def _fp8_probe(device: str) -> bool:
    try:
        q = torch.tensor([0.5, -2.0], device=device).to(FP8_E4M3)
        out = (q.float() * 2.0).cpu()
    except (RuntimeError, TypeError):
        return False
    return torch.equal(out, torch.tensor([1.0, -4.0]))


def fp8_supported(device="cuda") -> bool:
    """Whether ``device`` stores and casts ``float8_e4m3fn``: a real
    round-trip on it, not a check that the dtype exists. Callers treat
    False as "fall back to int8"."""
    return _fp8_probe(str(torch.device(device)))


def kv_store_dtype(kv_dtype: str) -> Optional[torch.dtype]:
    """The dtype a KV cache stores for a registry name; None means
    native (the compute dtype, no scales)."""
    validate_store_dtype("kv_dtype", kv_dtype, extra=("",))
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype == "fp8":
        return FP8_KV_DTYPE
    return None


def quantize_int8(x: torch.Tensor, axis=-1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per slice along ``axis`` (an int
    or a tuple: the reduced axes, kept at size 1). Returns ``(q,
    scale)``."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / _QMAX, 1.0).float()
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def quantize_fp8(x: torch.Tensor, axis=-1,
                 dtype: torch.dtype = FP8_E4M3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric fp8 with :func:`quantize_int8`'s shape contract:
    ``scale = amax / fmax`` maps the slice's amax onto the format's
    largest finite value (448 for e4m3fn)."""
    fmax = float(torch.finfo(dtype).max)
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / fmax, 1.0).float()
    q = torch.clamp(xf / scale, -fmax, fmax).to(dtype)
    return q, scale


def quantize_kv(x: torch.Tensor, kv_dtype: str, axis=-1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KV write path's quantizer for a registry name."""
    if kv_dtype == "fp8":
        return quantize_fp8(x, axis=axis, dtype=FP8_KV_DTYPE)
    return quantize_int8(x, axis=axis)


def dequantize_store(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``: the one decode rule of
    both payload formats."""
    return (q.float() * scale).to(dtype)


dequantize_int8 = dequantize_store
dequantize_fp8 = dequantize_store


# ---------------------------------------------------------------------------
# State-dict pass (inference weights)
# ---------------------------------------------------------------------------

def _is_quantizable(name: str, t: torch.Tensor) -> bool:
    """2-D Dense weights (attention qkv/proj, MLP fc1/fc2, a Dense head)
    and the tied token embedding: what a decode step streams in bulk.
    Biases, norms, positional tables and conv kernels stay as they are."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf in ("weight", "tok_embed") and t.dim() == 2


def _quantize_weight(w: torch.Tensor, dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    # Port layouts put the reduced axis last: Dense [out, in] reduces
    # `in`, tok_embed [V, H] reduces H.
    if dtype == "fp8":
        return quantize_fp8(w, axis=-1, dtype=FP8_WEIGHT_DTYPE)
    return quantize_int8(w, axis=-1)


def _check_quantizing(dtype: str) -> None:
    validate_store_dtype("weight_dtype", dtype)
    if dtype == "bf16":
        raise ValueError(
            "quantize_params quantizes: the native 'bf16' tier means no "
            "pass at all; call sites gate on weight_dtype first"
        )


def quantize_params(state: Dict[str, torch.Tensor],
                    dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """One-shot quantization of a state dict: every quantizable
    ``name`` becomes ``name_q`` (int8 or float8_e4m3fn) and
    ``name_scale`` (f32 ``[rows, 1]``); the rest passes through."""
    _check_quantizing(dtype)
    if is_quantized(state):
        raise ValueError(
            "state dict is already quantized (quantized entries present): "
            "quantize_params is one-shot"
        )
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if _is_quantizable(name, t):
            out[name + Q], out[name + SCALE] = _quantize_weight(t, dtype)
        else:
            out[name] = t
    return out


def dequantize_params(state: Dict[str, torch.Tensor],
                      dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse pass: every ``name_q`` / ``name_scale`` pair collapses
    to a dense ``name`` in ``dtype``."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        if name.endswith(Q):
            base = name[:-len(Q)]
            out[base] = dequantize_store(t, state[base + SCALE], dtype)
        elif not (name.endswith(SCALE) and name[:-len(SCALE)] + Q in state):
            out[name] = t
    return out


def is_quantized(state: Dict[str, torch.Tensor]) -> bool:
    """True if the state dict went through :func:`quantize_params`."""
    return any(name.endswith(Q) for name in state)


def tree_byte_split(state: Dict[str, torch.Tensor]) -> Dict[str, int]:
    """Bytes by kind with the scales itemized: ``{"int8", "fp8",
    "scale", "other"}`` summed over the tensors."""
    out = {"int8": 0, "fp8": 0, "scale": 0, "other": 0}
    for name, t in state.items():
        nbytes = t.numel() * t.element_size()
        if t.dtype == torch.int8:
            out["int8"] += nbytes
        elif t.dtype in _FP8_DTYPES:
            out["fp8"] += nbytes
        elif name.endswith(SCALE):
            out["scale"] += nbytes
        else:
            out["other"] += nbytes
    return out


def quantized_bytes(split: Dict[str, int]) -> int:
    """The 8-bit payload of a :func:`tree_byte_split` result."""
    return split["int8"] + split["fp8"]


# ---------------------------------------------------------------------------
# Modules holding quantized weights (dequantize on use)
# ---------------------------------------------------------------------------

def quantize_module_(module: torch.nn.Module, name: str, dtype: str) -> None:
    """Replace the 2-D parameter ``module.<name>`` by the buffers
    ``<name>_q`` and ``<name>_scale`` (quantized from its current
    values, which should be the f32 ones); no copy in the compute dtype
    stays resident."""
    _check_quantizing(dtype)
    w = getattr(module, name).detach()
    q, scale = _quantize_weight(w, dtype)
    delattr(module, name)
    module.register_buffer(name + Q, q)
    module.register_buffer(name + SCALE, scale)


def is_quantized_module(module: torch.nn.Module, name: str) -> bool:
    return name + Q in module._buffers


def held(module: torch.nn.Module) -> Optional[Dict[str, torch.Tensor]]:
    """The copies :func:`hold_dequantized` made for ``module``, if any."""
    return module.__dict__.get("_held")


def weight(module: torch.nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``module.<name>`` in ``dtype``: the parameter cast, or the codes
    dequantized (``(q.float() * scale).to(dtype)``, the value JAX's
    ``dequantize_params`` gives and flax casts at use), or the copy
    :func:`hold_dequantized` made."""
    copies = held(module)
    if copies is not None and name in copies:
        return copies[name]
    q = module._buffers.get(name + Q)
    if q is None:
        return getattr(module, name).to(dtype)
    return dequantize_store(q, module._buffers[name + SCALE], dtype)


@contextlib.contextmanager
def hold_dequantized(model: torch.nn.Module, dtype: torch.dtype) -> Iterator[None]:
    """Dequantize every quantized weight of ``model`` once, and let every
    forward inside the block use that copy (the speculative draft's K
    steps of a tick, as JAX hoists ``dequantize_params`` out of its
    scan). The copies are dropped on exit."""
    owners = []
    for mod in model.modules():
        names = [n[:-len(Q)] for n in mod._buffers if n.endswith(Q)]
        if names:
            mod._held = {n: dequantize_store(mod._buffers[n + Q],
                                             mod._buffers[n + SCALE], dtype)
                         for n in names}
            owners.append(mod)
    try:
        yield
    finally:
        for mod in owners:
            mod._held = None
