"""Parameters between the JAX package's flax trees and the port's
state dicts, and seeded initialisation.

``TransformerLM`` and ``ViT``: ``block{i}/…`` becomes ``blocks.{i}.…``,
LayerNorm ``scale`` becomes ``weight``, a Dense ``kernel`` ``[in, out]``
becomes a ``weight`` ``[out, in]`` and ViT's patch conv ``kernel`` HWIO
an OIHW ``weight``. Embeddings (``tok_embed`` ``[V, H]``, ``pos_embed``
``[1, L, H]``, ``cls_token`` ``[1, 1, H]``), biases and an MoE block's
``moe`` leaves (``router [d, e]``, ``w1 [e, d, h]``, ``b1``, ``w2 [e, h,
d]``, ``b2``: the port keeps flax's layouts) carry across unchanged. A
tree quantized by the JAX package's ``quant.quantize_params`` carries
across too: a ``kernel`` ``{_q8: [in, out] int8, _q8_scale:
[1, out]}`` (or ``_qf8``/``_qf8_scale`` with float8_e4m3fn codes) becomes
``weight_q`` ``[out, in]`` and ``weight_scale`` ``[out, 1]``, and
``tok_embed``'s pair ``tok_embed_q`` ``[V, H]`` / ``tok_embed_scale``
``[V, 1]`` (the port's ``ops/quant.py`` layout).

``ResNet``: module paths are the flax ones joined by dots (the s2d
stem's ``stem_conv_s2d`` kernel ``[4, 4, 12, 64]`` too). A conv
``kernel`` HWIO ``[kh, kw, in, out]`` becomes an OIHW ``weight`` (the
fused block's ``_Conv1x1Kernel`` ``[1, 1, K, N]`` too: its ``[N, K]``
view is the kernels' ``w``), the Dense head's ``[in, out]`` a ``[out,
in]`` weight, and BN ``scale``/``bias`` (params) and ``mean``/``var``
(batch_stats) ``weight``/``bias``/``running_mean``/``running_var``.
The fused and unfused models share one tree, as in JAX.

``EfficientNet``: ResNet's rules; a depthwise ``kernel`` ``[k, k, 1, C]``
becomes ``[C, 1, k, k]`` and the squeeze-excite convs' ``bias`` carries
across.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models import vit
from distributeddeeplearning_tpu_torch.models.efficientnet import EfficientNet
from distributeddeeplearning_tpu_torch.models.resnet import ResNet
from distributeddeeplearning_tpu_torch.models.transformer_lm import _VARIANTS

_BLOCK = re.compile(r"^block(\d+)$")
# The JAX package's quantized-leaf markers -> the port's name suffixes.
_QUANT_MARKERS = {"_q8": "_q", "_qf8": "_q", "_q8_scale": "_scale", "_qf8_scale": "_scale"}


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def _codes_to_torch(arr: np.ndarray) -> torch.Tensor:
    """int8 or float8_e4m3fn codes (numpy, the latter as ml_dtypes
    stores them) -> a torch tensor of the same bits."""
    if arr.dtype == np.int8:
        return torch.from_numpy(np.ascontiguousarray(arr))
    bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8))
    return bits.view(torch.float8_e4m3fn)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``TransformerLM`` or ``ViT`` param tree (nested mapping of
    arrays, unboxed; quantized or not) -> the port's state dict of CPU
    tensors: f32, with quantized codes in their own dtype."""
    out: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        marker = _QUANT_MARKERS.get(path[-1])
        if marker is not None:
            path = path[:-1]
            arr = np.array(val)
            if marker == "_scale":
                arr = arr.astype(np.float32)
        else:
            arr = np.array(val, np.float32)  # a writable copy
        names = []
        for part in path:
            m = _BLOCK.match(part)
            names.extend(["blocks", m.group(1)] if m else [part])
        if names[-1] == "scale":
            names[-1] = "weight"
        elif names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        if marker == "_q":
            tensor = _codes_to_torch(arr)
        else:
            tensor = torch.from_numpy(np.ascontiguousarray(arr))
        out[".".join(names) + (marker or "")] = tensor
    return out


def _codes_to_numpy(tensor: torch.Tensor) -> np.ndarray:
    t = tensor.detach().cpu()
    if t.dtype == torch.int8:
        return t.numpy()
    import ml_dtypes  # numpy's float8 dtypes, as JAX stores them

    return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax` (numpy leaves)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state.items():
        parts = name.split(".")
        marker = None
        for suffix in ("_q", "_scale"):
            if parts[-1] in (f"weight{suffix}", f"tok_embed{suffix}"):
                parts[-1] = parts[-1][:-len(suffix)]
                marker = suffix
        if marker == "_q":
            arr = _codes_to_numpy(tensor)
        else:
            arr = tensor.detach().float().cpu().numpy()
        if parts[0] == "blocks":
            parts = [f"block{parts[1]}"] + parts[2:]
        if parts[-1] == "weight":
            if arr.ndim == 2:
                parts[-1], arr = "kernel", arr.T
            elif arr.ndim == 4:
                parts[-1], arr = "kernel", arr.transpose(2, 3, 1, 0)
            else:
                parts[-1] = "scale"
        if marker is not None:
            fp8 = state[name[:-len(marker)] + "_q"].dtype != torch.int8
            parts.append(("_qf8" if fp8 else "_q8") + ("_scale" if marker == "_scale" else ""))
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def _xavier(shape, fan_in: int, fan_out: int, generator: torch.Generator) -> torch.Tensor:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(*shape, device=generator.device).uniform_(-bound, bound,
                                                                 generator=generator)


def _init_blocks(out: Dict[str, torch.Tensor], hidden: int, depth: int, mlp_dim: int,
                 generator: torch.Generator, moe_layers=(), moe_experts: int = 0) -> None:
    """The transformer blocks and the final LayerNorm shared by the LM and
    ViT, in order: xavier-uniform Dense kernels, zero biases, LayerNorm
    ones/zeros; the blocks in ``moe_layers`` get an MoE FFN instead of
    the MLP (:func:`_init_moe`)."""
    dev = generator.device

    def dense(prefix, n_in, n_out):
        out[f"{prefix}.weight"] = _xavier((n_out, n_in), n_in, n_out, generator)
        out[f"{prefix}.bias"] = torch.zeros(n_out, device=dev)

    def layer_norm(prefix):
        out[f"{prefix}.weight"] = torch.ones(hidden, device=dev)
        out[f"{prefix}.bias"] = torch.zeros(hidden, device=dev)

    for i in range(depth):
        p = f"blocks.{i}"
        layer_norm(f"{p}.ln1")
        dense(f"{p}.attn.qkv", hidden, 3 * hidden)
        dense(f"{p}.attn.proj", hidden, hidden)
        layer_norm(f"{p}.ln2")
        if i in moe_layers:
            _init_moe(out, f"{p}.moe", hidden, mlp_dim, moe_experts, generator)
        else:
            dense(f"{p}.mlp.fc1", hidden, mlp_dim)
            dense(f"{p}.mlp.fc2", mlp_dim, hidden)
    layer_norm("ln_final")


def _init_moe(out: Dict[str, torch.Tensor], prefix: str, hidden: int, mlp_dim: int,
              experts: int, generator: torch.Generator) -> None:
    """An MoE FFN with the JAX block's initialisers: the router
    normal(0.02), ``w1``/``w2`` xavier-uniform with flax's fans for a
    3-D kernel (the expert axis is part of the receptive field, so
    ``fan_in = e·d``, ``fan_out = e·h`` for ``w1 [e, d, h]``), zero
    biases."""
    dev = generator.device
    out[f"{prefix}.router"] = torch.empty(hidden, experts, device=dev).normal_(
        0.0, 0.02, generator=generator)
    out[f"{prefix}.w1"] = _xavier((experts, hidden, mlp_dim), experts * hidden,
                                  experts * mlp_dim, generator)
    out[f"{prefix}.b1"] = torch.zeros(experts, mlp_dim, device=dev)
    out[f"{prefix}.w2"] = _xavier((experts, mlp_dim, hidden), experts * mlp_dim,
                                  experts * hidden, generator)
    out[f"{prefix}.b2"] = torch.zeros(experts, hidden, device=dev)


def init_params(variant: str, vocab_size: int, generator: torch.Generator,
                max_seq_len: int = 2048, moe_experts: int = 0,
                moe_every: int = 2) -> Dict[str, torch.Tensor]:
    """Seeded parameters with the JAX model's initialisers: normal(0.02)
    embeddings, xavier-uniform Dense kernels, zero biases, LayerNorm
    ones/zeros; with ``moe_experts`` every ``moe_every``-th block's FFN
    is routed (:func:`_init_moe`). Tensors are f32 on ``generator``'s
    device. (The draws differ from ``jax.random``'s: same
    distributions, other numbers.)"""
    hidden, depth, _, mlp_dim = _VARIANTS[variant]
    moe_layers = (tuple(i for i in range(depth) if i % moe_every == moe_every - 1)
                  if moe_experts else ())

    def normal(*shape):
        return torch.empty(*shape, device=generator.device).normal_(0.0, 0.02,
                                                                    generator=generator)

    out: Dict[str, torch.Tensor] = {
        "tok_embed": normal(vocab_size, hidden),
        "pos_embed": normal(1, max_seq_len, hidden),
    }
    _init_blocks(out, hidden, depth, mlp_dim, generator, moe_layers, moe_experts)
    return out


# ViT's trees follow the LM's rules (the patch conv is its only 4-D kernel).
vit_params_from_flax = params_from_flax
vit_params_to_flax = params_to_flax


def init_vit_params(variant: str, patch_size: int, num_classes: int,
                    generator: torch.Generator, image_size: int = 224) -> Dict[str, torch.Tensor]:
    """Seeded ``ViT`` state with the JAX model's initialisers:
    xavier-uniform Dense kernels and patch conv (fans over the receptive
    field), zero biases and ``cls_token``, normal(0.02) ``pos_embed``,
    LayerNorm ones/zeros. f32 on ``generator``'s device; the draws
    differ from ``jax.random``'s (same distributions, other numbers).
    Every rank that passes the same seed gets the same tensors."""
    hidden, depth, _, mlp_dim = vit._VARIANTS[variant]
    dev = generator.device
    tokens = (image_size // patch_size) ** 2 + 1
    field = patch_size * patch_size
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": _xavier((hidden, 3, patch_size, patch_size), 3 * field,
                                      hidden * field, generator),
        "patch_embed.bias": torch.zeros(hidden, device=dev),
        "cls_token": torch.zeros(1, 1, hidden, device=dev),
        "pos_embed": torch.empty(1, tokens, hidden, device=dev).normal_(0.0, 0.02,
                                                                        generator=generator),
    }
    _init_blocks(out, hidden, depth, mlp_dim, generator)
    out["head.weight"] = _xavier((num_classes, hidden), hidden, num_classes, generator)
    out["head.bias"] = torch.zeros(num_classes, device=dev)
    return out


_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}
_TRUNC_STD = 0.87962566103423978  # sd of a unit normal truncated to [-2, 2]


def resnet_params_from_flax(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``ResNet``'s ``params`` and ``batch_stats`` -> the port's
    ``ResNet`` state dict (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params).items():
        arr = np.array(val, np.float32)
        *mods, leaf = path
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            leaf = "weight"
        elif mods[-1] != "head":
            leaf = _BN_PARAM[leaf]
        out[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, val in _flatten(batch_stats).items():
        *mods, leaf = path
        out[".".join(mods + [_BN_STAT[leaf]])] = torch.from_numpy(np.array(val, np.float32))
    return out


def resnet_params_to_flax(state: Mapping[str, torch.Tensor]):
    """The inverse of :func:`resnet_params_from_flax`: ``(params,
    batch_stats)`` as nested dicts of numpy arrays."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    inv_param = {v: k for k, v in _BN_PARAM.items()}
    inv_stat = {v: k for k, v in _BN_STAT.items()}
    for name, tensor in state.items():
        arr = tensor.detach().float().cpu().numpy()
        *mods, leaf = name.split(".")
        tree = params
        if leaf in inv_stat:
            tree, leaf = stats, inv_stat[leaf]
        elif leaf == "weight" and arr.ndim in (2, 4):
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
            leaf = "kernel"
        elif mods[-1] != "head":
            leaf = inv_param[leaf]
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params, stats


def _init_conv_net(model: torch.nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded state of a conv net built on the meta device, with the JAX
    models' initialisers: conv kernels ``variance_scaling(2, fan_out,
    truncated_normal)`` (``fan_out = out·kh·kw``; a depthwise kernel's
    ``out`` is its channel count, as flax's ``[k, k, 1, C]``), the Dense
    head lecun-normal, every bias 0, BN γ = 1 (0 where the module sets
    ``zero_init``), β = 0, running mean 0 and variance 1."""
    dev = generator.device
    zero_init = {name for name, mod in model.named_modules() if getattr(mod, "zero_init", False)}
    out: Dict[str, torch.Tensor] = {}
    for name, ref in model.state_dict().items():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "weight" and ref.dim() == 4:  # conv, fan_out = out·kh·kw
            fan = ref.shape[0] * ref.shape[2] * ref.shape[3]
            std = math.sqrt(2.0 / fan) / _TRUNC_STD
        elif leaf == "weight" and ref.dim() == 2:  # head, fan_in
            std = math.sqrt(1.0 / ref.shape[1]) / _TRUNC_STD
        else:
            fill = 1.0 if (leaf == "running_var" or (leaf == "weight" and mod not in zero_init)) else 0.0
            out[name] = torch.full(ref.shape, fill, device=dev)
            continue
        t = torch.empty(ref.shape, device=dev)
        out[name] = torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                                generator=generator)
    return out


def init_resnet_params(depth: int, num_classes: int, generator: torch.Generator,
                       s2d_stem: bool = False) -> Dict[str, torch.Tensor]:
    """Seeded ``ResNet`` state with the JAX model's initialisers: conv
    kernels ``variance_scaling(2, fan_out, truncated_normal)``, the head
    lecun-normal with a zero bias, BN γ = 1 (0 on each branch's last
    BN), β = 0, running mean 0 and variance 1. f32 on ``generator``'s
    device; the draws differ from ``jax.random``'s (same
    distributions, other numbers). Every rank that passes the same seed
    gets the same tensors. ``s2d_stem``: the 4×4 stem on 12 channels."""
    model = ResNet(depth=depth, num_classes=num_classes, dtype=torch.float32, device="meta",
                   s2d_stem=s2d_stem)
    return _init_conv_net(model, generator)


# EfficientNet's trees follow ResNet's rules: a depthwise kernel
# ``[k, k, 1, C]`` becomes ``[C, 1, k, k]`` by the same HWIO -> OIHW
# transpose, and the squeeze-excite convs keep their biases.
efficientnet_params_from_flax = resnet_params_from_flax
efficientnet_params_to_flax = resnet_params_to_flax


def init_efficientnet_params(variant: str, num_classes: int,
                             generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded ``EfficientNet`` state with the JAX model's initialisers:
    every conv kernel (depthwise and squeeze-excite included)
    ``variance_scaling(2, fan_out, truncated_normal)``, the squeeze-excite
    biases 0, the head lecun-normal with a zero bias, BN γ = 1, β = 0,
    running mean 0 and variance 1. f32 on ``generator``'s device; the
    draws differ from ``jax.random``'s (same distributions, other
    numbers). Every rank that passes the same seed gets the same
    tensors."""
    model = EfficientNet(variant=variant, num_classes=num_classes, dtype=torch.float32,
                         device="meta")
    return _init_conv_net(model, generator)
