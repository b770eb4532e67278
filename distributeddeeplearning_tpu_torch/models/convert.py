"""Parameters between the JAX package's flax trees and the port's
state dicts, and seeded initialisation.

``TransformerLM``: ``block{i}/…`` becomes ``blocks.{i}.…``, LayerNorm
``scale`` becomes ``weight``, and a Dense ``kernel`` ``[in, out]``
becomes a ``weight`` ``[out, in]``. Embeddings (``tok_embed`` ``[V,
H]``, ``pos_embed`` ``[1, L, H]``) and biases carry across unchanged.

``ResNet``: module paths are the flax ones joined by dots. A conv
``kernel`` HWIO ``[kh, kw, in, out]`` becomes an OIHW ``weight`` (the
fused block's ``_Conv1x1Kernel`` ``[1, 1, K, N]`` too: its ``[N, K]``
view is the kernels' ``w``), the Dense head's ``[in, out]`` a ``[out,
in]`` weight, and BN ``scale``/``bias`` (params) and ``mean``/``var``
(batch_stats) ``weight``/``bias``/``running_mean``/``running_var``.
The fused and unfused models share one tree, as in JAX.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models.resnet import ResNet
from distributeddeeplearning_tpu_torch.models.transformer_lm import _VARIANTS

_BLOCK = re.compile(r"^block(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, Any]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = val
    return out


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``TransformerLM`` param tree (nested mapping of arrays,
    unboxed) -> the port's state dict of f32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(tree).items():
        arr = np.array(val, np.float32)  # a writable copy
        names = []
        for part in path:
            m = _BLOCK.match(part)
            names.extend(["blocks", m.group(1)] if m else [part])
        if names[-1] == "scale":
            names[-1] = "weight"
        elif names[-1] == "kernel":
            names[-1] = "weight"
            arr = arr.T
        out[".".join(names)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax` (numpy leaves)."""
    tree: Dict[str, Any] = {}
    for name, tensor in state.items():
        arr = tensor.detach().float().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "blocks":
            parts = [f"block{parts[1]}"] + parts[2:]
        if parts[-1] == "weight":
            if arr.ndim == 2:
                parts[-1], arr = "kernel", arr.T
            else:
                parts[-1] = "scale"
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def init_params(variant: str, vocab_size: int, generator: torch.Generator,
                max_seq_len: int = 2048) -> Dict[str, torch.Tensor]:
    """Seeded parameters with the JAX model's initialisers: normal(0.02)
    embeddings, xavier-uniform Dense kernels, zero biases, LayerNorm
    ones/zeros. Tensors are f32 on ``generator``'s device. (The draws
    differ from ``jax.random``'s: same distributions, other numbers.)"""
    hidden, depth, _, mlp_dim = _VARIANTS[variant]
    dev = generator.device

    def normal(*shape):
        return torch.empty(*shape, device=dev).normal_(0.0, 0.02, generator=generator)

    def dense(prefix, n_in, n_out):
        bound = math.sqrt(6.0 / (n_in + n_out))
        out[f"{prefix}.weight"] = torch.empty(n_out, n_in, device=dev).uniform_(
            -bound, bound, generator=generator
        )
        out[f"{prefix}.bias"] = torch.zeros(n_out, device=dev)

    def layer_norm(prefix):
        out[f"{prefix}.weight"] = torch.ones(hidden, device=dev)
        out[f"{prefix}.bias"] = torch.zeros(hidden, device=dev)

    out: Dict[str, torch.Tensor] = {
        "tok_embed": normal(vocab_size, hidden),
        "pos_embed": normal(1, max_seq_len, hidden),
    }
    for i in range(depth):
        p = f"blocks.{i}"
        layer_norm(f"{p}.ln1")
        dense(f"{p}.attn.qkv", hidden, 3 * hidden)
        dense(f"{p}.attn.proj", hidden, hidden)
        layer_norm(f"{p}.ln2")
        dense(f"{p}.mlp.fc1", hidden, mlp_dim)
        dense(f"{p}.mlp.fc2", mlp_dim, hidden)
    layer_norm("ln_final")
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


def init_resnet_params(depth: int, num_classes: int,
                       generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Seeded ``ResNet`` state with the JAX model's initialisers: conv
    kernels ``variance_scaling(2, fan_out, truncated_normal)``, the head
    lecun-normal with a zero bias, BN γ = 1 (0 on each branch's last
    BN), β = 0, running mean 0 and variance 1. f32 on ``generator``'s
    device; the draws differ from ``jax.random``'s (same
    distributions, other numbers). Every rank that passes the same seed
    gets the same tensors."""
    dev = generator.device
    model = ResNet(depth=depth, num_classes=num_classes, dtype=torch.float32, device="meta")
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
