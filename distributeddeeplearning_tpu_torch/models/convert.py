"""Parameters between the JAX package's flax trees and the port's
``TransformerLM`` state dicts, and seeded initialisation.

Naming: ``block{i}/…`` becomes ``blocks.{i}.…``, LayerNorm ``scale``
becomes ``weight``, and a Dense ``kernel`` ``[in, out]`` becomes a
``weight`` ``[out, in]``. Embeddings (``tok_embed`` ``[V, H]``,
``pos_embed`` ``[1, L, H]``) and biases carry across unchanged.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

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
