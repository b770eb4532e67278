"""Model registry of the port: the LM family and ResNet v1.

``get_model("lm_base")`` and ``get_model("resnet50")`` build the same
architectures as the JAX package's ``get_model``; for an LM
``num_classes`` is the vocab size, ``attn_impl`` reaches the LM family
only (as JAX's ``_ATTENTION_MODELS``), and ``fused`` and
``max_seq_len`` reach the model through ``**kw`` as in JAX. Models are
built with uninitialised
parameters on ``device`` (``None`` means CUDA, and raises without it;
pass ``device="cpu"`` for the CPU): load ``convert.params_from_flax`` /
``convert.init_params`` (LM) or ``convert.resnet_params_from_flax`` /
``convert.init_resnet_params`` (ResNet) into them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from distributeddeeplearning_tpu_torch.models.resnet import ResNet
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM

_REGISTRY: Dict[str, Callable[..., Any]] = {}

for _v in ("tiny", "small", "base", "large"):
    _REGISTRY[f"lm_{_v}"] = (
        lambda v: lambda num_classes=32_000, dtype=torch.bfloat16, **kw: (
            TransformerLM(variant=v, vocab_size=num_classes, dtype=dtype, **kw)
        )
    )(_v)

for _depth in (18, 34, 50, 101, 152, 200):
    _REGISTRY[f"resnet{_depth}"] = (
        lambda d: lambda num_classes=1000, dtype=torch.bfloat16, **kw: (
            ResNet(depth=d, num_classes=num_classes, dtype=dtype, **kw)
        )
    )(_depth)


def get_model(name: str, *, num_classes: int = None, dtype=torch.bfloat16,
              device=None, attn_impl: str = None, **kw):
    """Instantiate a model by name (``lm_tiny`` … ``lm_large``,
    ``resnet18`` … ``resnet200``) on
    ``device`` (``None`` means CUDA, and raises without it). ``dtype``
    may be a torch dtype or its name (``"bfloat16"``). ``attn_impl``
    (``"xla"`` | ``"pallas"``) is forwarded to the LM family and
    ignored for the ResNets."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if attn_impl is not None and key.startswith("lm_"):
        kw["attn_impl"] = attn_impl
    if num_classes is not None:
        kw["num_classes"] = num_classes
    return _REGISTRY[key](dtype=dtype, device=device, **kw)


def available_models():
    return sorted(_REGISTRY)


__all__ = ["ResNet", "TransformerLM", "available_models", "get_model"]
