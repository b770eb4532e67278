"""Model registry of the port: the LM family (dense ``lm_*`` and MoE
``lm_moe_*``), ViT, ResNet v1 and EfficientNet.

``get_model("lm_base")``, ``get_model("lm_moe_base")`` (8 experts unless
``moe_experts`` says otherwise), ``get_model("vit_b16")``,
``get_model("resnet50")`` and ``get_model("efficientnet_b4")`` build the
same architectures as the JAX package's ``get_model``; for an LM ``num_classes`` is the vocab size,
``attn_impl`` reaches the attention models (LM and ViT, as JAX's
``_ATTENTION_MODELS``), ``moe_experts`` the LM family (JAX's
``_MOE_MODELS``), ``remat`` the LMs and ViT (``_REMAT_MODELS``),
``image_size`` reaches ViT only (flax sizes its
``pos_embed`` from the first input, torch at construction), and
``fused``, ``max_seq_len`` and ``fused_dense_grad`` reach the model
through ``**kw``. Models are built with uninitialised parameters on
``device`` (``None`` means CUDA, and raises without it; pass
``device="cpu"`` for the CPU): load ``convert.params_from_flax`` /
``convert.init_params`` (LM), ``convert.vit_params_from_flax`` /
``convert.init_vit_params`` (ViT) or ``convert.resnet_params_from_flax``
/ ``convert.init_resnet_params`` (ResNet) or
``convert.efficientnet_params_from_flax`` /
``convert.init_efficientnet_params`` (EfficientNet) into them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from distributeddeeplearning_tpu_torch.models.efficientnet import EfficientNet
from distributeddeeplearning_tpu_torch.models.resnet import ResNet
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.models.vit import ViT

_REGISTRY: Dict[str, Callable[..., Any]] = {}

for _v in ("tiny", "small", "base", "large"):
    _REGISTRY[f"lm_{_v}"] = (
        lambda v: lambda num_classes=32_000, dtype=torch.bfloat16, **kw: (
            TransformerLM(variant=v, vocab_size=num_classes, dtype=dtype, **kw)
        )
    )(_v)
    # MoE variant: every 2nd block's FFN routed over 8 experts by default.
    _REGISTRY[f"lm_moe_{_v}"] = (
        lambda v: lambda num_classes=32_000, dtype=torch.bfloat16, moe_experts=8, **kw: (
            TransformerLM(variant=v, vocab_size=num_classes, dtype=dtype,
                          moe_experts=moe_experts, **kw)
        )
    )(_v)

# Name = vit_<variant><patch>.
for _v in ("ti", "s", "b", "l", "h"):
    _REGISTRY[f"vit_{_v}16"] = (
        lambda v: lambda num_classes=1000, dtype=torch.bfloat16, **kw: (
            ViT(variant=v, patch_size=16, num_classes=num_classes, dtype=dtype, **kw)
        )
    )(_v)

for _depth in (18, 34, 50, 101, 152, 200):
    _REGISTRY[f"resnet{_depth}"] = (
        lambda d: lambda num_classes=1000, dtype=torch.bfloat16, **kw: (
            ResNet(depth=d, num_classes=num_classes, dtype=dtype, **kw)
        )
    )(_depth)

# EfficientNet family (BASELINE.json config: EfficientNet-B4).
for _b in range(8):
    _REGISTRY[f"efficientnet_b{_b}"] = (
        lambda v: lambda num_classes=1000, dtype=torch.bfloat16, **kw: (
            EfficientNet(variant=v, num_classes=num_classes, dtype=dtype, **kw)
        )
    )(f"b{_b}")


def get_model(name: str, *, num_classes: int = None, dtype=torch.bfloat16,
              device=None, attn_impl: str = None, image_size: int = None,
              moe_experts: int = None, remat: bool = None, **kw):
    """Instantiate a model by name (``lm_tiny`` … ``lm_large``,
    ``lm_moe_tiny`` … ``lm_moe_large``, ``vit_ti16`` … ``vit_h16``,
    ``resnet18`` … ``resnet200``, ``efficientnet_b0`` …
    ``efficientnet_b7``) on ``device`` (``None`` means CUDA, and raises
    without it). ``dtype`` may be a torch dtype or its name
    (``"bfloat16"``). ``attn_impl`` (``"xla"`` | ``"pallas"`` |
    ``"fused"`` | ``"auto"``) is forwarded to the LM family and ViT,
    ``remat`` too, ``moe_experts`` to the LM family only; the
    convolutional models ignore them. ``image_size`` is forwarded to
    ViT only."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if attn_impl is not None and key.startswith(("lm_", "vit_")):
        kw["attn_impl"] = attn_impl
    if moe_experts is not None and key.startswith("lm_"):
        kw["moe_experts"] = moe_experts
    if remat is not None and key.startswith(("lm_", "vit_")):
        kw["remat"] = remat
    if image_size is not None and key.startswith("vit_"):
        kw["image_size"] = image_size
    if num_classes is not None:
        kw["num_classes"] = num_classes
    return _REGISTRY[key](dtype=dtype, device=device, **kw)


def available_models():
    return sorted(_REGISTRY)


__all__ = ["EfficientNet", "ResNet", "TransformerLM", "ViT", "available_models", "get_model"]
