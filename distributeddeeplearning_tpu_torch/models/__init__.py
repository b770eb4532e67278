"""Model registry of the port (the LM family so far).

``get_model("lm_base")`` builds the same architecture as the JAX
package's ``get_model("lm_base")``; ``num_classes`` is the vocab size.
Models are built with uninitialised parameters on ``device`` (``None``
means CUDA, and raises without it; pass ``device="cpu"`` for the CPU):
load ``convert.params_from_flax`` or ``convert.init_params`` into them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM

_REGISTRY: Dict[str, Callable[..., Any]] = {}

for _v in ("tiny", "small", "base", "large"):
    _REGISTRY[f"lm_{_v}"] = (
        lambda v: lambda num_classes=32_000, dtype=torch.bfloat16, **kw: (
            TransformerLM(variant=v, vocab_size=num_classes, dtype=dtype, **kw)
        )
    )(_v)


def get_model(name: str, *, num_classes: int = None, dtype=torch.bfloat16,
              device=None, **kw):
    """Instantiate a model by name (``lm_tiny`` … ``lm_large``) on
    ``device`` (``None`` means CUDA, and raises without it). ``dtype``
    may be a torch dtype or its name (``"bfloat16"``)."""
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if num_classes is not None:
        kw["num_classes"] = num_classes
    return _REGISTRY[key](dtype=dtype, device=device, **kw)


__all__ = ["TransformerLM", "get_model"]
