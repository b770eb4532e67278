"""Full-sequence attention (the port of ``ops/attention.py``'s ``xla``
implementation): plain masked softmax attention over BTHD tensors, used
by the LM's full forward (the re-forward reference of the serving
path). The ``pallas`` (flash) and ``ring`` implementations are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def _xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Scores in the input dtype, scaled after the product, masked with
    that dtype's min, softmax in f32, weights back in the input dtype —
    the JAX package's ``_xla_attention`` step for step."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """Multi-head attention over BTHD tensors (``impl="xla"`` only)."""
    if impl != "xla":
        raise NotImplementedError(
            f"attention impl {impl!r} is not ported yet (have: 'xla')"
        )
    return _xla_attention(q, k, v, causal=causal, scale=scale)
