"""Full-sequence attention (the port of ``ops/attention.py``) over BTHD
tensors, one signature, two implementations:

* ``xla`` — plain masked softmax attention, step for step the JAX
  package's ``_xla_attention`` (the LM's full forward in serving, and the
  yardstick of the flash path in training);
* ``pallas`` — flash attention (``ops/flash.flash_attention``): the
  hand-written CUDA kernels on the card, their plain versions on the
  CPU. The port keeps the JAX package's value name.

The ``ring`` implementation (sequence parallelism) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.ops.flash import flash_attention


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
    """Multi-head attention over BTHD tensors (``impl`` ``"xla"`` or
    ``"pallas"``)."""
    if impl == "xla":
        return _xla_attention(q, k, v, causal=causal, scale=scale)
    if impl == "pallas":
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise NotImplementedError(
        f"attention impl {impl!r} is not ported yet (have: 'xla', 'pallas')"
    )
