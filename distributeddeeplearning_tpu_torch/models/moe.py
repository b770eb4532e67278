"""Mixture-of-Experts blocks (port of ``models/moe.py``): GShard/Switch
capacity routing with dense dispatch and combine contractions.

* **Router in f32.** ``softmax(x·router)`` over the experts in f32
  whatever the compute dtype, then an unrolled top-k: argmax, mask the
  choice out, repeat (``torch.argmax`` takes the first maximum, as
  ``jnp.argmax`` does). First choices fill the experts' buffers before
  second choices.
* **Capacity.** Each expert takes at most ``ceil(k·s/e·cf)`` tokens of a
  row; a token past it is dropped from that expert (its dispatch and
  combine rows stay zero) and falls through the residual. A forward
  with a KV cache (decoding, the prefill included) runs with ``cf = e``,
  so that no token is ever dropped and incremental decoding equals the
  full re-forward, as the JAX LM decodes.
* **Combine weights.** ``k ≥ 2``: the kept choices' gates renormalised
  to sum to 1; ``k = 1``: the raw gate (Switch), which keeps the
  router's gradient through the output.
* **Load-balance loss** ``aux_loss_weight · e · Σ_e f_e·P_e`` (``f_e``
  the share of first choices, ``P_e`` the mean gate) is left on the
  block as ``aux_loss``, a device tensor, after each forward; the train
  step adds the blocks' losses to its loss (``train_step.sown_aux_loss``)
  as JAX adds the sown ``"losses"`` collection.

The contractions (dispatch ``bsec,bsd->ebcd``, the two expert products,
combine ``bsec,ebcd->bsd``) are plain matrix products, outside any
kernel, as in JAX. One-hot encodings are comparisons against an
``arange``, so a position at or past the capacity encodes as a zero row
(``jax.nn.one_hot``'s behaviour; ``F.one_hot`` would raise). Parameters
keep flax's layouts: ``router [d, e]``, ``w1 [e, d, h]``, ``b1 [e, h]``,
``w2 [e, h, d]``, ``b2 [e, d]``; they are not Dense ``kernel`` leaves,
so they take neither the L2 penalty nor AdamW's decoupled decay, and the
serving tier's weight quantization leaves them as they are.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models import efficientnet as noise
from distributeddeeplearning_tpu_torch.models.vit import Attention, KVCache, LayerNorm, Masks


def one_hot_f32(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=float32)``: an index outside
    ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


class MoEMlpBlock(nn.Module):
    """The MoE FFN: ``[B, S, D] -> [B, S, D]`` in the compute dtype,
    ``num_selected`` experts a token."""

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int, num_selected: int = 2,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 1e-2,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        if num_experts < 1:
            raise ValueError("num_experts must be >= 1")
        self.num_experts, self.mlp_dim = num_experts, mlp_dim
        self.num_selected, self.capacity_factor = num_selected, capacity_factor
        self.aux_loss_weight, self.dtype = aux_loss_weight, dtype
        e = num_experts
        self.router = nn.Parameter(torch.empty(hidden, e, device=device))
        self.w1 = nn.Parameter(torch.empty(e, hidden, mlp_dim, device=device))
        self.b1 = nn.Parameter(torch.empty(e, mlp_dim, device=device))
        self.w2 = nn.Parameter(torch.empty(e, mlp_dim, hidden, device=device))
        self.b2 = nn.Parameter(torch.empty(e, hidden, device=device))
        self.aux_loss: Optional[torch.Tensor] = None

    def capacity(self, seq: int, capacity_factor: Optional[float] = None) -> int:
        """Buffer slots an expert has for a row of ``seq`` tokens."""
        k = min(self.num_selected, self.num_experts)
        cf = self.capacity_factor if capacity_factor is None else capacity_factor
        return max(int(math.ceil(k * seq / self.num_experts * cf)), 1)

    def route(self, x: torch.Tensor, capacity: int):
        """``(dispatch, combine, aux)``: the f32 ``[B, S, E, C]`` dispatch
        and combine tensors (``dispatch.sum()`` counts the (token, choice)
        pairs that kept a slot) and the load-balance loss."""
        e = self.num_experts
        k = min(self.num_selected, e)
        b, s, _ = x.shape
        gates = torch.softmax(x.float() @ self.router, dim=-1)  # [b, s, e] f32
        masks: List[torch.Tensor] = []
        chosen: List[torch.Tensor] = []
        g = gates
        for _ in range(k):
            m = one_hot_f32(g.argmax(-1), e)
            masks.append(m)
            chosen.append((gates * m).sum(-1))
            g = g * (1.0 - m)
        counts_before = torch.zeros(b, 1, e, device=x.device)
        kept_masks: List[torch.Tensor] = []
        positions: List[torch.Tensor] = []
        for m in masks:
            pos_in_round = torch.cumsum(m, dim=1) - m
            loc = ((pos_in_round + counts_before) * m).sum(-1)
            counts_before = counts_before + m.sum(1, keepdim=True)
            keep = (loc < capacity).float()
            kept_masks.append(m * keep[..., None])
            positions.append(loc.int())
        kept_gate = [chosen[j] * kept_masks[j].sum(-1) for j in range(k)]
        denom = (torch.ones_like(kept_gate[0]) if k == 1
                 else torch.clamp(sum(kept_gate), min=1e-9))
        slots = [one_hot_f32(p, capacity)[:, :, None, :] for p in positions]
        dispatch = sum(kept_masks[j][..., None] * slots[j] for j in range(k))
        combine = sum((kept_gate[j] / denom)[..., None, None] * kept_masks[j][..., None]
                      * slots[j] for j in range(k))
        f = masks[0].mean(dim=(0, 1))
        p = gates.mean(dim=(0, 1))
        aux = self.aux_loss_weight * e * torch.sum(f * p)
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor, capacity_factor: Optional[float] = None) -> torch.Tensor:
        dt = self.dtype
        capacity = self.capacity(x.shape[1], capacity_factor)
        dispatch, combine, aux = self.route(x, capacity)
        self.aux_loss = aux
        expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(dt), x.to(dt))
        h = torch.einsum("ebcd,edh->ebch", expert_in, self.w1.to(dt))
        h = F.gelu(h + self.b1[:, None, None, :].to(dt), approximate="tanh")
        out = torch.einsum("ebch,ehd->ebcd", h, self.w2.to(dt))
        out = out + self.b2[:, None, None, :].to(dt)
        return torch.einsum("bsec,ebcd->bsd", combine.to(dt), out).to(dt)


class MoEDecoderBlock(nn.Module):
    """Pre-norm decoder block with an MoE FFN; the attention is the dense
    blocks' (dropout after its ``proj`` only, as in JAX: the MoE FFN has
    none)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, num_experts: int,
                 num_selected: int = 2, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.bfloat16, device=None, attn_impl: str = "xla",
                 dropout: float = 0.0, fused_dense_grad: Optional[bool] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.ln1 = LayerNorm(hidden, device=device)
        self.attn = Attention(hidden, num_heads, dtype, device, attn_impl, causal=True,
                              fused_dense_grad=fused_dense_grad)
        self.ln2 = LayerNorm(hidden, device=device)
        self.moe = MoEMlpBlock(hidden, num_experts, mlp_dim, num_selected, capacity_factor,
                               dtype=dtype, device=device)

    def mask_shapes(self, shape) -> List[Tuple[int, ...]]:
        return [tuple(shape)]

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0,
                masks: Masks = None):
        a = self.attn(self.ln1(x).to(self.dtype), cache, layer)
        if masks:
            a = noise.apply_keep_mask(a, masks[0], self.dropout)
        x = x + a
        # Decoding (a KV cache, the prefill included) drops no token.
        cf = float(self.moe.num_experts) if cache is not None else None
        return x + self.moe(self.ln2(x).to(self.dtype), cf)
