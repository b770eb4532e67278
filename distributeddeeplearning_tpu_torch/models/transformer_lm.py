"""Decoder-only Transformer LM (port of ``models/transformer_lm.py``,
dense FFN; the MoE blocks are not ported yet).

Numerics follow the flax model: parameters in f32, compute in ``dtype``
(bf16 by default); LayerNorm in f32 with flax's epsilon 1e-6 and its
one-pass variance, its output cast to the compute dtype; a residual
stream in the compute dtype; a tied output head computed with f32
accumulation and stored in the compute dtype.

``forward(tokens)`` is the full causal forward, its attention through
``attn_impl`` (``"xla"``, the default, serving's plain masked softmax;
``"pallas"``, the flash kernels of training). ``forward(tokens,
cache)`` is decode mode: the tokens sit at positions ``cache.index ..
+t`` (a scalar start or per-row starts), their K/V are written into
``cache`` in place, and attention runs over the cache. Per-row position
gathers raise on an out-of-range position where JAX would fill NaN, so
callers keep ``start + t <= max_seq_len`` (the serving engine's
``_prefix_fit``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.models.vit import (
    Attention,
    Dense,
    KVCache,
    MlpBlock,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

# name -> (hidden, depth, heads, mlp_dim)
_VARIANTS = {
    "tiny": (128, 2, 4, 512),
    "small": (512, 8, 8, 2048),
    "base": (768, 12, 12, 3072),
    "large": (1536, 24, 16, 6144),
}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 statistics with
    ``var = max(0, E[x²] - E[x]²)``, epsilon 1e-6, f32 output."""

    def __init__(self, features: int, eps: float = 1e-6, device=None) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        mu2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mu) * mul + self.bias


class DecoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, device=None, attn_impl: str = "xla") -> None:
        super().__init__()
        self.dtype = dtype
        self.ln1 = LayerNorm(hidden, device=device)
        self.attn = Attention(hidden, num_heads, dtype, device, attn_impl)
        self.ln2 = LayerNorm(hidden, device=device)
        self.mlp = MlpBlock(hidden, mlp_dim, dtype, device)

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0):
        x = x + self.attn(self.ln1(x).to(self.dtype), cache, layer)
        return x + self.mlp(self.ln2(x).to(self.dtype))


class TransformerLM(nn.Module):
    """Causal LM over integer token ids; returns ``[B, T, vocab]`` logits
    in the compute ``dtype``. Built with uninitialised parameters on
    ``device`` (``None`` means CUDA, and raises without it): load a state
    dict (``models.convert``) before use."""

    def __init__(self, variant: str = "tiny", vocab_size: int = 32_000,
                 max_seq_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 device=None, attn_impl: str = "xla") -> None:
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}")
        device = resolve_device(device)
        hidden, depth, heads, mlp_dim = _VARIANTS[variant]
        self.variant = variant
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.hidden = hidden
        self.num_heads = heads
        self.head_dim = hidden // heads
        self.depth = depth
        self.attn_impl = attn_impl
        self.tok_embed = nn.Parameter(torch.empty(vocab_size, hidden, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, max_seq_len, hidden, device=device)
        )
        self.blocks = nn.ModuleList(
            DecoderBlock(hidden, heads, mlp_dim, dtype, device, attn_impl)
            for _ in range(depth)
        )
        self.ln_final = LayerNorm(hidden, device=device)

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The Dense weights of every block (``qkv``, ``proj``, ``fc1``,
        ``fc2``: the flax ``kernel`` leaves), what the L2 penalty covers;
        the embeddings, biases and LayerNorm are exempt, as in JAX."""
        return tuple(m.weight for m in self.modules() if isinstance(m, Dense))

    def cast_matmul_weights_(self) -> "TransformerLM":
        """Store every Dense weight/bias and the embeddings in the
        compute dtype, in place. The forward casts them at use anyway,
        so the results are bitwise the same; serving then streams half
        the weight bytes per step. LayerNorm parameters stay f32."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    m.weight.data = m.weight.data.to(self.dtype)
                    m.bias.data = m.bias.data.to(self.dtype)
            self.tok_embed.data = self.tok_embed.data.to(self.dtype)
            self.pos_embed.data = self.pos_embed.data.to(self.dtype)
        return self

    def forward(self, tokens: torch.Tensor,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        b, t = tokens.shape
        if t > self.max_seq_len:
            raise ValueError(
                f"sequence {t} exceeds max_seq_len {self.max_seq_len}"
            )
        x = self.tok_embed[tokens].to(self.dtype)
        if cache is None:
            pos_t = self.pos_embed[:, :t]
        elif cache.vector_index:
            rows = cache.index.long()[:, None] + torch.arange(
                t, device=tokens.device
            )
            pos_t = self.pos_embed[0][rows]  # [B, t, hidden]
        else:
            start = min(max(int(cache.index), 0), self.max_seq_len - t)
            pos_t = self.pos_embed[:, start:start + t]
        x = x + pos_t.to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, cache, i)
        x = self.ln_final(x)
        # Tied head: compute-dtype operands, f32 accumulation, logits
        # stored in the compute dtype.
        return torch.matmul(x.to(self.dtype), self.tok_embed.to(self.dtype).t())
