"""Decoder-only Transformer LM (port of ``models/transformer_lm.py``).

``moe_experts = e > 0`` makes every ``moe_every``-th block an
``MoEDecoderBlock`` (``models/moe.py``: top-``moe_top_k`` routing over e
experts at ``moe_capacity_factor``; a forward with a KV cache drops no
token). ``dropout`` is applied after the embedding and inside the blocks
(``models/vit.py``'s places), and ``remat`` checkpoints each block, as
JAX's ``nn.remat`` (off when decoding); a model with dropout sets
``stochastic``, so the train step hands it its generator.

Numerics follow the flax model: parameters in f32, compute in ``dtype``
(bf16 by default); LayerNorm in f32 with flax's epsilon 1e-6 and its
one-pass variance, its output cast to the compute dtype; a residual
stream in the compute dtype; a tied output head computed with f32
accumulation and stored in the compute dtype.

``forward(tokens)`` is the full causal forward, its attention through
``attn_impl`` (``"xla"``, the default, serving's plain masked softmax;
``"pallas"``, the flash kernels of training; ``"fused"`` and ``"auto"``
as ``models/vit.Attention`` takes them, for T ≤ 512).
``fused_dense_grad`` (``None``: ``FUSED_DENSE_GRAD=1`` in the
environment) builds the blocks' Dense layers as ``FusedGradDense``.
``forward(tokens, cache)`` is decode mode: the tokens sit at positions
``cache.index .. +t`` (a scalar start or per-row starts), their K/V are
written into
``cache`` in place, and attention runs over the cache. Per-row position
gathers raise on an out-of-range position where JAX would fill NaN, so
callers keep ``start + t <= max_seq_len`` (the serving engine's
``_prefix_fit``).

``quantize_weights_("int8" | "fp8")`` is the serving tier's weight
quantization (``ops/quant.py``): every Dense weight and the tied
``tok_embed`` become codes plus per-row f32 scales, dequantized to the
compute dtype where they are used (the embedding only at the looked-up
rows, the head over the whole table), as JAX's engine dequantizes its
quantized tree at the top of each program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.models import efficientnet as noise
from distributeddeeplearning_tpu_torch.models.moe import MoEDecoderBlock, MoEMlpBlock
from distributeddeeplearning_tpu_torch.models.vit import (
    Attention,
    Dense,
    KVCache,
    LayerNorm,
    Masks,
    MlpBlock,
    run_block,
)
from distributeddeeplearning_tpu_torch.ops import quant
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

# name -> (hidden, depth, heads, mlp_dim)
_VARIANTS = {
    "tiny": (128, 2, 4, 512),
    "small": (512, 8, 8, 2048),
    "base": (768, 12, 12, 3072),
    "large": (1536, 24, 16, 6144),
}


class DecoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, device=None, attn_impl: str = "xla",
                 fused_dense_grad: Optional[bool] = None, dropout: float = 0.0) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.ln1 = LayerNorm(hidden, device=device)
        self.attn = Attention(hidden, num_heads, dtype, device, attn_impl, causal=True,
                              fused_dense_grad=fused_dense_grad)
        self.ln2 = LayerNorm(hidden, device=device)
        self.mlp = MlpBlock(hidden, mlp_dim, dtype, device, fused_dense_grad, dropout)

    def mask_shapes(self, shape):
        return [tuple(shape)] + self.mlp.mask_shapes(shape)

    def forward(self, x, cache: Optional[KVCache] = None, layer: int = 0,
                masks: Masks = None):
        a = self.attn(self.ln1(x).to(self.dtype), cache, layer)
        if masks:
            a = noise.apply_keep_mask(a, masks[0], self.dropout)
        x = x + a
        return x + self.mlp(self.ln2(x).to(self.dtype), masks[1:] if masks else None)


class TransformerLM(nn.Module):
    """Causal LM over integer token ids; returns ``[B, T, vocab]`` logits
    in the compute ``dtype``. Built with uninitialised parameters on
    ``device`` (``None`` means CUDA, and raises without it): load a state
    dict (``models.convert``) before use."""

    def __init__(self, variant: str = "tiny", vocab_size: int = 32_000,
                 max_seq_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 device=None, attn_impl: str = "xla",
                 fused_dense_grad: Optional[bool] = None, dropout: float = 0.0,
                 moe_experts: int = 0, moe_every: int = 2, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, remat: bool = False) -> None:
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
        self.dropout, self.remat = dropout, remat
        self.moe_experts, self.moe_every = moe_experts, moe_every
        # The train step hands a model that draws dropout noise its
        # per-step, per-rank generator.
        self.stochastic = dropout > 0
        self.tok_embed = nn.Parameter(torch.empty(vocab_size, hidden, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, max_seq_len, hidden, device=device)
        )
        self.blocks = nn.ModuleList(
            MoEDecoderBlock(hidden, heads, mlp_dim, moe_experts, moe_top_k,
                            moe_capacity_factor, dtype, device, attn_impl, dropout,
                            fused_dense_grad)
            if i in self.moe_layers() else
            DecoderBlock(hidden, heads, mlp_dim, dtype, device, attn_impl, fused_dense_grad,
                         dropout)
            for i in range(depth)
        )
        self.ln_final = LayerNorm(hidden, device=device)

    def moe_layers(self) -> Tuple[int, ...]:
        """The blocks whose FFN is routed (every ``moe_every``-th)."""
        if not self.moe_experts:
            return ()
        return tuple(i for i in range(self.depth)
                     if i % self.moe_every == self.moe_every - 1)

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The Dense weights of every block (``qkv``, ``proj``, ``fc1``,
        ``fc2``: the flax ``kernel`` leaves), what the L2 penalty covers;
        the embeddings, biases, LayerNorm and the MoE ``router``, ``w1``
        and ``w2`` (no ``kernel`` leaves in flax) are exempt, as in JAX."""
        return tuple(m.weight for m in self.modules() if isinstance(m, Dense))

    def cast_matmul_weights_(self) -> "TransformerLM":
        """Store every Dense weight/bias and the embeddings in the
        compute dtype, in place. The forward casts them at use anyway,
        so the results are bitwise the same; serving then streams half
        the weight bytes per step. The experts' ``w1``, ``b1``, ``w2`` and
        ``b2`` are cast too; the f32 router, LayerNorm parameters and
        quantized weights (codes and scales) stay as they are."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    if not quant.is_quantized_module(m, "weight"):
                        m.weight.data = m.weight.data.to(self.dtype)
                    m.bias.data = m.bias.data.to(self.dtype)
                elif isinstance(m, MoEMlpBlock):
                    for p in (m.w1, m.b1, m.w2, m.b2):
                        p.data = p.data.to(self.dtype)
            if not quant.is_quantized_module(self, "tok_embed"):
                self.tok_embed.data = self.tok_embed.data.to(self.dtype)
            self.pos_embed.data = self.pos_embed.data.to(self.dtype)
        return self

    def quantize_weights_(self, dtype: str) -> "TransformerLM":
        """Quantize every Dense weight and ``tok_embed`` in place
        (``"int8"`` or ``"fp8"``, one f32 scale per output row; the
        experts and the router stay unquantized, as JAX's quantizer
        covers 2-D ``kernel`` leaves only) from
        their current values: call it on the f32 parameters, before
        :meth:`cast_matmul_weights_`, since rounding to bf16 first moves
        each row's amax and so every code."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    quant.quantize_module_(m, "weight", dtype)
            quant.quantize_module_(self, "tok_embed", dtype)
        return self

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if quant.is_quantized_module(self, "tok_embed"):
            copies = quant.held(self)
            if copies:
                return copies["tok_embed"][tokens]
            return quant.dequantize_store(
                self.tok_embed_q[tokens], self.tok_embed_scale[tokens], self.dtype)
        return self.tok_embed[tokens].to(self.dtype)

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t = tokens.shape
        if t > self.max_seq_len:
            raise ValueError(
                f"sequence {t} exceeds max_seq_len {self.max_seq_len}"
            )
        x = self._embed(tokens)
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
        # Dropout and remat in training forwards only (JAX decodes with
        # train=False and without nn.remat).
        stochastic = self.training and cache is None and self.dropout > 0
        if stochastic:
            x = noise.dropout(x, self.dropout, generator, x.shape)
        remat = self.remat and cache is None
        for i, block in enumerate(self.blocks):
            x = run_block(block, x, generator, stochastic, remat, cache, i)
        x = self.ln_final(x)
        # Tied head: compute-dtype operands, f32 accumulation, logits
        # stored in the compute dtype.
        return torch.matmul(x.to(self.dtype), quant.weight(self, "tok_embed", self.dtype).t())
