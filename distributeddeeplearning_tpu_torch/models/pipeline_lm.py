"""Stage-partitioned decoder LM, the pipeline-parallel model: the port
of the JAX package's ``models/pipeline_lm.py``.

* ``EmbedIn`` — token + position embedding (the first stage's input);
* ``StageCore`` — ``depth / num_stages`` decoder blocks: one stage;
* ``HeadOut`` — final LayerNorm and an untied f32 vocab projection (the
  last stage's output).

JAX's ``PipelineLM`` holds every stage's parameters stacked on a leading
``[S, …]`` axis sharded over ``pipe``; here each rank builds the
:class:`PipelineLM` of its own ``stage``: the embedding and the head
(replicated, as in JAX) and that stage's blocks. ``attn_impl="pallas"``
runs the flash kernels inside each stage. :func:`init_pipeline_params`
draws the embedding and head from the seed and each stage from a seed of
its own, so a rank draws its own stage only (sharded at birth);
``models/convert.pipeline_params_from_flax`` carries JAX's stacked tree
over, stage by stage.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.models.transformer_lm import _VARIANTS, DecoderBlock
from distributeddeeplearning_tpu_torch.models.vit import Dense, LayerNorm, run_block
from distributeddeeplearning_tpu_torch.utils.device import resolve_device


class EmbedIn(nn.Module):
    """``[B, T]`` tokens -> ``[B, T, H]`` activations in the compute dtype."""

    def __init__(self, vocab_size: int, hidden: int, max_seq_len: int, dtype, device) -> None:
        super().__init__()
        self.dtype, self.max_seq_len = dtype, max_seq_len
        self.tok_embed = nn.Parameter(torch.empty(vocab_size, hidden, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, max_seq_len, hidden, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[-1]
        if t > self.max_seq_len:
            raise ValueError(f"sequence {t} exceeds max_seq_len {self.max_seq_len}")
        return self.tok_embed[tokens].to(self.dtype) + self.pos_embed[:, :t].to(self.dtype)


class StageCore(nn.Module):
    """``n_layers`` decoder blocks (``layers.<i>``, flax's ``layer<i>``);
    dropout masks from the caller's generator, ``remat`` checkpoints
    each block."""

    def __init__(self, n_layers: int, hidden: int, num_heads: int, mlp_dim: int, dtype,
                 device, attn_impl: str = "xla", dropout: float = 0.0,
                 remat: bool = False) -> None:
        super().__init__()
        self.dropout, self.remat = dropout, remat
        self.layers = nn.ModuleList(
            DecoderBlock(hidden, num_heads, mlp_dim, dtype, device, attn_impl, None, dropout)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        stochastic = self.training and self.dropout > 0
        for layer in self.layers:
            x = run_block(layer, x, generator, stochastic, self.remat, None, 0)
        return x


class HeadOut(nn.Module):
    """Final LayerNorm + untied vocab projection, f32 logits."""

    def __init__(self, hidden: int, vocab_size: int, device) -> None:
        super().__init__()
        self.ln_final = LayerNorm(hidden, device=device)
        self.proj = Dense(hidden, vocab_size, torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.ln_final(x)).float()


class PipelineLM(nn.Module):
    """One rank's share of a pipeline-partitioned LM: ``embed``, stage
    ``stage``'s ``core`` and ``head`` (module docstring). ``n_layers``
    overrides the variant's depth; it must split into ``num_stages``."""

    def __init__(self, variant: str = "tiny", vocab_size: int = 32_000,
                 max_seq_len: int = 2048, num_stages: int = 2, n_layers: Optional[int] = None,
                 dtype=torch.bfloat16, attn_impl: str = "xla", dropout: float = 0.0,
                 remat: bool = False, stage: int = 0, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        hidden, depth, heads, mlp_dim = _VARIANTS[variant]
        depth = n_layers if n_layers is not None else depth
        if depth % num_stages:
            raise ValueError(f"depth {depth} not divisible by num_stages {num_stages}")
        if not 0 <= stage < num_stages:
            raise ValueError(f"stage {stage} outside [0, {num_stages})")
        self.variant, self.vocab_size, self.max_seq_len = variant, vocab_size, max_seq_len
        self.num_stages, self.n_layers, self.stage = num_stages, depth, stage
        self.dtype, self.attn_impl, self.dropout, self.remat = dtype, attn_impl, dropout, remat
        self.hidden = hidden
        self.stochastic = dropout > 0
        self.embed = EmbedIn(vocab_size, hidden, max_seq_len, dtype, device)
        self.core = StageCore(depth // num_stages, hidden, heads, mlp_dim, dtype, device,
                              attn_impl, dropout, remat)
        self.head = HeadOut(hidden, vocab_size, device)

    @property
    def layers_per_stage(self) -> int:
        return self.n_layers // self.num_stages

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The Dense weights (flax ``kernel`` leaves): the stage's and
        the head's; the embeddings carry none."""
        return tuple(m.weight for m in self.modules() if isinstance(m, Dense))


def _stage_seed(seed: int, stage: int) -> int:
    digest = hashlib.blake2b(f"{seed}/stage/{stage}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def init_pipeline_params(pl: PipelineLM, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded state of ``pl`` with JAX's initialisers (normal(0.02)
    embeddings, xavier-uniform Dense kernels, zero biases, LayerNorm
    ones/zeros): the embedding and head from ``seed``, the stage from a
    seed of its own (other numbers than ``jax.random``'s)."""
    from distributeddeeplearning_tpu_torch.models import convert

    hidden, _, _, mlp_dim = _VARIANTS[pl.variant]
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {
        "embed.tok_embed": torch.empty(pl.vocab_size, hidden, device=device).normal_(
            0.0, 0.02, generator=gen),
        "embed.pos_embed": torch.empty(1, pl.max_seq_len, hidden, device=device).normal_(
            0.0, 0.02, generator=gen),
        "head.ln_final.weight": torch.ones(hidden, device=device),
        "head.ln_final.bias": torch.zeros(hidden, device=device),
        "head.proj.weight": convert._xavier((pl.vocab_size, hidden), hidden, pl.vocab_size,
                                            gen),
        "head.proj.bias": torch.zeros(pl.vocab_size, device=device),
    }
    blocks: Dict[str, torch.Tensor] = {}
    stage_gen = torch.Generator(device=device).manual_seed(_stage_seed(seed, pl.stage))
    convert._init_blocks(blocks, hidden, pl.layers_per_stage, mlp_dim, stage_gen)
    for name, t in blocks.items():
        if name.startswith("blocks."):
            out["core.layers." + name[len("blocks."):]] = t
    return out
