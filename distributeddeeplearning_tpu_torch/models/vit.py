"""Transformer building blocks shared by the LM (port of the parts of
``models/vit.py`` the LM uses): the flax-numerics ``Dense``, ``MlpBlock``
and ``Attention`` with its two KV-cache decode paths. ``ViT`` itself is
not ported yet.

The flax "cache" collection becomes an explicit :class:`KVCache` the
caller owns and passes in. Attention writes the window's K/V into it IN
PLACE (the JAX package returns a new cache instead) and never advances
its positions: the caller re-feeds them every call, as the serving
engine does anyway.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.ops.attention import dot_product_attention
from distributeddeeplearning_tpu_torch.ops.paged_decode import fused_decode_attention


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias are cast to the compute dtype, and the bias is added after
    the product (in bf16 that is two roundings, as in flax). Weights are
    ``[out, in]`` (``nn.Linear``'s layout; flax keeps ``[in, out]``)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device)
        )
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class MlpBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.fc1 = Dense(hidden, mlp_dim, dtype, device)
        self.fc2 = Dense(mlp_dim, hidden, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax nn.gelu defaults to the tanh approximation.
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


@dataclasses.dataclass
class KVCache:
    """Decode-mode K/V state of every attention layer.

    ``k``/``v`` hold one tensor per layer: dense rows ``[B, L, H, d]``
    (``block_size == 0``) or a shared block pool ``[nb, block_size, H,
    d]`` read through ``block_table`` ``[B, mb]`` int32 (entry 0 is the
    trash block). ``index`` is where this call's window starts: a Python
    int (lockstep batch, dense only) or a ``[B]`` integer tensor of
    per-row positions. ``decode_kernel`` picks the attention lowering of
    the per-row paths: ``"fused"`` runs :func:`fused_decode_attention`,
    ``"xla"`` the plain masked path."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: Union[int, torch.Tensor] = 0
    block_table: Optional[torch.Tensor] = None
    block_size: int = 0
    decode_kernel: str = "xla"

    def __post_init__(self) -> None:
        if self.decode_kernel not in ("xla", "fused"):
            raise ValueError(
                f"decode_kernel must be one of ('xla', 'fused'), got "
                f"{self.decode_kernel!r}"
            )
        if self.block_size and self.block_table is None:
            raise ValueError("a paged KVCache needs a block_table")

    @property
    def vector_index(self) -> bool:
        return isinstance(self.index, torch.Tensor) and self.index.dim() == 1


def masked_decode_scores(q, k_all, v_all, q_pos):
    """Position-masked attention of ``q`` ``[B, t, H, d]`` over a full
    static cache view (``Attention._masked_decode_scores``): scores in
    the compute dtype then f32, ``finfo(f32).min`` mask, f32 softmax,
    probabilities back in the compute dtype."""
    dtype = q.dtype
    length, head_dim = k_all.shape[1], q.shape[-1]
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q * head_dim ** -0.5, k_all.to(dtype)
    ).float()
    k_pos = torch.arange(length, device=q.device)
    if q_pos.dim() == 1:
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    else:
        mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all.to(dtype))


def _dense_decode(q, k, v, cache: KVCache, layer: int):
    """Dense row cache: write the window at each row's start, then
    attend. A start past ``L - t`` is clamped back, as JAX's
    ``dynamic_update_slice`` clamps (callers keep ``start + t <= L``)."""
    ck, cv = cache.k[layer], cache.v[layer]
    b, t = q.shape[0], q.shape[1]
    length = ck.shape[1]
    steps = torch.arange(t, device=q.device)
    if not cache.vector_index:
        idx = int(cache.index)
        start = min(max(idx, 0), length - t)
        ck[:, start:start + t] = k
        cv[:, start:start + t] = v
        return masked_decode_scores(q, ck, cv, idx + steps)
    idx = cache.index.long()
    rows = torch.arange(b, device=q.device)[:, None]
    cols = idx.clamp(0, length - t)[:, None] + steps
    ck[rows, cols] = k
    cv[rows, cols] = v
    q_pos = idx[:, None] + steps
    if cache.decode_kernel == "fused":
        return fused_decode_attention(q.contiguous(), ck, cv, q_pos)
    return masked_decode_scores(q, ck, cv, q_pos)


def _paged_decode(q, k, v, cache: KVCache, layer: int):
    """Block pool: scatter the window through the table (logical blocks
    past the table go to trash block 0 — clamping would overwrite real
    blocks), then attend through the table."""
    if not cache.vector_index:
        raise ValueError(
            "paged decode requires per-row (vector) cache positions — the "
            "serving engine's path; inference.generate stays on the dense "
            "cache"
        )
    ck, cv = cache.k[layer], cache.v[layer]
    nb, bs, heads, dh = ck.shape
    b, t = q.shape[0], q.shape[1]
    table = cache.block_table
    mb = table.shape[1]
    pos = cache.index.long()[:, None] + torch.arange(t, device=q.device)
    lb = pos // bs
    pb = torch.where(
        lb < mb, table.long().gather(1, lb.clamp(0, mb - 1)), 0
    )
    flat = (pb * bs + pos % bs).reshape(-1)
    ck.view(nb * bs, heads, dh)[flat] = k.reshape(-1, heads, dh)
    cv.view(nb * bs, heads, dh)[flat] = v.reshape(-1, heads, dh)
    if cache.decode_kernel == "fused":
        return fused_decode_attention(
            q.contiguous(), ck, cv, pos, block_table=table, block_size=bs
        )
    idx = table.long()
    k_all = ck[idx].reshape(b, mb * bs, heads, dh)
    v_all = cv[idx].reshape(b, mb * bs, heads, dh)
    return masked_decode_scores(q, k_all, v_all, pos)


class Attention(nn.Module):
    """Causal multi-head self-attention with a packed qkv projection
    (output laid out ``[..., 3, heads, head_dim]``). Without a cache it
    attends over the whole input through ``dot_product_attention`` with
    ``attn_impl`` (``"xla"``: plain masked softmax; ``"pallas"``: the
    flash kernels, which read q, k and v as views of the packed
    projection); with a :class:`KVCache` it runs the decode paths."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 device=None, attn_impl: str = "xla") -> None:
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = Dense(hidden, 3 * hidden, dtype, device)
        self.proj = Dense(hidden, hidden, dtype, device)

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                layer: int = 0) -> torch.Tensor:
        b, t, d = x.shape
        qkv = self.qkv(x).view(b, t, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.unbind(2)
        if cache is None:
            out = dot_product_attention(q, k, v, causal=True, impl=self.attn_impl)
        elif cache.block_size:
            out = _paged_decode(q, k, v, cache, layer)
        else:
            out = _dense_decode(q, k, v, cache, layer)
        return self.proj(out.reshape(b, t, d))
