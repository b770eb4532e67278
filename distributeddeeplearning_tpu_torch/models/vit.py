"""Vision Transformer and the transformer blocks it shares with the LM
(port of ``models/vit.py``): the flax-numerics ``Dense`` and
``LayerNorm``, ``FusedGradDense``, ``MlpBlock``, ``Attention`` with its
two KV-cache decode paths, ``EncoderBlock`` and ``ViT``.

``dropout > 0`` places flax's ``nn.Dropout`` where the JAX blocks do:
after the attention's ``proj`` and after the MLP's GELU and ``fc2``.
Each block draws its keep masks before it runs, in the order its forward
applies them, through the port's one mask function
(``efficientnet.keep_mask``) and the train step's generator
(:func:`run_block`); a model with dropout sets ``stochastic``, so the
train step hands it that generator. ``remat`` recomputes each block in
the backward (non-reentrant ``torch.utils.checkpoint``, JAX's
``nn.remat``): the masks drawn before the checkpointed call are its
inputs, so the recompute applies the forward's masks.

Numerics follow the flax model: parameters in f32, compute in ``dtype``
(bf16 by default), LayerNorm in f32, the head an f32 Dense. A Dense
whose weight went through ``ops/quant.quantize_module_`` holds int8 or
fp8 codes and f32 scales instead, and dequantizes them at each use.

``FUSED_DENSE_GRAD=1`` (read when a Dense is built, as JAX's ``_dense``
reads it) makes every Dense a ``FusedGradDense``: the same parameters,
with the backward's dW and db from one pass over the upstream gradient
(``ops/fused_grads.bias_dense``). It reaches the LM's blocks too.

The flax "cache" collection becomes an explicit :class:`KVCache` the
caller owns and passes in. Attention writes the window's K/V into it IN
PLACE (the JAX package returns a new cache instead) and never advances
its positions: the caller re-feeds them every call, as the serving
engine does anyway. A quantized cache (``kv_dtype`` int8 or fp8) holds
codes and per-head f32 scales; writes quantize, reads dequantize.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddeeplearning_tpu_torch.models import efficientnet as noise
from distributeddeeplearning_tpu_torch.ops import flash_packed
from distributeddeeplearning_tpu_torch.ops import quant
from distributeddeeplearning_tpu_torch.ops.attention import dot_product_attention
from distributeddeeplearning_tpu_torch.ops.fused_grads import bias_dense
from distributeddeeplearning_tpu_torch.ops.paged_decode import fused_decode_attention
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

# name -> (hidden, depth, heads, mlp_dim)
_VARIANTS = {
    "ti": (192, 12, 3, 768),
    "s": (384, 12, 6, 1536),
    "b": (768, 12, 12, 3072),
    "l": (1024, 24, 16, 4096),
    "h": (1280, 32, 16, 5120),
}


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias are cast to the compute dtype, and the bias is added after
    the product (in bf16 that is two roundings, as in flax). Weights are
    ``[out, in]`` (``nn.Linear``'s layout; flax keeps ``[in, out]``).
    Quantized (``quant.quantize_module_(dense, "weight", ...)``), the
    weight is dequantized to the compute dtype at each use."""

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
        return F.linear(x.to(dt), quant.weight(self, "weight", dt)) + self.bias.to(dt)


class FusedGradDense(Dense):
    """``Dense`` whose backward computes dW and db in one pass over the
    upstream gradient (``ops/fused_grads.bias_dense``; JAX's
    ``_FusedGradDense``). The same parameters and forward; quantized for
    serving (no backward), it is a plain ``Dense``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.is_quantized_module(self, "weight"):
            return super().forward(x)
        return bias_dense(x, self.weight, self.bias, self.dtype)


def _dense(in_features: int, out_features: int, dtype: torch.dtype, device=None,
           fused_dense_grad: Optional[bool] = None) -> Dense:
    """A ``Dense``, or a ``FusedGradDense`` when ``fused_dense_grad``
    (``None``: ``FUSED_DENSE_GRAD=1`` in the environment now, as JAX's
    ``_dense`` reads it when a layer is built)."""
    if fused_dense_grad is None:
        fused_dense_grad = os.environ.get("FUSED_DENSE_GRAD", "") == "1"
    cls = FusedGradDense if fused_dense_grad else Dense
    return cls(in_features, out_features, dtype, device)


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


Masks = Optional[Tuple[torch.Tensor, ...]]


def run_block(block: nn.Module, x: torch.Tensor, generator: Optional[torch.Generator],
              stochastic: bool, remat: bool, *args) -> torch.Tensor:
    """``block(x, *args, masks)``: the block's dropout masks drawn first
    when ``stochastic`` (``block.mask_shapes``), then the block, under
    ``remat`` (and autograd) checkpointed with the masks among its
    inputs. The step's generators are explicit, so no default RNG state
    needs preserving."""
    masks = None
    if stochastic and block.dropout > 0:
        masks = tuple(noise.keep_mask(shape, 1.0 - block.dropout, generator, x.device)
                      for shape in block.mask_shapes(x.shape))
    if remat and torch.is_grad_enabled():
        return checkpoint(block, x, *args, masks, use_reentrant=False,
                          preserve_rng_state=False)
    return block(x, *args, masks)


class MlpBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, dtype: torch.dtype,
                 device=None, fused_dense_grad: Optional[bool] = None,
                 dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = dropout
        self.mlp_dim = mlp_dim
        # Tensor parallel (training/pjit_step.py): this rank's GELU
        # columns, which it takes from the full-width keep mask.
        self.mask_cols: Optional[slice] = None
        self.fc1 = _dense(hidden, mlp_dim, dtype, device, fused_dense_grad)
        self.fc2 = _dense(mlp_dim, hidden, dtype, device, fused_dense_grad)

    def mask_shapes(self, shape) -> List[Tuple[int, ...]]:
        """The keep masks' shapes for an input of ``shape``: after the
        GELU (full width), after ``fc2``."""
        return [tuple(shape[:-1]) + (self.mlp_dim,), tuple(shape)]

    def forward(self, x: torch.Tensor, masks: Masks = None) -> torch.Tensor:
        # flax nn.gelu defaults to the tanh approximation.
        h = F.gelu(self.fc1(x), approximate="tanh")
        if masks:
            keep = masks[0] if self.mask_cols is None else masks[0][..., self.mask_cols]
            h = noise.apply_keep_mask(h, keep, self.dropout)
        h = self.fc2(h)
        return noise.apply_keep_mask(h, masks[1], self.dropout) if masks else h


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
    ``"xla"`` the plain masked path. ``kv_dtype`` ``"int8"`` or ``"fp8"``
    (``ops/quant.py``'s registry) means ``k``/``v`` hold codes and
    ``k_scale``/``v_scale`` one f32 scale per head per position (the
    K/V shape with a last axis of 1). ``window`` is the
    :class:`DecodeWindow` of the forward under way (:func:`with_window`);
    without one, each layer makes its own."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: Union[int, torch.Tensor] = 0
    block_table: Optional[torch.Tensor] = None
    block_size: int = 0
    decode_kernel: str = "xla"
    kv_dtype: str = "bf16"
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None
    window: Optional["DecodeWindow"] = None

    def __post_init__(self) -> None:
        if self.decode_kernel not in ("xla", "fused"):
            raise ValueError(
                f"decode_kernel must be one of ('xla', 'fused'), got "
                f"{self.decode_kernel!r}"
            )
        if self.block_size and self.block_table is None:
            raise ValueError("a paged KVCache needs a block_table")
        quant.validate_store_dtype("kv_dtype", self.kv_dtype)
        if self.quantized and (self.k_scale is None or self.v_scale is None):
            raise ValueError(f"a {self.kv_dtype} KVCache needs k_scale and v_scale")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype != "bf16"

    @property
    def vector_index(self) -> bool:
        return isinstance(self.index, torch.Tensor) and self.index.dim() == 1


def decode_mask(q_pos: torch.Tensor, length: int) -> torch.Tensor:
    """:func:`masked_decode_scores`' key mask: key position <= query
    position, broadcast over heads."""
    k_pos = torch.arange(length, device=q_pos.device)
    if q_pos.dim() == 1:
        return (k_pos[None, :] <= q_pos[:, None])[None, None]
    return (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]


def masked_decode_scores(q, k_all, v_all, q_pos, mask=None):
    """Position-masked attention of ``q`` ``[B, t, H, d]`` over a full
    static cache view (``Attention._masked_decode_scores``): scores in
    the compute dtype then f32, ``finfo(f32).min`` mask, f32 softmax,
    probabilities back in the compute dtype. ``mask`` is
    :func:`decode_mask` of ``q_pos``, when the caller has it."""
    dtype = q.dtype
    length, head_dim = k_all.shape[1], q.shape[-1]
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q * head_dim ** -0.5, k_all.to(dtype)
    ).float()
    if mask is None:
        mask = decode_mask(q_pos, length)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all.to(dtype))


@dataclasses.dataclass
class DecodeWindow:
    """What every layer of one forward computes alike for a window of
    ``t`` tokens at per-row positions: ``q_pos`` ``[B, t]``, the write
    indices (``(rows, cols)`` into dense rows, or ``(flat,)`` into the
    flattened block pool), the block table as int64 (paged), and the
    plain path's key mask (``None`` on the ``fused`` path). The decode
    forward is launch-bound on the card, where making these once a
    forward instead of once a layer cut a plain decode tick of f32
    ``lm_base`` from 592 to 537 kernels (H100 80GB HBM3, 700 W)."""

    q_pos: torch.Tensor
    write: Tuple[torch.Tensor, ...]
    table: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]


def decode_window(cache: KVCache, t: int) -> DecodeWindow:
    """The :class:`DecodeWindow` of a ``t``-token window at the per-row
    positions ``cache.index``. Paged, logical blocks past the table go
    to trash block 0 (clamping would overwrite real blocks); dense, a
    start past ``L - t`` is clamped back, as JAX's
    ``dynamic_update_slice`` clamps (callers keep ``start + t <= L``)."""
    idx = cache.index.long()
    steps = torch.arange(t, device=idx.device)
    q_pos = idx[:, None] + steps
    table = None
    if cache.block_size:
        table = cache.block_table.long()
        bs, mb = cache.block_size, table.shape[1]
        lb = q_pos // bs
        pb = torch.where(lb < mb, table.gather(1, lb.clamp(0, mb - 1)), 0)
        write = ((pb * bs + q_pos % bs).reshape(-1),)
        length = mb * bs
    else:
        length = cache.k[0].shape[1]
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        write = (rows, idx.clamp(0, length - t)[:, None] + steps)
    mask = None if cache.decode_kernel == "fused" else decode_mask(q_pos, length)
    return DecodeWindow(q_pos, write, table, mask)


def with_window(cache: KVCache, t: int) -> KVCache:
    """``cache`` carrying the :class:`DecodeWindow` of a ``t``-token
    window, made from its index now (a model's forward calls this once,
    before its layers); a scalar-index cache is returned as it is."""
    if not cache.vector_index:
        return cache
    return dataclasses.replace(cache, window=decode_window(cache, t))


def _window(cache: KVCache, t: int) -> DecodeWindow:
    w = cache.window
    if w is None:
        return decode_window(cache, t)
    if w.q_pos.shape[1] != t:
        raise ValueError(f"the cache's window is {w.q_pos.shape[1]} tokens, the input {t}")
    return w


def _writes(k, v, cache: KVCache, layer: int):
    """(store, update) pairs of one window: K/V, or, quantized, their
    codes and scales (``quantize_kv`` over the head dim: ``[B, t, H,
    1]`` scales), written through the same indices."""
    if not cache.quantized:
        return [(cache.k[layer], k), (cache.v[layer], v)]
    kq, ks = quant.quantize_kv(k, cache.kv_dtype, axis=-1)
    vq, vs = quant.quantize_kv(v, cache.kv_dtype, axis=-1)
    return [(cache.k[layer], kq), (cache.v[layer], vq),
            (cache.k_scale[layer], ks), (cache.v_scale[layer], vs)]


def _attend(q, q_pos, cache: KVCache, layer: int, view=None, mask=None, **paged):
    """Attention of the window over the cache, after its writes: the
    kernel wrapper on the ``fused`` path for per-row positions
    (quantized stores go to it with their scales), else the plain masked
    path over the logical view (``view`` of a store; dense rows are
    their own), dequantized to the compute dtype first, under ``mask``
    (the window's, for per-row positions)."""
    ck, cv = cache.k[layer], cache.v[layer]
    scales = dict(k_scale=cache.k_scale[layer], v_scale=cache.v_scale[layer]) \
        if cache.quantized else {}
    if cache.decode_kernel == "fused" and q_pos.dim() == 2:
        return fused_decode_attention(q.contiguous(), ck, cv, q_pos, **scales, **paged)
    view = view or (lambda x: x)
    k_all, v_all = view(ck), view(cv)
    if cache.quantized:
        k_all = quant.dequantize_store(k_all, view(scales["k_scale"]), q.dtype)
        v_all = quant.dequantize_store(v_all, view(scales["v_scale"]), q.dtype)
    return masked_decode_scores(q, k_all, v_all, q_pos, mask)


def _dense_decode(q, k, v, cache: KVCache, layer: int):
    """Dense row cache: write the window at each row's start (clamped
    as :func:`decode_window` says), then attend."""
    b, t = q.shape[0], q.shape[1]
    length = cache.k[layer].shape[1]
    if not cache.vector_index:
        idx = int(cache.index)
        start = min(max(idx, 0), length - t)
        for store, upd in _writes(k, v, cache, layer):
            store[:, start:start + t] = upd
        return _attend(q, idx + torch.arange(t, device=q.device), cache, layer)
    w = _window(cache, t)
    for store, upd in _writes(k, v, cache, layer):
        store[w.write] = upd
    return _attend(q, w.q_pos, cache, layer, mask=w.mask)


def _paged_decode(q, k, v, cache: KVCache, layer: int):
    """Block pool: scatter the window through the table (as
    :func:`decode_window` says), then attend through the table."""
    if not cache.vector_index:
        raise ValueError(
            "paged decode requires per-row (vector) cache positions — the "
            "serving engine's path; inference.generate stays on the dense "
            "cache"
        )
    nb, bs, heads, _ = cache.k[layer].shape
    b, t = q.shape[0], q.shape[1]
    mb = cache.block_table.shape[1]
    w = _window(cache, t)
    (flat,) = w.write
    for store, upd in _writes(k, v, cache, layer):
        tail = store.shape[-1]
        store.view(nb * bs, heads, tail)[flat] = upd.reshape(-1, heads, tail)

    def view(x):  # the rows' logical [B, mb * bs, H, .] view
        return x[w.table].reshape(b, mb * bs, heads, x.shape[-1])

    return _attend(q, w.q_pos, cache, layer, view, mask=w.mask,
                   block_table=cache.block_table, block_size=bs)


class Attention(nn.Module):
    """Multi-head self-attention with a packed qkv projection (output
    laid out ``[..., 3, heads, head_dim]``), non-causal unless
    ``causal`` (the LM's). Without a cache it attends over the whole
    input by ``attn_impl``: ``"xla"`` (plain masked softmax) and
    ``"pallas"`` (the flash kernels, which read q, k and v as views of
    the packed projection) through ``dot_product_attention``; ``"fused"``
    hands the flat ``[B, T, 3·H·d]`` projection to
    ``flash_packed.fused_qkv_attention``; ``"auto"`` picks ``"fused"``
    on a CUDA tensor where ``flash_packed.supports`` holds and
    ``"xla"`` otherwise (JAX's rule, with "on a TPU" read as "on the
    card"). With a :class:`KVCache` (causal only) it runs the decode
    paths."""

    def __init__(self, hidden: int, num_heads: int, dtype: torch.dtype,
                 device=None, attn_impl: str = "xla", causal: bool = False,
                 fused_dense_grad: Optional[bool] = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        self.attn_impl = attn_impl
        self.causal = causal
        self.qkv = _dense(hidden, 3 * hidden, dtype, device, fused_dense_grad)
        self.proj = _dense(hidden, hidden, dtype, device, fused_dense_grad)

    def _resolve_impl(self, x: torch.Tensor, head_dim: int) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        if x.dim() == 3 and x.is_cuda and flash_packed.supports(
                x.shape[1], self.num_heads, head_dim):
            return "fused"
        return "xla"

    def forward(self, x: torch.Tensor, cache: Optional[KVCache] = None,
                layer: int = 0) -> torch.Tensor:
        b, t, _ = x.shape
        # num_heads is this rank's share under tensor parallelism
        head_dim, d = self.head_dim, self.num_heads * self.head_dim
        qkv_flat = self.qkv(x)
        impl = self._resolve_impl(x, head_dim) if cache is None else None
        if impl == "fused":
            # The kernel reads head columns from the packed projection.
            return self.proj(flash_packed.fused_qkv_attention(
                qkv_flat, self.num_heads, causal=self.causal))
        q, k, v = qkv_flat.view(b, t, 3, self.num_heads, head_dim).unbind(2)
        if cache is None:
            out = dot_product_attention(q, k, v, causal=self.causal, impl=impl)
        elif not self.causal:
            raise ValueError("decode with a KV cache requires causal attention")
        elif cache.block_size:
            out = _paged_decode(q, k, v, cache, layer)
        else:
            out = _dense_decode(q, k, v, cache, layer)
        return self.proj(out.reshape(b, t, d))


class EncoderBlock(nn.Module):
    """Pre-norm: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``; the
    LayerNorms in f32, their outputs cast to the compute dtype. With
    ``masks`` (:meth:`mask_shapes`), dropout after the attention's
    ``proj`` and inside the MLP."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int, dtype: torch.dtype,
                 device=None, attn_impl: str = "xla",
                 fused_dense_grad: Optional[bool] = None, dropout: float = 0.0) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout = dropout
        self.ln1 = LayerNorm(hidden, device=device)
        self.attn = Attention(hidden, num_heads, dtype, device, attn_impl,
                              fused_dense_grad=fused_dense_grad)
        self.ln2 = LayerNorm(hidden, device=device)
        self.mlp = MlpBlock(hidden, mlp_dim, dtype, device, fused_dense_grad, dropout)

    def mask_shapes(self, shape) -> List[Tuple[int, ...]]:
        return [tuple(shape)] + self.mlp.mask_shapes(shape)

    def forward(self, x: torch.Tensor, masks: Masks = None) -> torch.Tensor:
        a = self.attn(self.ln1(x).to(self.dtype))
        if masks:
            a = noise.apply_keep_mask(a, masks[0], self.dropout)
        x = x + a
        return x + self.mlp(self.ln2(x).to(self.dtype), masks[1:] if masks else None)


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(hidden, (p, p), strides=p, padding="VALID")`` in the
    compute dtype: OIHW ``weight``, the bias added after the product (two
    roundings in bf16, as in flax)."""

    def __init__(self, hidden: int, patch_size: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.weight = nn.Parameter(
            torch.empty(hidden, 3, patch_size, patch_size, device=device))
        self.bias = nn.Parameter(torch.empty(hidden, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> ``[B, tokens, hidden]`` (row-major patches)."""
        dt = self.dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt), stride=self.patch_size)
        return y.flatten(2).transpose(1, 2) + self.bias.to(dt)


class ViT(nn.Module):
    """ViT with a classification head (cls-token pooling) over NHWC
    images; returns f32 ``[B, num_classes]`` logits. ``attn_impl``
    defaults to ``"auto"``, as JAX's. flax sizes ``pos_embed`` from the
    first input; here ``image_size`` does, at construction. ``dropout``
    and ``remat`` as the module docstring says: a training forward draws
    its masks from ``generator``. Built with
    uninitialised parameters on ``device`` (``None`` means CUDA, and
    raises without it): load ``convert.init_vit_params`` or
    ``convert.vit_params_from_flax`` into it."""

    def __init__(self, variant: str = "b", patch_size: int = 16, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, device=None, attn_impl: str = "auto",
                 dropout: float = 0.0, remat: bool = False, image_size: int = 224,
                 fused_dense_grad: Optional[bool] = None) -> None:
        super().__init__()
        if variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {sorted(_VARIANTS)}")
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by patch {patch_size}")
        device = resolve_device(device)
        hidden, depth, heads, mlp_dim = _VARIANTS[variant]
        self.variant = variant
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.image_size = image_size
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.depth = depth
        self.dropout, self.remat = dropout, remat
        # The train step hands a model that draws dropout noise its
        # per-step, per-rank generator.
        self.stochastic = dropout > 0
        self.patch_embed = PatchEmbed(hidden, patch_size, dtype, device)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.empty(1, 1, hidden, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, tokens, hidden, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden, heads, mlp_dim, dtype, device, attn_impl, fused_dense_grad,
                         dropout)
            for _ in range(depth)
        )
        self.ln_final = LayerNorm(hidden, device=device)
        self.head = _dense(hidden, num_classes, torch.float32, device, fused_dense_grad)

    def kernel_parameters(self) -> Tuple[torch.Tensor, ...]:
        """The Dense weights and the patch-embed conv weight (the flax
        ``kernel`` leaves), what the L2 penalty covers; ``cls_token``,
        ``pos_embed``, biases and LayerNorm are exempt, as in JAX."""
        return (self.patch_embed.weight,) + tuple(
            m.weight for m in self.modules() if isinstance(m, Dense))

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, _ = images.shape
        if (h, w) != (self.image_size, self.image_size):
            raise ValueError(f"images {h}x{w}, but the model was built for {self.image_size}")
        x = self.patch_embed(images)
        cls = self.cls_token.to(self.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = run_block(block, x, generator, self.training, self.remat)
        x = self.ln_final(x)[:, 0]  # cls token
        return self.head(x).float()
