"""Autoregressive inference for the LM (port of ``inference.py``):
KV-cache allocation and the sequential ``generate`` reference.

``generate`` is the per-request reference path: the whole prompt in one
forward over a fresh dense cache sized to the request (prompt +
``max_new_tokens``, scalar positions), then one token per step. Row
``b`` samples under its own key ladder (row 0 the request ``rng``, row
``b > 0`` ``fold_key(rng, b)``), so each row's stream equals the same
request served alone by the slot engine (``serving.SlotEngine``), greedy
or sampled. Its draws are the JAX package's own threefry bits
(``serving/sampling.py``), so sampled streams equal the JAX package's
except on a near-tie of two noisy logits, and greedy streams agree.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.models.vit import KVCache
from distributeddeeplearning_tpu_torch.ops import quant

Stores = Tuple[List[torch.Tensor], List[torch.Tensor],
               Optional[List[torch.Tensor]], Optional[List[torch.Tensor]]]


def kv_stores(model, rows: Tuple[int, int], device, kv_dtype: str = "bf16") -> Stores:
    """Zeroed per-layer K/V stores ``[*rows, H, d]`` (dense ``(batch,
    length)`` or paged ``(num_blocks, block_size)``): ``(k, v, k_scale,
    v_scale)``. Native (``"bf16"``) stores hold the model's compute dtype
    and no scales; ``"int8"``/``"fp8"`` hold codes plus f32 scales
    ``[*rows, H, 1]``, zeroed too, so that an unwritten slot dequantizes
    to an exact zero (JAX's ``jnp.zeros`` scale init)."""
    store = quant.kv_store_dtype(kv_dtype)
    shape = tuple(rows) + (model.num_heads, model.head_dim)

    def zeros(shape, dtype):
        return [torch.zeros(shape, dtype=dtype, device=device) for _ in model.blocks]

    if store is None:
        return zeros(shape, model.dtype), zeros(shape, model.dtype), None, None
    tail = shape[:-1] + (1,)
    return (zeros(shape, store), zeros(shape, store),
            zeros(tail, torch.float32), zeros(tail, torch.float32))


def dense_cache(model, batch: int, length: int, device, kv_dtype: str = "bf16") -> KVCache:
    """Zeroed dense rows ``[batch, length, H, d]`` per layer (index 0),
    in the compute dtype or quantized (:func:`kv_stores`)."""
    k, v, ks, vs = kv_stores(model, (batch, length), device, kv_dtype)
    return KVCache(k=k, v=v, kv_dtype=kv_dtype, k_scale=ks, v_scale=vs)


def paged_pools(model, num_blocks: int, block_size: int, device):
    """Zeroed block pools ``[num_blocks, block_size, H, d]`` per layer in
    the compute dtype (K list, V list)."""
    return kv_stores(model, (num_blocks, block_size), device)[:2]


def key_data(rng: Any) -> np.ndarray:
    """Request key data from ``rng``: raw ``[2]`` uint32 key data, an
    int seed, or None (seed 0) — ``ReqSpec.key_data``'s rule."""
    # The serving package imports this module: import it at call time.
    from distributeddeeplearning_tpu_torch.serving import keys as keylib

    if rng is None:
        return keylib.key_from_seed(0)
    if isinstance(rng, (int, np.integer)):
        return keylib.key_from_seed(int(rng))
    return np.asarray(rng, np.uint32).reshape(2)


@torch.no_grad()
def generate(
    model,
    prompt,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_token: Optional[int] = None,
    pad_token: Optional[int] = None,
    rng: Any = None,
    engine=None,
    on_token=None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` ([B, Tp]
    integers) on the model's device. Returns ``[B, Tp + max_new_tokens]``
    int64 (prompt included). Once a row emits ``eos_token`` its
    remaining positions hold ``pad_token`` (default: the eos token).

    ``engine``: a ``serving.SlotEngine``, ``serving.Server`` or fleet
    ``serving.Router``: the rows are then served as continuous-batching
    requests on its slot pool(s) (``serving.generate_with_engine``),
    bitwise equal to this function at B = 1 (rows b > 0 sample under
    their own folded keys), and the result is a host tensor; ``model``
    is not used. ``on_token``: a streaming callback ``(row, token)``,
    engine route only, called as each token is committed; the returned
    tokens are exactly the streamed ones."""
    from distributeddeeplearning_tpu_torch.serving import keys as keylib
    from distributeddeeplearning_tpu_torch.serving.sampling import sample_slot

    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if on_token is not None and engine is None:
        raise ValueError(
            "on_token streaming requires the engine route "
            "(generate(engine=server_or_router))"
        )
    if engine is not None:
        from distributeddeeplearning_tpu_torch.serving.scheduler import generate_with_engine

        out = generate_with_engine(
            engine, np.asarray(torch.as_tensor(prompt).cpu(), np.int32),
            max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token=eos_token, pad_token=pad_token, rng=rng,
            on_token=on_token)
        return torch.from_numpy(out).long()
    device = model.tok_embed.device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device)
    b, t_prompt = prompt.shape
    total = t_prompt + max_new_tokens
    if total > model.max_seq_len:
        raise ValueError(
            f"prompt {t_prompt} + max_new_tokens {max_new_tokens} exceeds "
            f"model.max_seq_len {model.max_seq_len}"
        )
    if eos_token is not None and pad_token is None:
        pad_token = eos_token
    tk = int(top_k or 0)
    if tk >= model.vocab_size:
        tk = 0  # keeps every token, as the reference's clamp does
    tp = float(top_p or 0.0)
    base = key_data(rng)
    ladders = [
        keylib.request_key_ladder(base if r == 0 else keylib.fold_key(base, r),
                                  max_new_tokens)
        for r in range(b)
    ]

    def sample(logits, step):
        return torch.stack([
            sample_slot(logits[r], ladders[r][step], temperature, tk, tp,
                        top_k_cap=model.vocab_size)
            for r in range(b)
        ])

    cache = dense_cache(model, b, total, device)
    logits = model(prompt, cache)
    tok = sample(logits[:, -1], 0)
    out = [tok]
    done = (tok == eos_token) if eos_token is not None else None
    for i in range(1, max_new_tokens):
        cache.index = t_prompt + i - 1
        logits = model(tok[:, None], cache)
        nxt = sample(logits[:, -1], i)
        if eos_token is not None:
            nxt = torch.where(done, pad_token, nxt)
            done = done | (nxt == eos_token)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
