"""Per-slot, data-driven token sampling (port of ``serving/sampling.py``).

The sampling knobs are per-slot data (``[num_slots]`` numpy vectors the
engine holds on the host), with the JAX package's sentinels:
``temperature <= 0`` = greedy, ``top_k == 0`` / ``top_p == 0`` = filter
off. Every numeric step mirrors the reference: f32 upcast and
temperature divide; the k-th threshold *by value* (from ``topk`` at the
static ``top_k_cap`` when no nucleus filter is in play, from one
descending sort otherwise); the nucleus keep-rule on the *unfiltered*
sorted distribution; greedy is ``argmax`` of the raw logits (first index
on ties).

The random draw is Gumbel-max, as ``jax.random.categorical`` draws, with
the uniforms taken from a ``torch.Generator`` seeded from the slot's
ladder key. It cannot reproduce ``jax.random``'s bits: sampled streams
differ from the JAX package's (same distribution, other draws), while
each slot's draw still depends only on its own key and logits, never on
the batch it rides in.
"""

from __future__ import annotations

import numpy as np
import torch

# Largest per-request top_k the sort-free path serves (SERVE_TOP_K_CAP).
DEFAULT_TOP_K_CAP = 128

_NEG = torch.finfo(torch.float32).min


def _scale(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits.float() / (temperature if temperature > 0 else 1.0)


def _filter_topk(scaled: torch.Tensor, top_k: int, top_k_cap: int) -> torch.Tensor:
    """Sort-free filter: the k-th value from ``topk`` at the static cap."""
    if top_k <= 0:
        return scaled
    cap = min(top_k_cap, scaled.shape[-1])
    kth = torch.topk(scaled, cap).values[min(max(top_k, 1), cap) - 1]
    return torch.where(scaled < kth, _NEG, scaled)


def _filter_full(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Full-sort filter: one descending sort serves both filters."""
    vocab = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, descending=True).values
    out = scaled
    if top_k > 0:
        kth = sorted_desc[min(max(top_k, 1), vocab) - 1]
        out = torch.where(scaled < kth, _NEG, scaled)
    if top_p > 0:
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        threshold = torch.where(keep, sorted_desc, torch.inf).min()
        out = torch.where(out < threshold, _NEG, out)
    return out


def seed_from_key(key) -> int:
    """The 64-bit generator seed of a ``[2]`` uint32 ladder key."""
    k = np.asarray(key, np.uint32).reshape(2)
    return (int(k[0]) << 32) | int(k[1])


def _draw(filtered: torch.Tensor, key) -> torch.Tensor:
    """Gumbel-max draw from ``filtered`` logits under ``key``."""
    gen = torch.Generator(device=filtered.device)
    gen.manual_seed(seed_from_key(key))
    u = torch.rand(
        filtered.shape, generator=gen, device=filtered.device, dtype=torch.float32
    ).clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(filtered - torch.log(-torch.log(u)))


def sample_slot(logits: torch.Tensor, key, temperature: float, top_k: int,
                top_p: float, top_k_cap: int = DEFAULT_TOP_K_CAP) -> torch.Tensor:
    """One slot's next token (0-d int64 tensor on ``logits``' device)
    from ``[vocab]`` logits. ``key`` is the slot's ``[2]`` uint32 ladder
    row (unused when greedy)."""
    if temperature <= 0:
        return torch.argmax(logits)
    scaled = _scale(logits, temperature)
    if top_p > 0:
        filtered = _filter_full(scaled, int(top_k), float(top_p))
    else:
        filtered = _filter_topk(scaled, int(top_k), top_k_cap)
    return _draw(filtered, key)


def sample_slots(logits: torch.Tensor, keys: np.ndarray, temperatures: np.ndarray,
                 top_ks: np.ndarray, top_ps: np.ndarray,
                 top_k_cap: int = DEFAULT_TOP_K_CAP) -> torch.Tensor:
    """``[S, vocab]`` logits + per-slot host configs -> ``[S]`` tokens on
    the logits' device. Greedy slots share one batched ``argmax``; each
    sampled slot draws from its own generator."""
    out = torch.argmax(logits, dim=-1)
    for i in np.flatnonzero(np.asarray(temperatures) > 0):
        out[i] = sample_slot(
            logits[i], keys[i], float(temperatures[i]), int(top_ks[i]),
            float(top_ps[i]), top_k_cap,
        )
    return out
