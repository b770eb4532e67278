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

The random draw is Gumbel-max with ``jax.random.categorical``'s own
bits: under the partitionable threefry this repo pins, the uniform of
vocab entry ``i`` is the threefry-2x32 cipher of the 64-bit counter
``i`` under the slot's ladder key, its two output words XORed, the top
23 bits made the mantissa of a float in ``[1, 2)``, minus 1, floored at
``finfo(f32).tiny`` (:func:`gumbel_uniforms`, bitwise ``jax.random.
uniform``'s). The Gumbel noise ``-log(-log(u))`` agrees with JAX's to
the last bits of the two libraries' ``log``, so sampled streams equal
the JAX package's except on a near-tie of two noisy logits. All sampled
slots of a call draw in one batched ``[S, vocab]`` pass.

:func:`spec_verify_slots` is the speculative tier's acceptance rule
(JAX's ``spec_verify_slots``/``_spec_row``): greedy slots accept a draft
while it equals the target's argmax; sampled slots accept draft ``d``
with probability ``p(d)`` (a uniform from ``fold_in(key, 0)``) and
commit a residual or bonus draw (``fold_in(key, 1)``), both with JAX's
bits.
"""

from __future__ import annotations

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.serving import keys as keylib

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


_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _random_bits(keys, n: int, device) -> torch.Tensor:
    """``jax.random``'s 32 bits for the counters ``0 .. n - 1`` under
    each ``[2]`` uint32 row of ``keys``: the threefry-2x32 cipher of the
    64-bit counter, its two output words XORed; ``[S, n]`` int64 on
    ``device``. The rounds of ``keys._threefry2x32_core`` run in int64
    words masked to 32 bits (``>>`` on int64 is arithmetic, so every
    word is masked before it shifts)."""
    k = torch.as_tensor(np.asarray(keys, np.uint32).reshape(-1, 2).astype(np.int64),
                        device=device)
    ks = (k[:, :1], k[:, 1:], k[:, :1] ^ k[:, 1:] ^ _PARITY)
    idx = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x0 = (idx >> 32) + ks[0]  # the counter's hi word (0 below 2**32)
    x1 = ((idx & _MASK32) + ks[1]) & _MASK32
    x0 = x0 & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK32
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0 ^ x1


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 in [0, 1): the top 23 bits as the mantissa
    of a float in [1, 2), minus 1 (``jax.random.uniform``'s rule)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def fold_keys(keys, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for each ``[2]`` uint32 row of
    ``keys``: ``[S, 2]`` uint32."""
    return np.stack([keylib.fold_key(k, data)
                     for k in np.asarray(keys, np.uint32).reshape(-1, 2)])


def key_uniforms(keys, device) -> torch.Tensor:
    """``jax.random.uniform(key)`` (one f32 in [0, 1)) for each ``[2]``
    uint32 row of ``keys``: ``[S]`` on ``device``."""
    return _unit_floats(_random_bits(keys, 1, device))[:, 0]


def gumbel_uniforms(keys, vocab: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (1, vocab), minval=tiny, maxval=1.)``
    for each ``[2]`` uint32 row of ``keys``, bitwise: ``[S, vocab]`` f32
    on ``device``."""
    f = _unit_floats(_random_bits(keys, vocab, device))
    tiny = torch.finfo(torch.float32).tiny
    # jax computes f * (maxval - minval) + minval; (1 - tiny) rounds to
    # 1.0 in f32, so that is f + tiny.
    return torch.clamp(f + tiny, min=tiny)


def _draw(filtered: torch.Tensor, keys) -> torch.Tensor:
    """Gumbel-max draws from ``[S, vocab]`` filtered logits, row ``s``
    under ``keys[s]`` (``argmax(gumbel + logits)``, as jax's
    ``categorical`` computes it). Returns ``[S]`` int64."""
    u = gumbel_uniforms(keys, filtered.shape[-1], filtered.device)
    return torch.argmax(-torch.log(-torch.log(u)) + filtered, dim=-1)


def _filter(logits: torch.Tensor, temperature: float, top_k: int,
            top_p: float, top_k_cap: int) -> torch.Tensor:
    scaled = _scale(logits, temperature)
    if top_p > 0:
        return _filter_full(scaled, int(top_k), float(top_p))
    return _filter_topk(scaled, int(top_k), top_k_cap)


def sample_slot(logits: torch.Tensor, key, temperature: float, top_k: int,
                top_p: float, top_k_cap: int = DEFAULT_TOP_K_CAP) -> torch.Tensor:
    """One slot's next token (0-d int64 tensor on ``logits``' device)
    from ``[vocab]`` logits. ``key`` is the slot's ``[2]`` uint32 ladder
    row (unused when greedy)."""
    if temperature <= 0:
        return torch.argmax(logits)
    filtered = _filter(logits, temperature, top_k, top_p, top_k_cap)
    return _draw(filtered[None], np.asarray(key)[None])[0]


def sample_slots(logits: torch.Tensor, keys: np.ndarray, temperatures: np.ndarray,
                 top_ks: np.ndarray, top_ps: np.ndarray,
                 top_k_cap: int = DEFAULT_TOP_K_CAP) -> torch.Tensor:
    """``[S, vocab]`` logits + per-slot host configs -> ``[S]`` tokens on
    the logits' device. Greedy slots share one batched ``argmax``; the
    sampled slots are filtered row by row and draw in one batched pass."""
    out = torch.argmax(logits, dim=-1)
    sampled = np.flatnonzero(np.asarray(temperatures) > 0)
    if sampled.size:
        filtered = torch.stack([
            _filter(logits[i], float(temperatures[i]), int(top_ks[i]),
                    float(top_ps[i]), top_k_cap)
            for i in sampled
        ])
        rows = torch.as_tensor(sampled, device=logits.device)
        out[rows] = _draw(filtered, np.asarray(keys)[sampled])
    return out


# Deterministic proposers make the draft distribution q a point mass at
# the proposed token, so speculative sampling specialises to: accept d
# with probability min(1, p(d)/q(d)) = p(d); on rejection draw from p
# with d masked out (renormalised); if every draft is accepted, draw a
# bonus token from the last position's p. The committed stream is then
# distributed exactly as the target's; for greedy slots the rule is
# argmax equality, so the stream is the target's greedy chain.


def _commit(drafts: torch.Tensor, accepted: torch.Tensor,
            final: torch.Tensor) -> torch.Tensor:
    """``[S, K+1]``: drafts before each slot's ``accepted`` count, then
    ``final`` at it, zeros after (padding the caller never reads)."""
    s, k = drafts.shape
    idx = torch.arange(k + 1, device=drafts.device)[None, :]
    pad = torch.cat([drafts, drafts.new_zeros(s, 1)], dim=1)
    a = accepted[:, None]
    return torch.where(idx < a, pad, torch.where(idx == a, final, 0))


def _accepted(accept: torch.Tensor) -> torch.Tensor:
    """Leading accepted drafts per row: ``sum(cumprod(accept))``."""
    return torch.cumprod(accept.long(), dim=-1).sum(dim=-1)


def _spec_rows(logits, drafts, keys, temps, top_ks, top_ps, top_k_cap):
    """The sampled slots' verify (``_spec_row`` for each): ``logits``
    ``[R, K+1, vocab]``, ``drafts`` ``[R, K]``, ``keys`` ``[R, K+1, 2]``
    numpy. Returns ``(final [R, K+1], accepted [R])``."""
    r, k1, vocab = logits.shape
    k = k1 - 1
    filt = torch.stack([
        torch.stack([_filter(logits[i, j], float(temps[i]), int(top_ks[i]),
                             float(top_ps[i]), top_k_cap) for j in range(k1)])
        for i in range(r)
    ])  # [R, K+1, vocab] f32, finfo.min where filtered
    probs = torch.softmax(filt, dim=-1)
    p_draft = probs[:, :k].gather(-1, drafts[:, :, None])[..., 0]
    keys = np.asarray(keys, np.uint32).reshape(r * k1, 2)
    u = key_uniforms(fold_keys(keys, 0), logits.device).view(r, k1)[:, :k]
    accepted = _accepted(u < p_draft)
    # Residual (draft masked out) at positions < K, bonus (unmasked) at
    # K: one draw per position; the accepted count picks the one that
    # commits.
    res = filt.clone()
    rows = torch.arange(r, device=logits.device)[:, None]
    res[rows, torch.arange(k, device=logits.device)[None, :], drafts] = _NEG
    final = _draw(res.view(r * k1, vocab), fold_keys(keys, 1)).view(r, k1)
    return final, accepted


def spec_verify_slots(logits: torch.Tensor, drafts, keys, temperatures,
                      top_ks, top_ps, top_k_cap: int = DEFAULT_TOP_K_CAP):
    """Speculative verify over the slot axis.

    ``logits`` ``[S, K+1, vocab]`` (the batched verify forward over
    ``[committed_next, d_1 .. d_K]``), ``drafts`` ``[S, K]``, ``keys``
    ``[S, K+1, 2]`` uint32, per-slot configs ``[S]`` (numpy). Returns
    ``(committed [S, K+1], accepted [S])`` int64 tensors on the logits'
    device: slot ``i`` commits ``accepted[i] + 1`` tokens. When every
    slot is greedy the verify is one argmax and a compare."""
    drafts = torch.as_tensor(np.asarray(drafts), dtype=torch.long, device=logits.device)
    k = drafts.shape[1]
    choice = torch.argmax(logits, dim=-1)  # [S, K+1]
    final = choice
    accepted = _accepted(drafts == choice[:, :k])
    sampled = np.flatnonzero(np.asarray(temperatures) > 0)
    if sampled.size:
        rows = torch.as_tensor(sampled, device=logits.device)
        f_s, a_s = _spec_rows(
            logits[rows], drafts[rows], np.asarray(keys)[sampled],
            np.asarray(temperatures)[sampled], np.asarray(top_ks)[sampled],
            np.asarray(top_ps)[sampled], top_k_cap)
        final = final.clone()
        final[rows] = f_s
        accepted[rows] = a_s
    return _commit(drafts, accepted, final), accepted
