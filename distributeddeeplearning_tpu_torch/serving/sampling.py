"""Per-slot, data-driven token sampling (port of ``serving/sampling.py``).

The sampling knobs are per-slot data (``[num_slots]`` vectors: device
tensors inside the engine's captured programs, numpy arrays elsewhere;
keys as ``[..., 2]`` uint32 rows or their int64 words), with the JAX
package's sentinels: ``temperature <= 0`` = greedy, ``top_k == 0`` /
``top_p == 0`` = filter off. :func:`sample_slots` and
:func:`spec_verify_slots` branch on none of them on the host: every row
runs the full-sort filter and the draw, and ``where`` selects by the
row's temperature, so one CUDA graph serves any mix of requests. JAX
takes a sort-free top-k filter for a batch without a nucleus row
(``lax.cond(any(top_ps > 0))``; the verify chooses row by row): its
k-th value is the number the sort finds once ``top_k`` is clipped at
the static ``top_k_cap`` as that filter clips it (:func:`_capped`), so
the rows equal JAX's bit for bit. A batch with no sampled row, a
fact the caller holds on the host, passes ``greedy=True`` and runs the
argmax alone (the engine captures that variant beside the sampling
one). Every numeric step mirrors the reference: f32 upcast and a true
divide by the temperature (a device tensor, so CUDA does not take its
multiply-by-reciprocal path for scalar divisors); the k-th threshold
*by value*; the nucleus keep-rule on the *unfiltered* sorted
distribution; greedy is ``argmax`` of the raw logits (first index on
ties). :func:`sample_slot`, ``inference.generate``'s per-row sampler,
branches on its host configs and keeps the sort-free ``topk`` filter
when ``top_p`` is off.

The random draw is Gumbel-max with ``jax.random.categorical``'s own
bits: under the partitionable threefry this repo pins, the uniform of
vocab entry ``i`` is the threefry-2x32 cipher of the 64-bit counter
``i`` under the slot's ladder key, its two output words XORed, the top
23 bits made the mantissa of a float in ``[1, 2)``, minus 1, floored at
``finfo(f32).tiny`` (:func:`gumbel_uniforms`, bitwise ``jax.random.
uniform``'s). The Gumbel noise ``-log(-log(u))`` agrees with JAX's to
the last bits of the two libraries' ``log``, so sampled streams equal
the JAX package's except on a near-tie of two noisy logits. All slots of
a call draw in one batched ``[S, vocab]`` pass.

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


def _as(x, device, dtype) -> torch.Tensor:
    """A per-slot config (numpy, list, tensor or one scalar) as a tensor
    on ``device``; a scalar becomes a ``[1]`` fill, with no host copy."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    if np.ndim(x) == 0:
        return torch.full((1,), float(x) if dtype.is_floating_point else int(x),
                          dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def _scale(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """``[R, vocab]`` f32 logits over each row's temperature (1 where
    greedy)."""
    return logits.float() / torch.where(temps > 0, temps, 1.0)[:, None]


def _filter_topk(scaled: torch.Tensor, top_k: int, top_k_cap: int) -> torch.Tensor:
    """Sort-free filter of one ``[vocab]`` row under a host ``top_k``:
    the k-th value from ``topk`` at ``min(top_k, cap)``, the number a
    sort finds (JAX clips ``top_k`` to the cap the same way)."""
    if top_k <= 0:
        return scaled
    kth = torch.topk(scaled, min(top_k, top_k_cap, scaled.shape[-1])).values[-1]
    return torch.where(scaled < kth, _NEG, scaled)


def _capped(top_ks, nucleus: torch.Tensor, top_k_cap: int) -> torch.Tensor:
    """``top_ks`` as ``[R]`` int64, clipped at ``top_k_cap`` where
    ``nucleus`` is false: where JAX's sort-free filter serves the row,
    which reads the k-th value at ``min(top_k, cap)``."""
    top_ks = _as(top_ks, nucleus.device, torch.int64).reshape(-1)
    return torch.where(nucleus, top_ks, top_ks.clamp(max=top_k_cap))


def _filter_full(scaled: torch.Tensor, top_ks, top_ps) -> torch.Tensor:
    """Full-sort filter of ``[R, vocab]`` rows under ``[R]`` configs (or
    of one ``[vocab]`` row under scalar ones, JAX's per-row signature):
    one descending sort serves both filters; the nucleus rule on the
    unfiltered sorted distribution."""
    if scaled.dim() == 1:
        return _filter_full(scaled[None], top_ks, top_ps)[0]
    top_ks = _as(top_ks, scaled.device, torch.int64).reshape(-1)
    top_ps = _as(top_ps, scaled.device, torch.float32).reshape(-1)
    vocab = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_ks.clamp(1, vocab) - 1)[:, None])
    out = torch.where((top_ks[:, None] > 0) & (scaled < kth), _NEG, scaled)
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_ps[:, None]
    threshold = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where((top_ps[:, None] > 0) & (out < threshold), _NEG, out)


_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _key_words(keys, device) -> torch.Tensor:
    """``[..., 2]`` uint32 key rows (numpy) or int64 tensors as ``[N, 2]``
    int64 words on ``device``."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64).reshape(-1, 2)
    return torch.as_tensor(np.asarray(keys, np.uint32).reshape(-1, 2).astype(np.int64),
                           device=device)


def _threefry(k: torch.Tensor, idx: torch.Tensor):
    """The threefry-2x32 cipher of the 64-bit counters ``idx`` (``[1,
    n]`` int64) under each ``[N, 2]`` int64 key row: its two output words
    ``[N, n]``. The rounds of ``keys._threefry2x32_core`` run in int64
    words masked to 32 bits (``>>`` on int64 is arithmetic, so every
    word is masked before it shifts)."""
    ks = (k[:, :1], k[:, 1:], k[:, :1] ^ k[:, 1:] ^ _PARITY)
    x0 = ((idx >> 32) + ks[0]) & _MASK32  # the counter's hi word (0 below 2**32)
    x1 = ((idx & _MASK32) + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK32
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def _random_bits(keys, n: int, device) -> torch.Tensor:
    """``jax.random``'s 32 bits for the counters ``0 .. n - 1`` under
    each ``[2]`` key row of ``keys`` (uint32 numpy or int64 tensor): the
    threefry-2x32 cipher of the 64-bit counter, its two output words
    XORed; ``[N, n]`` int64 on ``device``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x0, x1 = _threefry(_key_words(keys, device), idx)
    return x0 ^ x1


def _fold(keys, data: int, device) -> torch.Tensor:
    """:func:`fold_keys` on the device: ``[N, 2]`` int64 words."""
    idx = torch.full((1, 1), int(data), dtype=torch.int64, device=device)
    x0, x1 = _threefry(_key_words(keys, device), idx)
    return torch.cat([x0, x1], dim=1)


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


def sample_slot(logits: torch.Tensor, key, temperature: float, top_k: int,
                top_p: float, top_k_cap: int = DEFAULT_TOP_K_CAP) -> torch.Tensor:
    """One slot's next token (0-d int64 tensor on ``logits``' device)
    from ``[vocab]`` logits and host configs, branching on the host
    (``inference.generate``'s per-row sampler, JAX's ``sample_slot``):
    the full sort only when ``top_p`` is on. ``key`` is the slot's
    ``[2]`` uint32 ladder row (unused when greedy)."""
    if temperature <= 0:
        return torch.argmax(logits)
    scaled = _scale(logits[None], _as(temperature, logits.device, torch.float32))
    if top_p > 0:
        filtered = _filter_full(scaled, top_k, top_p)
    else:
        filtered = _filter_topk(scaled[0], int(top_k), top_k_cap)[None]
    return _draw(filtered, np.asarray(key)[None])[0]


def sample_slots(logits: torch.Tensor, keys, temperatures, top_ks, top_ps,
                 top_k_cap: int = DEFAULT_TOP_K_CAP, greedy: bool = False) -> torch.Tensor:
    """``[S, vocab]`` logits + per-slot configs -> ``[S]`` int64 tokens
    on the logits' device, as data: no host branch on the configs, so a
    captured program serves any mix. ``keys`` are ``[S, 2]`` rows
    (uint32 numpy or int64 tensor); temperatures, top-k and top-p are
    ``[S]`` (numpy or tensors). Every row is filtered (the full sort,
    ``top_k`` clipped at ``top_k_cap`` unless a row uses ``top_p``, as
    JAX's batch-level cond does) and draws; greedy rows (temperature <= 0) take the ``argmax`` of the raw
    logits instead. ``greedy=True`` says no row samples: the argmax
    alone runs, with the same result."""
    choice = torch.argmax(logits, dim=-1)
    if greedy:
        return choice
    dev = logits.device
    temps = _as(temperatures, dev, torch.float32)
    top_ps = _as(top_ps, dev, torch.float32)
    top_ks = _capped(top_ks, (top_ps > 0).any(), top_k_cap)
    filtered = _filter_full(_scale(logits, temps), top_ks, top_ps)
    return torch.where(temps > 0, _draw(filtered, keys), choice)


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


def spec_verify_slots(logits: torch.Tensor, drafts, keys, temperatures,
                      top_ks, top_ps, top_k_cap: int = DEFAULT_TOP_K_CAP,
                      greedy: bool = False):
    """Speculative verify over the slot axis, as data (no host branch).

    ``logits`` ``[S, K+1, vocab]`` (the batched verify forward over
    ``[committed_next, d_1 .. d_K]``), ``drafts`` ``[S, K]``, ``keys``
    ``[S, K+1, 2]`` (uint32 numpy or int64 tensor), per-slot configs
    ``[S]`` (numpy or tensors). Returns ``(committed [S, K+1], accepted
    [S])`` int64 tensors on the logits' device: slot ``i`` commits
    ``accepted[i] + 1`` tokens. Greedy rows accept while a draft equals
    the target's argmax and commit the argmax; sampled rows
    (``_spec_row``) accept draft ``d`` with probability ``p(d)`` and
    commit a residual or bonus draw. Every row computes both, and a
    row's temperature selects: what JAX's batch-level
    ``lax.cond(any(temperatures > 0))`` gives row by row. ``greedy=True``
    says no row samples: the greedy rule alone runs."""
    dev = logits.device
    s, k1, vocab = logits.shape
    k = k1 - 1
    drafts = _as(drafts, dev, torch.int64)
    choice = torch.argmax(logits, dim=-1)  # [S, K+1]
    greedy_accept = drafts == choice[:, :k]
    if greedy:
        accepted = _accepted(greedy_accept)
        return _commit(drafts, accepted, choice), accepted
    temps = _as(temperatures, dev, torch.float32)
    top_ps = _as(top_ps, dev, torch.float32)
    top_ks = _capped(top_ks, top_ps > 0, top_k_cap)  # JAX's per-row cond
    sampled = temps[:, None] > 0
    filt = _filter_full(
        _scale(logits.reshape(s * k1, vocab), temps.repeat_interleave(k1)),
        top_ks.repeat_interleave(k1), top_ps.repeat_interleave(k1),
    ).view(s, k1, vocab)  # finfo.min where filtered
    probs = torch.softmax(filt, dim=-1)
    p_draft = probs[:, :k].gather(-1, drafts[:, :, None])[..., 0]
    keys = _key_words(keys, dev)  # [S * (K+1), 2]
    u = key_uniforms(_fold(keys, 0, dev), dev).view(s, k1)[:, :k]
    accepted = _accepted(torch.where(sampled, u < p_draft, greedy_accept))
    # Residual (draft masked out) at positions < K, bonus (unmasked) at
    # K: one draw per position; the accepted count picks the one that
    # commits.
    pad = torch.cat([drafts, drafts.new_full((s, 1), -1)], dim=1)  # -1 matches no id
    ids = torch.arange(vocab, device=dev)
    res = torch.where(ids == pad[:, :, None], _NEG, filt)
    draws = _draw(res.view(s * k1, vocab), _fold(keys, 1, dev)).view(s, k1)
    return _commit(drafts, accepted, torch.where(sampled, draws, choice)), accepted
