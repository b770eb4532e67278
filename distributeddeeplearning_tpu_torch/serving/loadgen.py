"""Seeded serving load generation + warmup helpers (bench substrate).

Copied from ``distributeddeeplearning_tpu/serving/loadgen.py``; its one
JAX touchpoint, :func:`warm_shapes`, goes over the port's
``inference.generate``. The serve harness
(``distributeddeeplearning_tpu_torch/serve_bench.py``) builds every
protocol's load from it:

* :data:`PROFILES` / :data:`MIXED_PROMPT_LENS` — the request-shape
  mixes (``SERVE_PROFILE``): ``mixed`` cycles a handful of prompt
  lengths at one ``max_new``; ``longtail`` is the production-shaped
  distribution (mostly short prompts, a thin tail of long ones) the
  paged pool exists for; ``disagg`` is the bimodal
  long-prefill/long-decode storm a disaggregated fleet splits.
* :func:`build_requests` — seeded request set + Poisson arrival
  offsets over a shape mix. Deterministic in ``seed``: every protocol
  comparing two configurations replays the *same* load.
* :func:`build_tenant_requests` — the same stream with a tenant
  identity cycled over it (round-robin, so every tenant offers the
  same work mix and a fairness bound on *completed share vs weight
  share* is meaningful).
* :func:`warm_shapes` — warm every distinct ``(prompt_len, max_new)``
  shape through ``inference.generate`` so a sequential baseline
  measures steady-state throughput, not first-call set-up.
* :func:`percentile` — the nearest-rank percentile every serving bench
  reports TTFT/queue-wait with.

Pure host + numpy until :func:`warm_shapes` (the only torch
touchpoint), so load construction stays importable anywhere.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

# Request-shape mixes: (prompt_len, max_new) pairs cycled over the
# request stream. "longtail" is kept to few distinct shapes so a
# sequential baseline's per-shape warmup stays bounded.
PROFILES: Dict[str, Optional[List[Tuple[int, int]]]] = {
    "mixed": None,  # legacy: MIXED_PROMPT_LENS cycle, SERVE_MAX_NEW everywhere
    "longtail": (
        [(3, 8)] * 8 + [(4, 8)] * 6 + [(6, 8)] * 5 + [(8, 8)] * 4
        + [(12, 16)] * 3 + [(16, 16)] * 2
        + [(24, 16), (48, 24), (96, 32)]
    ),
    # Bimodal disaggregation storm: long-prefill/short-decode requests
    # (prefill-bound) interleaved with short-prefill/long-decode ones
    # (decode-bound). Under a colocated fleet the long decodes hold
    # slots and queue the long prefills behind them; a split fleet
    # serves each mode from its own pool. Few distinct shapes keeps the
    # sequential baseline's warmup (and the closed program set) small.
    "disagg": (
        [(96, 12)] * 4 + [(64, 12)] * 3
        + [(6, 48)] * 4 + [(4, 32)] * 3 + [(8, 48)] * 2
    ),
}
MIXED_PROMPT_LENS: Tuple[int, ...] = (4, 7, 12, 5, 16, 3, 9, 14)


def profile_shapes(
    profile: str, max_new: int
) -> List[Tuple[int, int]]:
    """The (prompt_len, max_new) mix for one ``SERVE_PROFILE`` value."""
    if profile not in PROFILES:
        raise ValueError(
            f"unknown SERVE_PROFILE {profile!r} (have: {sorted(PROFILES)})"
        )
    shapes = PROFILES[profile]
    if shapes is None:
        return [(tp, max_new) for tp in MIXED_PROMPT_LENS]
    return list(shapes)


def percentile(vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the serving benches' TTFT/queue-wait
    convention; 0 on an empty sample)."""
    vals = sorted(vals)
    if not vals:
        return 0.0
    idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
    return vals[idx]


def hot_prompt(vocab: int, length: int, seed: int = 0):
    """The deterministic "hot system prompt": every caller with the
    same (vocab, length, seed) gets the bitwise-identical token run, so
    a shared prefix built from it hashes to the same directory chain on
    every replica."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, size=(length,)).astype(np.int32)


def build_requests(
    n: int, rate_rps: float, seed: int, vocab: int,
    shapes: Sequence[Tuple[int, int]],
    shared_prefix=None,
) -> List[Dict[str, Any]]:
    """Seeded request set + Poisson arrival offsets (seconds) over the
    (prompt_len, max_new) shape mix — mixed lengths, per-request
    sampling seeds: the adversarial mix the parity oracles certify, at
    load. ``rate_rps == 0`` is the closed-backlog special case (all
    arrivals at t=0). ``shared_prefix`` (a token array, e.g.
    :func:`hot_prompt`) is prepended to every prompt — the "hot system
    prompt" shape the fleet prefix directory amortises; per-request
    tails stay distinct so only the prefix blocks are shareable."""
    import numpy as np

    pre = None
    if shared_prefix is not None:
        pre = np.asarray(shared_prefix).reshape(-1).astype(np.int32)
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(shapes))
    reqs = []
    t = 0.0
    for i in range(n):
        if rate_rps > 0:
            t += float(rng.exponential(1.0 / rate_rps))
        tp, max_new = shapes[order[i % len(shapes)]]
        prompt = rng.randint(0, vocab, size=(tp,)).astype(np.int32)
        if pre is not None:
            prompt = np.concatenate([pre, prompt])
        reqs.append({
            "arrival_s": t,
            "prompt": prompt,
            "max_new": int(max_new),
            "seed": int(rng.randint(0, 2**31 - 1)),
        })
    return reqs


def build_tenant_requests(
    tenant_ids: Sequence[str], n: int, rate_rps: float, seed: int,
    vocab: int, shapes: Sequence[Tuple[int, int]],
    shared_prefix=None,
) -> List[Dict[str, Any]]:
    """:func:`build_requests` with a ``tenant`` identity cycled over the
    stream. Round-robin assignment means every tenant offers the same
    shape mix and (to within one request) the same total token work —
    under contention, each tenant's *completed* share is then pinned by
    the router's weights alone, which is exactly what the fairness gate
    measures."""
    reqs = build_requests(
        n, rate_rps, seed, vocab, shapes, shared_prefix=shared_prefix
    )
    for i, r in enumerate(reqs):
        r["tenant"] = str(tenant_ids[i % len(tenant_ids)])
    return reqs


def warm_shapes(
    model, params, reqs: Sequence[Dict[str, Any]],
    temperature: float, top_k,
) -> int:
    """Warm every distinct (prompt_len, max_new) shape through
    ``inference.generate`` (the sequential baseline's shapes) so a timed
    run measures steady-state throughput. ``params`` is unused: the
    port's model holds its weights (the argument keeps the JAX
    signature). Returns the number of distinct shapes warmed."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.inference import generate

    del params
    shapes = sorted({(len(r["prompt"]), r["max_new"]) for r in reqs})
    for tp, n_new in shapes:
        generate(
            model, np.zeros((1, tp), np.int32),
            max_new_tokens=n_new, temperature=temperature, top_k=top_k,
            rng=0,
        )
    return len(shapes)
