"""Host-side speculative-decode helpers (port of ``serving/spec.py``,
which imports no JAX; the port keeps its own copy).

* :class:`NgramDrafter`: the model-free prompt-lookup draft source
  (``SERVE_SPEC_DRAFT=ngram``): propose the ``k`` tokens that followed
  the most recent earlier occurrence of the slot's current suffix in its
  own emitted prefix (prompt + committed tokens). Proposals are
  deterministic, a point-mass draft distribution, which is what makes
  the engine's acceptance rule exact
  (``serving.sampling.spec_verify_slots``).
* :func:`validate_spec_config`: the ``SERVE_SPEC_*`` rules, shared by
  ``SlotEngine`` and ``ServeConfig``.

The int8 self-draft source runs on the device (the engine's quantized
draft model); it has no host part beyond the catch-up token the engine
keeps.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

DRAFT_SOURCES = ("int8", "ngram")


def validate_spec_config(
    spec_k: int, spec_draft: str, spec_ngram_n: int, weight_dtype: str,
) -> None:
    """The SERVE_SPEC_* contract. Raises ``ValueError`` with a pointer
    to the offending knob."""
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k == 0:
        return  # speculation off: the other knobs are inert
    if spec_draft not in DRAFT_SOURCES:
        raise ValueError(
            f"spec_draft must be one of {DRAFT_SOURCES} when spec_k > 0, "
            f"got {spec_draft!r} (SERVE_SPEC_DRAFT)"
        )
    if spec_draft == "int8" and weight_dtype not in ("", "bf16"):
        # The self-speculative draft IS the int8 quantization of the
        # target; a quantized target (int8 OR fp8) leaves no cheaper
        # tier to draft from (and would double-quantize the
        # already-quantized tree).
        raise ValueError(
            "spec_draft='int8' requires the native (bf16) weight tier — "
            f"with weight_dtype={weight_dtype!r} the target already runs "
            "quantized weights; use spec_draft='ngram' or drop "
            "SERVE_WEIGHT_DTYPE"
        )
    if spec_draft == "ngram" and spec_ngram_n < 2:
        raise ValueError(
            f"spec_ngram_n must be >= 2 (match on >= 1 trailing token), "
            f"got {spec_ngram_n}"
        )


class NgramDrafter:
    """Prompt-lookup draft proposals from a slot's own token history.

    For match lengths ``n-1`` down to 1 (longest first), find the most
    recent earlier occurrence of the history's trailing ``m`` tokens and
    propose the ``k`` tokens that followed it. No match → propose token
    0 ``k`` times: a deliberately *rejectable* proposal — the verify
    step then degenerates to one committed token per tick, exactly the
    non-speculative rate (correctness never depends on draft quality).
    """

    def __init__(self, n: int = 3) -> None:
        if n < 2:
            raise ValueError(f"ngram n must be >= 2, got {n}")
        self.n = int(n)
        self.stats = {"proposals": 0, "lookups_hit": 0, "lookups_miss": 0}

    def propose(self, history: Sequence[int], k: int) -> np.ndarray:
        """``k`` draft tokens ([k] int32) continuing ``history``."""
        h = np.asarray(history, np.int64).reshape(-1)
        out = np.zeros(k, np.int32)
        self.stats["proposals"] += 1
        if h.shape[0] < 2:
            self.stats["lookups_miss"] += 1
            return out
        for m in range(min(self.n - 1, h.shape[0] - 1), 0, -1):
            suffix = h[-m:]
            # Most recent earlier occurrence: window ends strictly
            # before the final position so the match has a continuation.
            windows = np.lib.stride_tricks.sliding_window_view(h[:-1], m)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size == 0:
                continue
            start = int(hits[-1]) + m  # first continuation token index
            cont = h[start:start + k]
            out[: cont.shape[0]] = cont.astype(np.int32)
            # Short continuations (match near the end) cycle the found
            # pattern rather than padding with zeros — still data, still
            # merely a proposal.
            if 0 < cont.shape[0] < k:
                reps = -(-k // cont.shape[0])
                out[:] = np.tile(cont, reps)[:k].astype(np.int32)
            self.stats["lookups_hit"] += 1
            return out
        self.stats["lookups_miss"] += 1
        return out


def propose_all(
    drafter: NgramDrafter,
    histories: List,
    slots: Sequence[int],
    num_slots: int,
    k: int,
) -> np.ndarray:
    """[num_slots, k] proposal matrix for one tick (inactive rows 0)."""
    out = np.zeros((num_slots, k), np.int32)
    for i in slots:
        if histories[i]:
            out[i] = drafter.propose(histories[i], k)
    return out
