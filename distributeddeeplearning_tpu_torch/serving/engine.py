"""Slot-pool batched decode engine (port of ``serving/engine.py``).

One KV store per attention layer — dense ``[num_slots, max_len, H, d]``
rows or, with ``kv_layout="paged"``, one shared ``[num_blocks,
block_size, H, d]`` pool addressed through per-slot block tables — and
two kinds of step:

* the *decode step*: every slot advances one token in one ``[num_slots]``
  forward (per-slot positions, per-slot sampling config as data).
  Requests join and leave between steps; the batch shape never changes.
* the *prefill*: the prompt, padded up the bucket ladder, runs one
  forward into the slot's rows (dense) or through the slot's block
  table (paged, where a prefix-cache hit computes only the suffix).

PyTorch runs eagerly, so the JAX package's closed set of compiled
programs becomes a fixed set of shapes: one per bucket plus the
``[num_slots]`` decode batch, and nothing is compiled. The KV pool is
updated IN PLACE (JAX donates and replaces it).

The engine runs on ``device`` (default ``"cuda"``; raises without
CUDA). With ``decode_kernel="fused"`` every per-row attention call — the
decode step on both layouts and the paged prefill — goes through
``ops.paged_decode.fused_decode_attention``, which launches the
hand-written Hopper kernel on a CUDA device; ``"xla"`` keeps the plain
masked path. The dense prefill uses scalar positions and always takes
the plain path, as in the JAX package.

Not ported yet (raise): speculative decoding (``spec_k > 0``), int8/fp8
KV or weights, pool typing (``pool_role != "both"``) and slot
export/import.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.inference import (
    dense_cache,
    key_data,
    paged_pools,
)
from distributeddeeplearning_tpu_torch.models.vit import KVCache
from distributeddeeplearning_tpu_torch.serving import keys as keylib
from distributeddeeplearning_tpu_torch.serving.blocks import (
    BlockAllocator,
    BlockPoolExhausted,
)
from distributeddeeplearning_tpu_torch.serving.sampling import (
    DEFAULT_TOP_K_CAP,
    sample_slot,
    sample_slots,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

_STORE_DTYPES = ("bf16", "int8", "fp8")


def check_store_dtype(name: str, value: str) -> None:
    """Reject unknown KV/weight dtypes naming the supported list, and the
    quantized tiers, which wait for the ``ops/quant.py`` slice."""
    if value not in _STORE_DTYPES:
        raise ValueError(f"{name} must be one of {_STORE_DTYPES}, got {value!r}")
    if value != "bf16":
        raise NotImplementedError(
            f"{name}={value!r}: the quantized tiers are not ported yet"
        )


def default_buckets(max_len: int, smallest: int = 16) -> Tuple[int, ...]:
    """Power-of-two prefill ladder up to ``max_len`` (always including
    ``max_len`` itself so any admissible prompt has a bucket)."""
    out: List[int] = []
    b = smallest
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(sorted(set(out)))


@dataclasses.dataclass
class ReqSpec:
    """One request's generation spec — ``inference.generate``'s keyword
    surface; ``rng`` is raw key data ([2] uint32), an int seed, or None
    (seed 0)."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    rng: Any = None

    def validate(self, max_len: int, max_bucket: int) -> None:
        t = int(np.asarray(self.prompt).shape[-1])
        if np.asarray(self.prompt).ndim != 1 or t < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        if t > max_bucket:
            raise ValueError(
                f"prompt length {t} exceeds the largest prefill bucket "
                f"{max_bucket}"
            )
        if t + self.max_new_tokens > max_len:
            raise ValueError(
                f"prompt {t} + max_new_tokens {self.max_new_tokens} "
                f"exceeds the engine cache length {max_len}"
            )
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")

    def key_data(self) -> np.ndarray:
        return key_data(self.rng)


class SlotEngine:
    """Continuous-batching decode over ``num_slots`` KV-cache slots.

    Takes ownership of ``model`` (a ``TransformerLM``): it is moved to
    ``device``, loaded with ``params`` (a state dict, see
    ``models.convert``) when given, and its matmul weights are cast to
    the compute dtype in place. Queueing, deadlines and request
    lifecycles live in :class:`~.scheduler.Server`.
    """

    def __init__(
        self,
        model,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        num_slots: int = 8,
        max_len: Optional[int] = None,
        buckets: Optional[Tuple[int, ...]] = None,
        top_k_cap: int = DEFAULT_TOP_K_CAP,
        kv_layout: str = "dense",
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        kv_dtype: str = "bf16",
        weight_dtype: str = "bf16",
        decode_kernel: str = "xla",
        spec_k: int = 0,
        pool_role: str = "both",
        device=None,
    ) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}"
            )
        if pool_role != "both":
            raise NotImplementedError(
                f"pool_role={pool_role!r}: disaggregated pools are not ported yet"
            )
        if spec_k:
            raise NotImplementedError(
                f"spec_k={spec_k}: speculative decoding is not ported yet"
            )
        check_store_dtype("kv_dtype", kv_dtype)
        check_store_dtype("weight_dtype", weight_dtype)
        if decode_kernel not in ("xla", "fused"):
            raise ValueError(
                f"decode_kernel must be one of ('xla', 'fused'), got "
                f"{decode_kernel!r}"
            )
        self.device = resolve_device(device)
        model_max = int(model.max_seq_len)
        max_len = model_max if max_len is None else int(max_len)
        if max_len > model_max:
            raise ValueError(
                f"max_len {max_len} exceeds model.max_seq_len {model_max}"
            )
        model.to(self.device)
        if params is not None:
            model.load_state_dict(params)
        model.cast_matmul_weights_()
        model.eval()
        self.model = model
        self.num_slots = int(num_slots)
        self.max_len = max_len
        self.kv_layout = kv_layout
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.decode_kernel = decode_kernel
        self.allocator: Optional[BlockAllocator] = None
        self.prefix_cache = bool(prefix_cache) and kv_layout == "paged"
        if kv_layout == "paged":
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got {block_size}")
            self.block_size = int(block_size)
            self.blocks_per_slot = -(-self.max_len // self.block_size)
            if num_blocks is None:
                # Dense-equivalent KV bytes (+ the trash block): paging
                # wins by admitting more, not by shrinking the pool.
                num_blocks = self.num_slots * self.blocks_per_slot + 1
            self.num_blocks = int(num_blocks)
            self.allocator = BlockAllocator(self.num_blocks, self.block_size)
        else:
            self.block_size = 0
            self.blocks_per_slot = 0
            self.num_blocks = 0
        bs = tuple(sorted(set(int(b) for b in (buckets or default_buckets(max_len)))))
        if not bs or bs[0] < 1:
            raise ValueError(f"invalid bucket ladder {bs}")
        if bs[-1] > max_len:
            raise ValueError(f"largest bucket {bs[-1]} exceeds max_len {max_len}")
        self.buckets = bs
        if top_k_cap < 1:
            raise ValueError(f"top_k_cap must be >= 1, got {top_k_cap}")
        self.top_k_cap = int(top_k_cap)

        s = self.num_slots
        self._active = np.zeros(s, bool)
        self._tokens = np.zeros(s, np.int64)
        self._positions = np.zeros(s, np.int64)
        self._temps = np.zeros(s, np.float32)
        self._top_ks = np.zeros(s, np.int32)
        self._top_ps = np.zeros(s, np.float32)
        self._eos = np.full(s, -1, np.int64)
        self._ladders: List[Optional[np.ndarray]] = [None] * s
        self._cursor = np.zeros(s, np.int64)
        self._tables = (
            np.zeros((s, self.blocks_per_slot), np.int32)
            if kv_layout == "paged" else None
        )
        self._slot_blocks: List[List[int]] = [[] for _ in range(s)]
        self.last_prefill: Optional[Dict[str, Any]] = None
        self._k: Optional[List[torch.Tensor]] = None
        self._v: Optional[List[torch.Tensor]] = None
        self.decode_steps = 0
        self.prefill_execs = 0
        self._warmed = False

    # -- set-up ------------------------------------------------------------

    def warmup(self) -> None:
        """Allocate the KV store and, under the fused kernel on a CUDA
        device, build and load the kernel — set-up that would otherwise
        land in the first request's TTFT (idempotent)."""
        if self._k is None:
            if self.kv_layout == "paged":
                self._k, self._v = paged_pools(
                    self.model, self.num_blocks, self.block_size, self.device
                )
            else:
                cache = dense_cache(
                    self.model, self.num_slots, self.max_len, self.device
                )
                self._k, self._v = cache.k, cache.v
        if self.decode_kernel == "fused" and self.device.type == "cuda":
            from distributeddeeplearning_tpu_torch.ops import paged_decode

            paged_decode._library()
        self._warmed = True
        if self.kv_layout == "paged":
            self._emit_pool_gauges()
        acct = self.byte_accounting()
        obs.gauge("serve.kv_bytes_per_token", float(acct["kv_bytes_per_token"]))
        obs.gauge("serve.param_bytes", float(acct["param_bytes"]))
        obs.gauge(
            "serve.decode_kernel",
            1.0 if self.decode_kernel == "fused" else 0.0,
            kernel=self.decode_kernel,
        )
        get_logger().info(
            "serve warmup: slots=%d cache_len=%d layout=%s kernel=%s device=%s",
            self.num_slots, self.max_len, self.kv_layout, self.decode_kernel,
            self.device,
        )

    # -- accounting --------------------------------------------------------

    def _emit_pool_gauges(self) -> None:
        a = self.allocator
        obs.gauge("serve.block_pool_total", float(a.capacity))
        obs.gauge("serve.block_pool_free", float(a.free_count))
        obs.gauge("serve.prefix_hits", float(a.stats["prefix_hit_blocks"]))

    def byte_accounting(self) -> Dict[str, float]:
        """KV-pool bytes per cached position and resident param bytes."""
        m = self.model
        elem = torch.empty((), dtype=m.dtype).element_size()
        per_pos = 2 * len(m.blocks) * m.num_heads * m.head_dim * elem
        positions = (
            self.num_blocks * self.block_size if self.kv_layout == "paged"
            else self.num_slots * self.max_len
        )
        param_bytes = sum(p.numel() * p.element_size() for p in m.parameters())
        return {
            "kv_pool_bytes": float(per_pos * positions),
            "kv_bytes_per_token": float(per_pos),
            "param_bytes": float(param_bytes),
        }

    # -- admission ---------------------------------------------------------

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Physical blocks a request writes: positions 0 ..
        prompt_len + max_new_tokens - 2 (the final sampled token is never
        fed back, so its K/V is never written)."""
        return self.allocator.blocks_for_tokens(prompt_len + max_new_tokens - 1)

    def can_admit(self, spec: ReqSpec) -> bool:
        """Admission gate beyond slot availability: on the paged layout a
        request needs its (prefix-discounted) block count free."""
        if self.allocator is None:
            return True
        prompt = np.asarray(spec.prompt, np.int32).reshape(-1)
        t = prompt.shape[0]
        hit = self.allocator.peek_prefix(prompt, t - 1) if self.prefix_cache else 0
        hit = self._prefix_fit(t, hit)
        need = self.blocks_needed(t, spec.max_new_tokens) - hit
        return self.allocator.free_count >= max(need, 0)

    def _prefix_fit(self, t: int, n_blocks: int) -> int:
        """Largest usable cached-prefix block count for a ``t``-token
        prompt: a hit shifts the suffix bucket window to ``[start, start
        + bucket)``, and rows past ``max_len`` have no position
        embedding (the gather would raise here; in JAX it fills NaN that
        poisons every slot through the trash block)."""
        start = n_blocks * self.block_size
        while n_blocks and start + self.bucket_for(t - start) > self.max_len:
            n_blocks -= 1
            start -= self.block_size
        return n_blocks

    @property
    def free_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if not self._active[i]]

    @property
    def active_slots(self) -> List[int]:
        return [i for i in range(self.num_slots) if self._active[i]]

    @property
    def occupancy(self) -> float:
        return float(self._active.sum()) / self.num_slots

    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.buckets[-1]}"
        )

    def validate_spec(self, spec: ReqSpec) -> int:
        """Full admission validation; returns the effective top_k
        (``top_k >= vocab`` maps to 0 = filter off)."""
        spec.validate(self.max_len, self.buckets[-1])
        if self.allocator is not None:
            t = int(np.asarray(spec.prompt).shape[-1])
            worst = self.blocks_needed(t, spec.max_new_tokens)
            if worst > self.allocator.capacity:
                raise ValueError(
                    f"request needs {worst} KV blocks but the pool holds "
                    f"{self.allocator.capacity}; raise SERVE_NUM_BLOCKS / "
                    "SlotEngine(num_blocks=...)"
                )
        tk = int(spec.top_k or 0)
        if tk and tk >= int(self.model.vocab_size):
            tk = 0
        if tk > self.top_k_cap and spec.top_p is None:
            raise ValueError(
                f"top_k {tk} exceeds the engine's sort-free cap "
                f"{self.top_k_cap}; raise SlotEngine(top_k_cap=...) / "
                "SERVE_TOP_K_CAP"
            )
        return tk

    # -- steps -------------------------------------------------------------

    def _tensor(self, array, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype).to(
            self.device, non_blocking=True
        )

    @torch.no_grad()
    def prefill(self, slot: int, spec: ReqSpec) -> Tuple[int, bool]:
        """Admit ``spec`` into ``slot``: run the bucketed prefill, seat the
        request's sampling state, and return (first token, eos hit). The
        slot is occupied afterwards even on an immediate eos — the
        caller decides to :meth:`release`."""
        if self._active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        tk = self.validate_spec(spec)
        if not self._warmed:
            self.warmup()
        prompt = np.asarray(spec.prompt, np.int32).reshape(-1)
        t = prompt.shape[0]
        sampled = spec.temperature > 0.0
        ladder = (
            keylib.request_key_ladder(spec.key_data(), spec.max_new_tokens)
            if sampled else None
        )
        key0 = ladder[0] if sampled else np.zeros(2, np.uint32)
        temp = float(spec.temperature) if sampled else 0.0
        top_p = float(spec.top_p or 0.0)
        eos = -1 if spec.eos_token is None else int(spec.eos_token)
        if self.allocator is not None:
            last = self._prefill_paged(slot, spec, prompt)
        else:
            bucket = self.bucket_for(t)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :t] = prompt
            # A fresh zeroed row, scalar index 0: the prompt's forward is
            # the lockstep path inference.generate runs.
            k = [c[slot:slot + 1] for c in self._k]
            v = [c[slot:slot + 1] for c in self._v]
            for c in k + v:
                c.zero_()
            logits = self.model(self._tensor(padded), KVCache(k, v, index=0))
            last = logits[0, t - 1]
            self.last_prefill = {
                "slot": slot, "bucket": bucket, "start": 0, "shared_blocks": 0,
            }
        self.prefill_execs += 1
        self.last_prefill["logits"] = last
        first = int(sample_slot(last, key0, temp, tk, top_p, self.top_k_cap))
        self._active[slot] = True
        self._tokens[slot] = first
        self._positions[slot] = t
        self._temps[slot] = temp
        self._top_ks[slot] = tk
        self._top_ps[slot] = top_p
        self._eos[slot] = eos
        self._ladders[slot] = ladder
        self._cursor[slot] = 1
        return first, eos >= 0 and first == eos

    def _prefill_paged(self, slot, spec, prompt) -> torch.Tensor:
        """Paged admission: match the prompt's block-aligned prefix in the
        prefix cache, allocate the remaining blocks (all-or-nothing;
        :class:`BlockPoolExhausted` propagates as backpressure), and
        prefill ONLY the divergent suffix through the slot's block table.
        The match is capped at ``prompt_len - 1`` tokens so the last
        prompt position is always computed. Returns its logits."""
        a = self.allocator
        t = prompt.shape[0]
        shared: List[int] = a.match_prefix(prompt, t - 1) if self.prefix_cache else []
        keep = self._prefix_fit(t, len(shared))
        if keep < len(shared):
            a.release_match(shared[keep:])
            shared = shared[:keep]
        start = len(shared) * self.block_size
        suffix_len = t - start
        bucket = self.bucket_for(suffix_len)
        need_new = self.blocks_needed(t, spec.max_new_tokens) - len(shared)
        try:
            fresh = a.alloc(max(need_new, 0))
        except BlockPoolExhausted:
            a.release_match(shared)
            raise
        blocks = shared + fresh
        table_row = np.zeros((1, self.blocks_per_slot), np.int32)
        table_row[0, :len(blocks)] = blocks
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :suffix_len] = prompt[start:]
        cache = KVCache(
            self._k, self._v, index=self._tensor([start]),
            block_table=self._tensor(table_row, torch.int32),
            block_size=self.block_size, decode_kernel=self.decode_kernel,
        )
        logits = self.model(self._tensor(padded), cache)
        if self.prefix_cache:
            # The full prompt blocks are now written and immutable
            # (decode writes start at prompt_len): make them findable.
            a.register_prefix(prompt, blocks)
        self._tables[slot] = table_row[0]
        self._slot_blocks[slot] = blocks
        self.last_prefill = {
            "slot": slot, "bucket": bucket, "start": start,
            "shared_blocks": len(shared), "blocks": list(blocks),
        }
        if shared:
            obs.counter("serve.prefix_hit_blocks", len(shared))
        self._emit_pool_gauges()
        return logits[0, suffix_len - 1]

    @torch.no_grad()
    def decode_step(self) -> List[Tuple[int, int, bool]]:
        """One batched decode tick: every occupied slot emits its next
        token. Returns ``[(slot, token, eos_hit), ...]`` for occupied
        slots (empty when the pool is idle). The forward always runs the
        full ``[num_slots]`` batch; free slots ride along at position 0
        writing into trash (paged) or their own stale row (dense)."""
        slots = self.active_slots
        if not slots:
            return []
        step_keys = np.zeros((self.num_slots, 2), np.uint32)
        for i in slots:
            ladder = self._ladders[i]
            if ladder is not None:
                step_keys[i] = ladder[min(self._cursor[i], len(ladder) - 1)]
        cache = KVCache(
            self._k, self._v, index=self._tensor(self._positions),
            decode_kernel=self.decode_kernel,
        )
        if self.allocator is not None:
            cache.block_table = self._tensor(self._tables, torch.int32)
            cache.block_size = self.block_size
        logits = self.model(self._tensor(self._tokens[:, None]), cache)
        nxt = sample_slots(
            logits[:, -1], step_keys, self._temps, self._top_ks, self._top_ps,
            top_k_cap=self.top_k_cap,
        ).cpu().numpy()
        self.decode_steps += 1
        out = []
        for i in slots:
            tok = int(nxt[i])
            self._tokens[i] = tok
            self._positions[i] += 1
            self._cursor[i] += 1
            out.append((i, tok, bool(self._eos[i] >= 0 and tok == self._eos[i])))
        return out

    def export_slot(self, slot: int):
        raise NotImplementedError(
            "slot export (disaggregated serving, migration) is not ported yet"
        )

    def import_slot(self, slot: int, state, prompt=None):
        raise NotImplementedError(
            "slot import (disaggregated serving, migration) is not ported yet"
        )

    def release(self, slot: int) -> None:
        """Free a slot (eviction). Host bookkeeping only: stale rows are
        unreachable (per-slot position masks) and overwritten by the next
        prefill into this slot. On the paged layout the slot's blocks are
        dereferenced (prefix-cached blocks stay resident and evictable)
        and its table row re-points at the trash block."""
        self._active[slot] = False
        self._ladders[slot] = None
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 0.0
        self._eos[slot] = -1
        self._cursor[slot] = 0
        if self.allocator is not None:
            for bid in self._slot_blocks[slot]:
                self.allocator.decref(bid)
            self._slot_blocks[slot] = []
            self._tables[slot] = 0
            self._emit_pool_gauges()
