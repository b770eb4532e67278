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
decode step on both layouts, the speculative verify and the paged
prefill — goes through ``ops.paged_decode.fused_decode_attention``,
which launches the hand-written Hopper kernel on a CUDA device; ``"xla"``
keeps the plain masked path. The dense prefill uses scalar positions and
always takes the plain path, as in the JAX package.

Quantized tiers (``ops/quant.py``): ``kv_dtype`` ``"int8"``/``"fp8"``
stores the KV pool as codes plus per-head f32 scales (the kernel
dequantizes in registers); ``weight_dtype`` ``"int8"``/``"fp8"``
quantizes every Dense weight and the tied embedding once, from the f32
parameters, and dequantizes them on use. fp8 falls back to int8, logged,
where the device cannot round-trip it.

Speculative tier (``spec_k > 0``): each tick drafts ``spec_k`` tokens per
slot, from the int8 self-draft (the same model with int8 weights, its
own dense KV pool, the plain decode path) or from prompt lookup
(``serving/spec.py``), then runs ONE ``[num_slots, spec_k + 1]``
verify forward of the target and commits 1 .. ``spec_k + 1`` tokens per
slot (``sampling.spec_verify_slots``).

Not ported yet (raise): pool typing (``pool_role != "both"``) and slot
export/import.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.inference import key_data, kv_stores
from distributeddeeplearning_tpu_torch.models.vit import KVCache
from distributeddeeplearning_tpu_torch.ops import quant
from distributeddeeplearning_tpu_torch.serving import keys as keylib
from distributeddeeplearning_tpu_torch.serving.blocks import (
    BlockAllocator,
    BlockPoolExhausted,
)
from distributeddeeplearning_tpu_torch.serving.sampling import (
    DEFAULT_TOP_K_CAP,
    sample_slot,
    sample_slots,
    spec_verify_slots,
)
from distributeddeeplearning_tpu_torch.serving.spec import (
    NgramDrafter,
    propose_all,
    validate_spec_config,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

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
    ``device``, loaded with ``params`` (an f32 state dict, see
    ``models.convert``) when given, quantized under a quantized
    ``weight_dtype``, and its remaining matmul weights are cast to the
    compute dtype in place. Queueing, deadlines and request lifecycles
    live in :class:`~.scheduler.Server`.
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
        spec_draft: str = "int8",
        spec_ngram_n: int = 3,
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
        quant.validate_store_dtype("kv_dtype", kv_dtype)
        quant.validate_store_dtype("weight_dtype", weight_dtype)
        self.device = resolve_device(device)
        # fp8 is device-gated: where the device cannot round-trip float8,
        # fall back to the int8 tier (same scale layout), logged.
        if "fp8" in (kv_dtype, weight_dtype) and not quant.fp8_supported(self.device):
            get_logger().warning(
                "fp8 storage unsupported on %s; falling back to int8 "
                "(kv_dtype=%s weight_dtype=%s)", self.device, kv_dtype, weight_dtype,
            )
            kv_dtype = "int8" if kv_dtype == "fp8" else kv_dtype
            weight_dtype = "int8" if weight_dtype == "fp8" else weight_dtype
        if decode_kernel not in ("xla", "fused"):
            raise ValueError(
                f"decode_kernel must be one of ('xla', 'fused'), got "
                f"{decode_kernel!r}"
            )
        validate_spec_config(spec_k, spec_draft, spec_ngram_n, weight_dtype)
        model_max = int(model.max_seq_len)
        max_len = model_max if max_len is None else int(max_len)
        if max_len > model_max:
            raise ValueError(
                f"max_len {max_len} exceeds model.max_seq_len {model_max}"
            )
        self.spec_k = int(spec_k)
        self.spec_draft = spec_draft if self.spec_k else "off"
        self.spec_ngram_n = int(spec_ngram_n)
        model.to(self.device)
        if params is not None:
            model.load_state_dict(params)
        # The int8 self-draft is the same model with int8 weights,
        # quantized like the target's from the f32 parameters.
        draft = copy.deepcopy(model) if self.spec_draft == "int8" else None
        if weight_dtype != "bf16":
            # From the f32 parameters: rounding to bf16 first would move
            # each row's amax, and so every code.
            model.quantize_weights_(weight_dtype)
        model.cast_matmul_weights_()
        model.eval()
        if draft is not None:
            draft.quantize_weights_("int8").cast_matmul_weights_().eval()
        self.model = model
        self._draft = draft
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
        # Speculative bookkeeping: the committed token before the next
        # input (the draft's catch-up pair), the per-slot commit budget
        # and the slot's emitted history (prompt + committed tokens).
        self._prev_tokens = np.zeros(s, np.int64)
        self._max_new = np.zeros(s, np.int64)
        self._history: List[Optional[List[int]]] = [None] * s
        self._drafter = (
            NgramDrafter(self.spec_ngram_n) if self.spec_draft == "ngram" else None
        )
        self.last_prefill: Optional[Dict[str, Any]] = None
        # (k, v, k_scale, v_scale) per-layer stores of the target and of
        # the int8 draft (ops/quant.py; scales None when native).
        self._stores = None
        self._draft_stores = None
        self.decode_steps = 0
        self.prefill_execs = 0
        self._warmed = False
        self.spec_stats: Dict[str, Any] = {
            "verify_ticks": 0, "tokens_accepted": 0, "tokens_rejected": 0,
            "tokens_committed": 0, "draft_s": 0.0, "verify_s": 0.0,
            "accept_rates": [],
        }

    @property
    def spec_enabled(self) -> bool:
        return self.spec_k > 0

    # -- set-up ------------------------------------------------------------

    def _rows(self) -> Tuple[int, int]:
        if self.kv_layout == "paged":
            return (self.num_blocks, self.block_size)
        return (self.num_slots, self.max_len)

    def _ensure_stores(self) -> None:
        if self._stores is None:
            self._stores = kv_stores(self.model, self._rows(), self.device, self.kv_dtype)
        if self._draft is not None and self._draft_stores is None:
            # Always dense: the draft pool is private lookahead scratch.
            self._draft_stores = kv_stores(
                self._draft, (self.num_slots, self.max_len), self.device, self.kv_dtype)

    def warmup(self) -> None:
        """Allocate the KV store(s) and, under the fused kernel on a CUDA
        device, build and load the kernel — set-up that would otherwise
        land in the first request's TTFT (idempotent)."""
        self._ensure_stores()
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
            "serve warmup: slots=%d cache_len=%d layout=%s kernel=%s kv=%s "
            "weights=%s%s device=%s",
            self.num_slots, self.max_len, self.kv_layout, self.decode_kernel,
            self.kv_dtype, self.weight_dtype,
            (f" spec k={self.spec_k} draft={self.spec_draft}"
             if self.spec_enabled else ""),
            self.device,
        )

    def _cache(self, stores, index, **kw) -> KVCache:
        k, v, ks, vs = stores
        return KVCache(k, v, index=index, kv_dtype=self.kv_dtype, k_scale=ks,
                       v_scale=vs, **kw)

    def _routed(self, index) -> KVCache:
        """The target's cache at per-row ``index`` (a ``[S]`` tensor),
        routed through the block tables on the paged layout."""
        cache = self._cache(self._stores, index, decode_kernel=self.decode_kernel)
        if self.allocator is not None:
            cache.block_table = self._tensor(self._tables, torch.int32)
            cache.block_size = self.block_size
        return cache

    # -- accounting --------------------------------------------------------

    def _emit_pool_gauges(self) -> None:
        a = self.allocator
        obs.gauge("serve.block_pool_total", float(a.capacity))
        obs.gauge("serve.block_pool_free", float(a.free_count))
        obs.gauge("serve.prefix_hits", float(a.stats["prefix_hit_blocks"]))

    def _store_bytes(self, model) -> float:
        """Bytes of one set of K/V stores (codes and scales itemized in)
        for ``model``'s geometry at this engine's pool size, per
        position: 2 stores x layers x H x (d x elem [+ 4 for a scale])."""
        store = quant.kv_store_dtype(self.kv_dtype)
        row = model.head_dim * (store or model.dtype).itemsize + (4 if store else 0)
        return 2 * len(model.blocks) * model.num_heads * row

    @staticmethod
    def _param_bytes(model) -> float:
        return float(sum(t.numel() * t.element_size() for t in model.state_dict().values()))

    def byte_accounting(self) -> Dict[str, float]:
        """The dtype-aware byte ledger (the ``serve.kv_bytes_per_token`` /
        ``serve.param_bytes`` gauges): KV-pool bytes per cached position,
        codes PLUS f32 scales when quantized, and the resident parameter
        bytes a decode step streams (codes, scales and the unquantized
        rest). Under the int8 self-draft its dense KV pool and its
        weights are itemized too."""
        rows = self._rows()
        positions = rows[0] * rows[1]
        per_pos = self._store_bytes(self.model)
        out = {
            "kv_pool_bytes": float(per_pos * positions),
            "kv_bytes_per_token": float(per_pos),
            "param_bytes": self._param_bytes(self.model),
        }
        if self._draft is not None:
            out["draft_kv_pool_bytes"] = float(
                self._store_bytes(self._draft) * self.num_slots * self.max_len)
            out["draft_param_bytes"] = self._param_bytes(self._draft)
        return out

    # -- admission ---------------------------------------------------------

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        """Physical blocks a request writes: positions 0 ..
        prompt_len + max_new_tokens - 2 (the final sampled token is never
        fed back, so its K/V is never written), plus ``spec_k`` lookahead
        positions a verify writes past the committed cursor."""
        return self.allocator.blocks_for_tokens(
            prompt_len + max_new_tokens - 1 + self.spec_k
        )

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
        t = int(np.asarray(spec.prompt).shape[-1])
        if self.spec_enabled and t + spec.max_new_tokens + self.spec_k > self.max_len:
            # A verify window past max_len would be clamped back over
            # committed rows (dense) or lack position embeddings.
            raise ValueError(
                f"prompt {t} + max_new_tokens {spec.max_new_tokens} "
                f"+ spec_k {self.spec_k} lookahead exceeds the "
                f"engine cache length {self.max_len}; shorten the "
                "request or build the engine with max_len + spec_k"
            )
        if self.allocator is not None:
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

    def _padded(self, tokens: np.ndarray, bucket: int) -> torch.Tensor:
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :tokens.shape[0]] = tokens
        return self._tensor(padded)

    def _dense_prefill(self, model, stores, slot: int, prompt: np.ndarray) -> torch.Tensor:
        """The prompt, padded to its bucket, through ``model`` into a
        fresh zeroed copy of ``slot``'s dense rows at scalar index 0 (the
        lockstep path ``inference.generate`` runs). Returns the logits."""
        rows = [None if c is None else [x[slot:slot + 1] for x in c] for c in stores]
        for c in rows:
            for x in c or ():
                x.zero_()
        return model(self._padded(prompt, self.bucket_for(prompt.shape[0])),
                     self._cache(rows, 0))

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
        # A speculative tick consumes one key per verify position, so the
        # ladder carries spec_k rows past max_new_tokens (the split is
        # prefix-stable in n: rows 0 .. max_new - 1 are unchanged).
        ladder = (
            keylib.request_key_ladder(spec.key_data(), spec.max_new_tokens + self.spec_k)
            if sampled else None
        )
        key0 = ladder[0] if sampled else np.zeros(2, np.uint32)
        temp = float(spec.temperature) if sampled else 0.0
        top_p = float(spec.top_p or 0.0)
        eos = -1 if spec.eos_token is None else int(spec.eos_token)
        if self.allocator is not None:
            last = self._prefill_paged(slot, spec, prompt)
        else:
            logits = self._dense_prefill(self.model, self._stores, slot, prompt)
            last = logits[0, t - 1]
            self.last_prefill = {
                "slot": slot, "bucket": self.bucket_for(t), "start": 0,
                "shared_blocks": 0,
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
        if self.spec_enabled:
            self._max_new[slot] = spec.max_new_tokens
            self._prev_tokens[slot] = int(prompt[-1])
            self._history[slot] = [int(x) for x in prompt] + [first]
            if self._draft is not None:
                # The draft attends over its OWN K/V of the whole prompt
                # (int8-weight K/V differ from the target's), even when
                # the target's prefill rode a prefix-cache hit.
                self._dense_prefill(self._draft, self._draft_stores, slot, prompt)
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
        cache = self._cache(
            self._stores, self._tensor([start]),
            block_table=self._tensor(table_row, torch.int32),
            block_size=self.block_size, decode_kernel=self.decode_kernel,
        )
        logits = self.model(self._padded(prompt[start:], bucket), cache)
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
        logits = self.model(self._tensor(self._tokens[:, None]),
                            self._routed(self._tensor(self._positions)))
        nxt = sample_slots(
            logits[:, -1], step_keys, self._temps, self._top_ks, self._top_ps,
            top_k_cap=self.top_k_cap,
        ).cpu().numpy()
        self.decode_steps += 1
        out = []
        for i in slots:
            tok = int(nxt[i])
            if self.spec_enabled:
                # Keep the drafter's view of the committed stream current.
                self._prev_tokens[i] = self._tokens[i]
                if self._history[i] is not None:
                    self._history[i].append(tok)
            self._tokens[i] = tok
            self._positions[i] += 1
            self._cursor[i] += 1
            out.append((i, tok, bool(self._eos[i] >= 0 and tok == self._eos[i])))
        return out

    def _draft_proposals(self) -> np.ndarray:
        """The int8 self-draft's ``[num_slots, spec_k]`` greedy proposals:
        one ``[S, 2]`` catch-up forward (the previous committed token and
        the next input; after an all-accepted tick the draft's cache is
        one position behind, and the pair closes the gap), then
        ``spec_k - 1`` single-token steps, all over one dequantized copy
        of the draft's weights."""
        start = np.maximum(self._positions - 1, 0)
        catchup = np.stack([self._prev_tokens, self._tokens], axis=1)
        with quant.hold_dequantized(self._draft, self._draft.dtype):
            logits = self._draft(self._tensor(catchup),
                                 self._cache(self._draft_stores, self._tensor(start)))
            tok = torch.argmax(logits[:, -1], dim=-1)
            drafts = [tok]
            for j in range(1, self.spec_k):
                cache = self._cache(self._draft_stores, self._tensor(start + 1 + j))
                logits = self._draft(tok[:, None], cache)
                tok = torch.argmax(logits[:, -1], dim=-1)
                drafts.append(tok)
        return torch.stack(drafts, dim=1).cpu().numpy()

    @torch.no_grad()
    def spec_step(self) -> List[Tuple[int, List[int], bool]]:
        """One speculative tick: draft ``spec_k`` proposals per slot, ONE
        batched verify of the target over ``[num_slots, spec_k + 1]``
        positions, commit per-slot ``1 .. spec_k + 1`` tokens. Returns
        ``[(slot, committed_tokens, eos_hit), ...]`` for occupied slots,
        each list clamped to the request's remaining budget and cut at
        eos."""
        if not self.spec_enabled:
            raise RuntimeError("spec_step requires SlotEngine(spec_k > 0)")
        slots = self.active_slots
        if not slots:
            return []
        s, k = self.num_slots, self.spec_k
        tokens = np.zeros((s, k + 1), np.int64)
        tokens[:, 0] = self._tokens
        t0 = time.perf_counter()
        if self._draft is not None:
            drafts = self._draft_proposals()
        else:
            drafts = propose_all(self._drafter, self._history, slots, s, k)
        draft_s = time.perf_counter() - t0
        tokens[:, 1:] = drafts
        step_keys = np.zeros((s, k + 1, 2), np.uint32)
        for i in slots:
            ladder = self._ladders[i]
            if ladder is not None:
                c = int(self._cursor[i])
                step_keys[i] = ladder[c:c + k + 1]
        t1 = time.perf_counter()
        # Rejected-tail K/V writes land past the committed cursor and are
        # overwritten by the next tick's before any query attends them.
        logits = self.model(self._tensor(tokens), self._routed(self._tensor(self._positions)))
        committed, accepted = spec_verify_slots(
            logits, tokens[:, 1:], step_keys, self._temps, self._top_ks,
            self._top_ps, top_k_cap=self.top_k_cap,
        )
        committed = committed.cpu().numpy()
        accepted = accepted.cpu().numpy()
        verify_s = time.perf_counter() - t1
        self.decode_steps += 1
        out: List[Tuple[int, List[int], bool]] = []
        acc_total = rej_total = commit_total = 0
        for i in slots:
            a = int(accepted[i])
            acc_total += a
            rej_total += k - a
            remaining = int(self._max_new[i]) - int(self._cursor[i])
            toks = [int(x) for x in committed[i, :min(a + 1, remaining)]]
            eos = int(self._eos[i])
            eos_hit = eos >= 0 and eos in toks
            if eos_hit:
                toks = toks[:toks.index(eos) + 1]
            n = len(toks)
            commit_total += n
            self._prev_tokens[i] = toks[-2] if n >= 2 else self._tokens[i]
            self._tokens[i] = toks[-1]
            self._positions[i] += n
            self._cursor[i] += n
            if self._history[i] is not None:
                self._history[i].extend(toks)
            out.append((i, toks, eos_hit))
        st = self.spec_stats
        st["verify_ticks"] += 1
        st["tokens_accepted"] += acc_total
        st["tokens_rejected"] += rej_total
        st["tokens_committed"] += commit_total
        st["draft_s"] += draft_s
        st["verify_s"] += verify_s
        rate = acc_total / max(len(slots) * k, 1)
        if len(st["accept_rates"]) < 100_000:
            st["accept_rates"].append(rate)
        obs.gauge("serve.spec_accept_rate", rate)
        obs.gauge("serve.spec_draft_ms", draft_s * 1e3)
        obs.gauge("serve.spec_verify_ms", verify_s * 1e3)
        obs.counter("serve.spec_tokens_accepted", acc_total)
        obs.counter("serve.spec_tokens_rejected", rej_total)
        return out

    def force_token(self, slot: int, token: int) -> None:
        """Teacher forcing for quality oracles: override the token the
        NEXT decode step feeds this slot ("given this exact context, what
        would the engine emit?"). Positions, keys and sampling state are
        untouched."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        self._tokens[slot] = int(token)

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
        self._prev_tokens[slot] = 0
        self._max_new[slot] = 0
        self._history[slot] = None
        if self.allocator is not None:
            for bid in self._slot_blocks[slot]:
                self.allocator.decref(bid)
            self._slot_blocks[slot] = []
            self._tables[slot] = 0
            self._emit_pool_gauges()
