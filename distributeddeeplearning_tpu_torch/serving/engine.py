"""Slot-pool batched decode engine (port of ``serving/engine.py``).

One KV store per attention layer — dense ``[num_slots, max_len, H, d]``
rows or, with ``kv_layout="paged"``, one shared ``[num_blocks,
block_size, H, d]`` pool addressed through per-slot block tables — and
a **closed set of programs** for the engine's whole lifetime, as in the
JAX package (:meth:`SlotEngine.program_specs`,
:attr:`SlotEngine.programs_expected`):

* one *decode step*: every slot advances one token in one ``[num_slots]``
  forward (per-slot positions, per-slot sampling config as data,
  per-slot stop detection on the device). Requests join and leave
  between steps; the program never changes.
* one *prefill* per prompt-length bucket: the prompt, padded up the
  bucket ladder, runs one forward; dense, over a fresh zero ``[1,
  max_len]`` cache whose rows then replace the slot's (the slot is a
  device index, JAX's ``dynamic_update_slice``); paged, through the
  slot's block table (a prefix-cache hit computes only the suffix). The
  first token is sampled inside the program from the true last prompt
  position (a device index).
* with ``spec_k > 0`` the ``[num_slots, spec_k + 1]`` verify, and for
  the int8 self-draft the draft phase and one draft prefill per bucket.

On a CUDA device :meth:`SlotEngine.warmup` captures each member as a
CUDA graph (after warm-up runs on the capture stream), all in one graph
memory pool, inside a ``compile`` span; it then emits ``serve.programs``
= ``compile_count``. A member that samples (decode, the prefills, the
verify) is captured twice, with the sampler and greedy-only, and the
host, which holds every slot's temperature, replays the greedy-only
graph when no row samples: JAX's ``lax.cond`` keeps the sampler's work
out of such a call in the same way. Both give a greedy row the same
token. Every per-call input lives in the member's static
device buffers (tokens, positions, block tables, the slot, start, the
padded prompt, keys, temperatures, top-k, top-p and eos), filled with
one host-to-device copy before each replay, and each member's outputs
are read back before another member replays (they share the pool).
After warmup the engine cannot capture again: ``compile_count`` stays
``programs_expected``. A capture that fails raises; there is no eager
fallback on the card. On the CPU each member installs its uncaptured
functions (:meth:`ProgramSpec.uncaptured`), so the count and the
idempotence hold there too. The KV stores are allocated before any
capture, outside the pool, and updated IN PLACE (JAX donates and
replaces them).

The engine runs on ``device`` (default ``"cuda"``; raises without
CUDA). With ``decode_kernel="fused"`` every per-row attention call — the
decode step on both layouts, the speculative verify and the paged
prefill — goes through ``ops.paged_decode.fused_decode_attention``,
which launches the hand-written Hopper kernel on a CUDA device (inside
the graphs once captured); ``"xla"`` keeps the plain masked path. The
dense prefill uses scalar positions and always takes the plain path, as
in the JAX package.

Quantized tiers (``ops/quant.py``): ``kv_dtype`` ``"int8"``/``"fp8"``
stores the KV pool as codes plus per-head f32 scales (the kernel
dequantizes in registers); ``weight_dtype`` ``"int8"``/``"fp8"``
quantizes every Dense weight and the tied embedding once, from the f32
parameters, and dequantizes them on use. fp8 falls back to int8, logged,
where the device cannot round-trip it.

Speculative tier (``spec_k > 0``): each tick drafts ``spec_k`` tokens per
slot, from the int8 self-draft (the same model with int8 weights, its
own dense KV pool, the plain decode path) or from prompt lookup on the
host (``serving/spec.py``), then runs ONE ``[num_slots, spec_k + 1]``
verify forward of the target and commits 1 .. ``spec_k + 1`` tokens per
slot (``sampling.spec_verify_slots``).

Disaggregated pools and slot transfer: ``pool_role`` ``"prefill"``
holds only the prefill ladder and ``"decode"`` only the decode step
(paged, non-speculative engines). :meth:`SlotEngine.export_slot` stages
a slot's sampling state and the content of its written KV blocks on the
host (torch CPU tensors keyed by the store names of
:meth:`SlotEngine.store_names`), and :meth:`SlotEngine.import_slot` /
:meth:`SlotEngine.adopt_prefix_blocks` write such content into freshly
allocated blocks IN PLACE (an indexed copy into the existing stores:
the captured graphs hold their addresses), so a replayed decode after an
import continues the stream bit for bit.

Threads: a fleet builds engines in replica threads while other
replicas pump. Captures take one process-wide lock (one capture at a
time: the caching allocator's pool bookkeeping and ``empty_cache``
must not overlap another capture), run on one capture stream per device
and in ``thread_local`` capture mode, so other threads' launches and
synchronising copies on their own streams go on during a capture. Each
engine's graphs get a merge-counter buffer of their own
(``ops/_counters.py`` keys buffers by stream), so engines replaying on
different streams never share one.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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

# Eager runs of each member on the capture stream before its capture.
_WARMUP_RUNS = 2

# One capture (or engine teardown) at a time in the process, all on one
# capture stream per device: cuBLAS keeps a workspace for every stream it
# has run on, for the life of the process, so a new stream for each
# capture would grow the allocation with every engine a fleet rebuilds.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


@dataclasses.dataclass
class ProgramSpec:
    """One member of the engine's closed program set: ``fn`` computes it
    from ``inputs``, the member's static input buffers by ``fn``'s
    parameter names, and returns its outputs. A member that samples is
    made twice (``variants``): with the sampler, and greedy-only for a
    call in which no row samples (``fn(..., greedy=True)``; JAX's
    ``lax.cond`` economy as two graphs the host picks between).
    :meth:`SlotEngine.warmup` captures exactly this list (``span``
    labels its ``compile`` span) into ``SlotEngine.programs``."""

    name: str
    fn: Callable[..., Tuple[torch.Tensor, ...]]
    inputs: Dict[str, torch.Tensor]
    span: Dict[str, Any]  # labels for the `compile` span
    samples: bool = False

    @property
    def variants(self) -> Tuple[bool, ...]:
        """The member's ``greedy`` flags: ``(False, True)`` if it samples."""
        return (False, True) if self.samples else (False,)

    def uncaptured(self) -> Dict[bool, Callable[[], Tuple[torch.Tensor, ...]]]:
        """The member's programs uncaptured, by variant: ``fn`` over the
        static inputs, the function a capture records, run eagerly."""
        if not self.samples:
            return {False: functools.partial(self.fn, **self.inputs)}
        return {g: functools.partial(self.fn, **self.inputs, greedy=g) for g in self.variants}


class CapturedProgram:
    """A member captured as a CUDA graph: calling it replays the graph
    on whatever its static inputs hold and returns its static outputs.
    ``launches`` counts the decode kernel's launches the capture
    recorded (the wrapper's count does not tick on replay), and
    ``launches_by_store`` the same by the cache's storage dtype;
    ``replays`` counts the replays since capture."""

    def __init__(self, graph: "torch.cuda.CUDAGraph", outputs,
                 launches: Dict[str, int]) -> None:
        self.graph, self.outputs = graph, outputs
        self.launches_by_store = {k: n for k, n in launches.items() if n}
        self.launches = sum(launches.values())
        self.replays = 0

    def __call__(self) -> Tuple[torch.Tensor, ...]:
        self.graph.replay()
        self.replays += 1
        return self.outputs


class _Inputs:
    """One member's per-call inputs: typed views into one device buffer
    (``dev``, the static inputs a captured graph reads) and their numpy
    twins in one host buffer (``host``, pinned on the card). ``load``
    fills the host views and moves all of them in one copy."""

    def __init__(self, fields, device: torch.device) -> None:
        layout, total = [], 0
        for name, shape, dtype in fields:
            n = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
            layout.append((name, shape, dtype, total, n))
            total += -(-n // 16) * 16
        on_card = device.type == "cuda"
        self._dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self._host = torch.zeros(total, dtype=torch.uint8, pin_memory=on_card)
        self.dev: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, np.ndarray] = {}
        for name, shape, dtype, off, n in layout:
            self.dev[name] = self._dev[off:off + n].view(dtype).view(shape)
            self.host[name] = self._host[off:off + n].view(dtype).view(shape).numpy()
        # The host buffer is refilled only after its last copy has read it.
        self._copied = torch.cuda.Event() if on_card else None

    def load(self, **values) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for name, value in values.items():
            self.host[name][...] = value
        self._dev.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


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
        # A pool-typed engine (disaggregated serving) holds only its
        # phase's programs: "prefill" the prefill ladder, "decode" the
        # decode step. It needs the paged layout (the block table is the
        # handoff unit) and no speculation (draft state does not travel).
        if pool_role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"pool_role must be one of ('both', 'prefill', 'decode'), "
                f"got {pool_role!r}"
            )
        if pool_role != "both":
            if kv_layout != "paged":
                raise ValueError(
                    f"pool_role={pool_role!r} requires kv_layout='paged' "
                    "(the block table is the handoff unit)"
                )
            if spec_k:
                raise ValueError(
                    f"pool_role={pool_role!r} is incompatible with "
                    f"spec_k={spec_k} (draft state does not travel)"
                )
        self.pool_role = pool_role
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
        # The draft's weights dequantized once, resident: the forward is
        # launch-bound on the card (about 600 small kernels a forward of
        # lm_base at 8 slots on an H100 80GB HBM3 at 700 W), so a per-tick
        # dequantize of every weight only adds launches; the values, and
        # so the proposals, are the same.
        self._draft_held_bytes = 0
        if draft is not None:
            draft.quantize_weights_("int8").cast_matmul_weights_().eval()
            self._draft_held_bytes = quant.hold_resident_(draft, draft.dtype)
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
        # The closed program set: installed programs by member name and
        # variant (ProgramSpec.variants), the members' static inputs, and
        # the capture ledger.
        self.programs: Dict[str, Dict[bool, Callable[[], Tuple[torch.Tensor, ...]]]] = {}
        self._inputs: Dict[str, _Inputs] = {}
        self._graph_pool = None
        self.compile_count = 0
        self.graphs_captured = 0
        self.compile_sec = 0.0
        self.graph_pool_bytes = 0
        self.decode_steps = 0
        self.prefill_execs = 0
        self._warmed = False
        # Merge-counter buffers this engine's graphs were captured with.
        self._counter_bufs: List[torch.Tensor] = []
        # The brownout ladder's spec_off stage: ticks take the plain
        # decode program (already in the closed set); the draft keeps
        # tracking the committed stream.
        self.spec_suspended = False
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

    @property
    def programs_expected(self) -> int:
        """The closed program set's static size: decode + one prefill
        per bucket, plus (speculative tier) the batched verify and, for
        the int8 self-draft, the draft phase + one draft prefill per
        bucket. ``compile_count`` equals this for the engine's whole
        lifetime after :meth:`warmup`. A pool-typed engine holds only
        its phase's programs: ``prefill`` one per bucket, ``decode``
        one."""
        if self.pool_role == "prefill":
            return len(self.buckets)
        if self.pool_role == "decode":
            return 1
        n = len(self.buckets) + 1
        if self.spec_enabled:
            n += 1  # the [S, spec_k + 1] verify
            if self.spec_draft == "int8":
                n += 1 + len(self.buckets)  # draft phase + draft prefills
        return n

    def program_specs(self) -> List[ProgramSpec]:
        """The closed program set as data: one :class:`ProgramSpec` per
        member, its static inputs allocated once (as the KV stores are)
        and reused by every later call. :meth:`warmup` captures exactly
        this list."""
        self._ensure_stores()
        s, k, mb = self.num_slots, self.spec_k, self.blocks_per_slot
        paged = self.allocator is not None
        i64, i32, f32 = torch.int64, torch.int32, torch.float32
        specs: List[ProgramSpec] = []

        def sampling(key_shape):
            return [("keys", key_shape + (2,), i64), ("temps", (s,), f32),
                    ("top_ks", (s,), i64), ("top_ps", (s,), f32)]

        def member(name, fields, fn, span, samples=True):
            inputs = self._inputs.get(name)
            if inputs is None:
                inputs = self._inputs[name] = _Inputs(fields, self.device)
            specs.append(ProgramSpec(name, fn, inputs.dev, span, samples))

        table = [("tables", (s, mb), i32)] if paged else []
        if self.pool_role != "prefill":
            member("decode",
                   [("tokens", (s, 1), i64), ("positions", (s,), i64)] + sampling((s,))
                   + [("eos", (s,), i64)] + table,
                   self._decode_fn, {"what": "serve_decode", "slots": s})
        if self.pool_role == "decode":
            return specs
        for bucket in self.buckets:
            first = [("tokens", (1, bucket), i64), ("last", (1,), i64),
                     ("key", (1, 2), i64), ("temp", (1,), f32), ("top_k", (1,), i64),
                     ("top_p", (1,), f32), ("eos", (1,), i64)]
            if paged:
                member(f"prefill_b{bucket}",
                       [("table", (1, mb), i32), ("start", (1,), i64)] + first,
                       self._prefill_paged_fn, {"what": f"serve_prefill_b{bucket}"})
            else:
                member(f"prefill_b{bucket}", [("slot", (1,), i64)] + first,
                       self._prefill_dense_fn, {"what": f"serve_prefill_b{bucket}"})
        if self.spec_enabled:
            member("spec_verify",
                   [("tokens", (s, k + 1), i64), ("positions", (s,), i64)]
                   + sampling((s, k + 1)) + table,
                   self._verify_fn, {"what": "serve_spec_verify", "k": k})
            if self.spec_draft == "int8":
                member("spec_draft", [("catchup", (s, 2), i64), ("start", (s,), i64)],
                       self._draft_fn, {"what": "serve_spec_draft", "k": k}, samples=False)
                for bucket in self.buckets:
                    member(f"spec_draft_prefill_b{bucket}",
                           [("slot", (1,), i64), ("tokens", (1, bucket), i64)],
                           self._draft_prefill_fn,
                           {"what": f"serve_spec_draft_prefill_b{bucket}"}, samples=False)
        return specs

    def warmup(self) -> Dict[str, float]:
        """Install the closed program set (idempotent): on a CUDA device
        capture every variant of every member not yet installed as a
        CUDA graph (:meth:`_capture`), on the CPU install its uncaptured
        functions. After this ``compile_count == programs_expected`` for
        the engine's lifetime. Emits the byte, kernel and
        ``serve.programs`` gauges and returns ``{"compile_sec",
        "programs"}``."""
        t_all = time.perf_counter()
        pending = [ps for ps in self.program_specs() if ps.name not in self.programs]
        if self.device.type == "cuda":
            if pending:
                self._capture(pending)
        else:
            for ps in pending:
                with obs.span("compile", **ps.span):
                    t0 = time.perf_counter()
                    self.programs[ps.name] = ps.uncaptured()
                    self.compile_sec += time.perf_counter() - t0
                self.compile_count += 1
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
            "serve warmup: %d programs (role %s, %d prefill buckets %s%s) in %.2fs "
            "(%s), slots=%d cache_len=%d layout=%s kernel=%s kv=%s weights=%s device=%s",
            self.compile_count, self.pool_role, len(self.buckets), list(self.buckets),
            (f" + spec k={self.spec_k} draft={self.spec_draft}"
             if self.spec_enabled else ""),
            time.perf_counter() - t_all,
            (f"{self.graphs_captured} CUDA graphs, pool "
             f"{self.graph_pool_bytes / 2**20:.1f} MiB"
             if self.device.type == "cuda" else "uncaptured"),
            self.num_slots, self.max_len, self.kv_layout, self.decode_kernel,
            self.kv_dtype, self.weight_dtype, self.device,
        )
        obs.gauge("serve.programs", float(self.compile_count))
        return {"compile_sec": self.compile_sec, "programs": float(self.compile_count)}

    def _capture(self, specs: List[ProgramSpec]) -> None:
        """Capture every variant of ``specs`` as a CUDA graph in the
        engine's one graph pool. First each variant runs
        :data:`_WARMUP_RUNS` times eagerly on the capture stream, so that
        lazy state — the kernel library, cuBLAS workspaces, and the
        decode kernel's merge counters, kept per stream and grown to the
        largest member's need — exists outside the pool before any graph
        records an address. Those runs execute for real on the zeroed
        static inputs and leave nothing a request can read: paged, every
        table is all zeros, so their K/V writes land in the trash block
        0; dense, they write rows that the slot's next prefill replaces
        whole. Each member's captures then run in one ``compile`` span,
        and each graph counts the kernel launches it recorded. A failed
        capture raises. ``graph_pool_bytes`` grows by the memory the
        captures reserved. The whole capture holds the process-wide
        capture lock and records in ``thread_local`` mode (other threads
        keep pumping their own engines); the capture stream's merge
        counters are this engine's own (:func:`_counters.isolate`)."""
        with _CAPTURE_LOCK:
            self._capture_locked(specs)

    def _capture_locked(self, specs: List[ProgramSpec]) -> None:
        from distributeddeeplearning_tpu_torch.ops import _counters, paged_decode

        dev = self.device
        uncaptured = {ps.name: ps.uncaptured() for ps in specs}
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        _counters.isolate(stream.cuda_stream)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(_WARMUP_RUNS):
                for fns in uncaptured.values():
                    for fn in fns.values():
                        fn()
        torch.cuda.synchronize(dev)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        for ps in specs:
            with obs.span("compile", **ps.span):
                t0 = time.perf_counter()
                programs = {}
                for variant, fn in uncaptured[ps.name].items():
                    n0 = dict(paged_decode.launches_by_store)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        outputs = fn()
                    programs[variant] = CapturedProgram(graph, outputs, {
                        k: n - n0[k] for k, n in paged_decode.launches_by_store.items()})
                    self.graphs_captured += 1
                self.programs[ps.name] = programs
                self.compile_sec += time.perf_counter() - t0
            self.compile_count += 1
        torch.cuda.synchronize(dev)
        self._counter_bufs += _counters.held(stream.cuda_stream)
        self.graph_pool_bytes += torch.cuda.memory_reserved(dev) - reserved

    def replayed_launches(self) -> int:
        """Decode-kernel launches made by replays of the captured
        members since capture: each graph's recorded launches times its
        replays."""
        return sum(self.replayed_launches_by_store().values())

    def replayed_launches_by_store(self) -> Dict[str, int]:
        """:meth:`replayed_launches` by the cache's storage dtype (the
        keys of ``ops.paged_decode.launches_by_store``)."""
        out: Dict[str, int] = {}
        for variants in self.programs.values():
            for p in variants.values():
                if isinstance(p, CapturedProgram):
                    for k, n in p.launches_by_store.items():
                        out[k] = out.get(k, 0) + n * p.replays
        return out

    def _run(self, name: str, greedy: bool = False, **inputs) -> Tuple[torch.Tensor, ...]:
        """Fill member ``name``'s static inputs and run its installed
        program, the greedy-only variant if ``greedy`` (no row samples).
        Read its outputs before another member runs: the captured
        members share one memory pool."""
        self._inputs[name].load(**inputs)
        return self.programs[name][greedy]()

    def _cache(self, stores, index, **kw) -> KVCache:
        k, v, ks, vs = stores
        return KVCache(k, v, index=index, kv_dtype=self.kv_dtype, k_scale=ks,
                       v_scale=vs, **kw)

    def _routed(self, index: torch.Tensor, tables: Optional[torch.Tensor]) -> KVCache:
        """The target's cache at per-row ``index`` (a ``[S]`` tensor),
        routed through ``tables`` on the paged layout."""
        if tables is None:
            return self._cache(self._stores, index, decode_kernel=self.decode_kernel)
        return self._cache(self._stores, index, block_table=tables,
                           block_size=self.block_size, decode_kernel=self.decode_kernel)

    # -- accounting --------------------------------------------------------

    def _emit_pool_gauges(self) -> None:
        a = self.allocator
        obs.gauge("serve.block_pool_total", float(a.capacity))
        obs.gauge("serve.block_pool_free", float(a.free_count))
        obs.gauge("serve.prefix_hits", float(a.stats["prefix_hit_blocks"]))

    def pool_stats(self) -> Optional[Dict[str, int]]:
        """Block-pool gauges (None on the dense layout)."""
        return None if self.allocator is None else self.allocator.snapshot()

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
        rest). Under the int8 self-draft its dense KV pool, its weights
        and their resident dequantized copy (``draft_held_bytes``) are
        itemized too."""
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
            out["draft_held_bytes"] = float(self._draft_held_bytes)
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

    # -- programs (the members' functions over their static inputs) --------

    def _dense_prefill(self, model, stores, slot: torch.Tensor,
                       tokens: torch.Tensor) -> torch.Tensor:
        """The padded prompt through ``model`` over a fresh zero ``[1,
        max_len]`` cache at scalar index 0 (the lockstep path
        ``inference.generate`` runs), whose rows then replace the rows
        of ``slot`` (a ``[1]`` device index; JAX's
        ``dynamic_update_slice``). Returns the logits."""
        fresh = kv_stores(model, (1, self.max_len), self.device, self.kv_dtype)
        logits = model(tokens, self._cache(fresh, 0))
        for pool, rows in zip(stores, fresh):
            for x, y in zip(pool or (), rows or ()):
                if x.element_size() == 1:  # int8 / fp8 codes (no fp8 index_copy_)
                    x, y = x.view(torch.uint8), y.view(torch.uint8)
                x.index_copy_(0, slot, y)
        return logits

    def _first(self, logits, last, key, temp, top_k, top_p, eos, greedy):
        """The first token, sampled from the prompt's true last position
        ``last`` (a ``[1]`` device index), packed with its eos hit; and
        that position's logits."""
        row = logits[0].index_select(0, last)
        first = sample_slots(row, key, temp, top_k, top_p, top_k_cap=self.top_k_cap,
                             greedy=greedy)
        return torch.cat([first, ((first == eos) & (eos >= 0)).long()]), row[0]

    @torch.no_grad()
    def _decode_fn(self, tokens, positions, keys, temps, top_ks, top_ps, eos, tables=None,
                   greedy=False):
        logits = self.model(tokens, self._routed(positions, tables))
        nxt = sample_slots(logits[:, -1], keys, temps, top_ks, top_ps,
                           top_k_cap=self.top_k_cap, greedy=greedy)
        return (torch.stack([nxt, ((nxt == eos) & (eos >= 0)).long()]),)

    @torch.no_grad()
    def _prefill_dense_fn(self, slot, tokens, last, key, temp, top_k, top_p, eos,
                          greedy=False):
        logits = self._dense_prefill(self.model, self._stores, slot, tokens)
        return self._first(logits, last, key, temp, top_k, top_p, eos, greedy)

    @torch.no_grad()
    def _prefill_paged_fn(self, table, start, tokens, last, key, temp, top_k, top_p, eos,
                          greedy=False):
        """The (suffix of the) prompt at absolute positions ``[start,
        start + bucket)`` through the slot's block table: K/V writes land
        in the table's blocks, attention reads any shared prefix blocks."""
        cache = self._cache(self._stores, start, block_table=table,
                            block_size=self.block_size, decode_kernel=self.decode_kernel)
        return self._first(self.model(tokens, cache), last, key, temp, top_k, top_p, eos,
                           greedy)

    @torch.no_grad()
    def _verify_fn(self, tokens, positions, keys, temps, top_ks, top_ps, tables=None,
                   greedy=False):
        """One ``[S, K+1]`` forward of the target, then the acceptance
        rule; ``committed [S, K+1]`` and ``accepted`` packed as ``[S,
        K+2]``. Rejected-tail K/V writes land past the committed cursor
        and are overwritten by the next tick's before any query attends
        them."""
        logits = self.model(tokens, self._routed(positions, tables))
        committed, accepted = spec_verify_slots(
            logits, tokens[:, 1:], keys, temps, top_ks, top_ps, top_k_cap=self.top_k_cap,
            greedy=greedy)
        return (torch.cat([committed, accepted[:, None]], dim=1),)

    @torch.no_grad()
    def _draft_fn(self, catchup, start):
        """The int8 self-draft's ``[S, spec_k]`` greedy proposals: one
        ``[S, 2]`` catch-up forward (the previous committed token and
        the next input; after an all-accepted tick the draft's cache is
        one position behind, and the pair closes the gap), then ``spec_k
        - 1`` single-token steps, all over the draft's resident
        dequantized weights."""
        logits = self._draft(catchup, self._cache(self._draft_stores, start))
        tok = torch.argmax(logits[:, -1], dim=-1)
        drafts = [tok]
        for j in range(1, self.spec_k):
            cache = self._cache(self._draft_stores, start + 1 + j)
            logits = self._draft(tok[:, None], cache)
            tok = torch.argmax(logits[:, -1], dim=-1)
            drafts.append(tok)
        return (torch.stack(drafts, dim=1),)

    @torch.no_grad()
    def _draft_prefill_fn(self, slot, tokens):
        """The whole prompt through the int8 draft into the slot's draft
        rows: the draft attends over its OWN K/V (int8-weight K/V differ
        from the target's), even when the target's prefill rode a
        prefix-cache hit."""
        self._dense_prefill(self._draft, self._draft_stores, slot, tokens)
        return ()

    # -- steps -------------------------------------------------------------

    @staticmethod
    def _padded(tokens: np.ndarray, bucket: int) -> np.ndarray:
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :tokens.shape[0]] = tokens
        return padded

    def prefill(self, slot: int, spec: ReqSpec) -> Tuple[int, bool]:
        """Admit ``spec`` into ``slot``: run the bucketed prefill, seat the
        request's sampling state, and return (first token, eos hit). The
        slot is occupied afterwards even on an immediate eos — the
        caller decides to :meth:`release`."""
        if self._active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if self.pool_role == "decode":
            raise RuntimeError(
                "a decode-pool engine has no prefill programs; requests "
                "reach it only through import_slot (handoff/migration)"
            )
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
        first_inputs = dict(
            key=ladder[0] if sampled else np.zeros(2, np.uint32),
            temp=np.float32(spec.temperature if sampled else 0.0), top_k=tk,
            top_p=np.float32(spec.top_p or 0.0),
            eos=-1 if spec.eos_token is None else int(spec.eos_token),
        )
        if self.allocator is not None:
            packed, logits = self._prefill_paged(slot, spec, prompt, first_inputs)
        else:
            bucket = self.bucket_for(t)
            packed, logits = self._run(
                f"prefill_b{bucket}", greedy=not sampled, slot=slot,
                tokens=self._padded(prompt, bucket), last=t - 1, **first_inputs)
            self.last_prefill = {
                "slot": slot, "bucket": bucket, "start": 0, "shared_blocks": 0,
            }
        # The outputs live in the graph pool: copy the logits out before
        # another member runs.
        self.last_prefill["logits"] = logits.clone()
        self._temps[slot] = first_inputs["temp"]
        self._top_ks[slot] = tk
        self._top_ps[slot] = first_inputs["top_p"]
        self._eos[slot] = first_inputs["eos"]
        first, eos_hit = (int(x) for x in packed.cpu())
        self.prefill_execs += 1
        self._active[slot] = True
        self._tokens[slot] = first
        self._positions[slot] = t
        self._ladders[slot] = ladder
        self._cursor[slot] = 1
        if self.spec_enabled:
            self._max_new[slot] = spec.max_new_tokens
            self._prev_tokens[slot] = int(prompt[-1])
            self._history[slot] = [int(x) for x in prompt] + [first]
            if self._draft is not None:
                bucket = self.bucket_for(t)
                self._run(f"spec_draft_prefill_b{bucket}", slot=slot,
                          tokens=self._padded(prompt, bucket))
        return first, bool(eos_hit)

    def _prefill_paged(self, slot, spec, prompt, first_inputs):
        """Paged admission: match the prompt's block-aligned prefix in the
        prefix cache, allocate the remaining blocks (all-or-nothing;
        :class:`BlockPoolExhausted` propagates as backpressure), and
        prefill ONLY the divergent suffix through the slot's block table.
        The match is capped at ``prompt_len - 1`` tokens so the last
        prompt position is always computed. Returns the member's
        outputs."""
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
        out = self._run(f"prefill_b{bucket}", greedy=spec.temperature <= 0.0,
                        table=table_row, start=start,
                        tokens=self._padded(prompt[start:], bucket), last=suffix_len - 1,
                        **first_inputs)
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
        return out

    def _sampling(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """The per-slot sampling inputs of a tick, with its ``keys``."""
        return dict(keys=keys, temps=self._temps, top_ks=self._top_ks,
                    top_ps=self._top_ps)

    def _all_greedy(self) -> bool:
        """No slot samples this tick (free slots hold temperature 0): the
        sampling members' greedy-only variant serves it."""
        return not (self._temps > 0).any()

    def _routing(self) -> Dict[str, np.ndarray]:
        """The per-slot positions (and the paged layout's tables)."""
        out = {"positions": self._positions}
        if self.allocator is not None:
            out["tables"] = self._tables
        return out

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
        (packed,) = self._run("decode", greedy=self._all_greedy(),
                              tokens=self._tokens[:, None], eos=self._eos,
                              **self._routing(), **self._sampling(step_keys))
        nxt, eos_hit = packed.cpu().numpy()
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
            out.append((i, tok, bool(eos_hit[i])))
        return out

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
            (drafts,) = self._run(
                "spec_draft", catchup=np.stack([self._prev_tokens, self._tokens], axis=1),
                start=np.maximum(self._positions - 1, 0))
            drafts = drafts.cpu().numpy()
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
        (packed,) = self._run("spec_verify", greedy=self._all_greedy(), tokens=tokens,
                              **self._routing(),
                              **self._sampling(step_keys))
        packed = packed.cpu().numpy()
        committed, accepted = packed[:, :k + 1], packed[:, k + 1]
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

    # -- slot state transfer (disaggregation, migration) -------------------

    def store_names(self) -> List[str]:
        """The target's K/V stores by name, in :meth:`_named_stores`
        order: ``block{i}.k``, ``block{i}.v`` and, quantized,
        ``block{i}.k_scale`` / ``block{i}.v_scale`` per layer."""
        return list(self._named_stores())

    def _named_stores(self) -> Dict[str, torch.Tensor]:
        self._ensure_stores()
        out: Dict[str, torch.Tensor] = {}
        for part, stores in zip(("k", "v", "k_scale", "v_scale"), self._stores):
            for i, t in enumerate(stores or ()):
                out[f"block{i}.{part}"] = t
        return out

    def export_blocks(self, block_ids) -> Dict[str, torch.Tensor]:
        """Host-stage the KV content of ``block_ids``: store name ->
        ``[len(block_ids), block_size, H, .]`` CPU rows gathered from
        every store. A pure read (no program runs). The caller holds the
        blocks resident (referenced or pinned); the pump that wrote them
        has read its outputs back, so its writes are complete."""
        if self.allocator is None:
            raise RuntimeError("export_blocks requires kv_layout='paged'")
        idx = torch.as_tensor(list(block_ids), dtype=torch.long).to(self.device)
        return {name: store.index_select(0, idx).cpu()
                for name, store in self._named_stores().items()}

    def _import_block_payload(self, block_ids, payload) -> None:
        """Write host-staged block content into ``block_ids`` of the
        local stores IN PLACE (an indexed copy: the captured graphs read
        these tensors' addresses), on the caller's stream, which is
        synchronized before returning, so the pump's next replay reads
        the new content. No program runs; nothing is captured."""
        idx = torch.as_tensor(list(block_ids), dtype=torch.long).to(self.device)
        for name, store in self._named_stores().items():
            if name not in payload:
                continue
            rows = torch.as_tensor(payload[name]).to(self.device, store.dtype)
            if store.element_size() == 1:  # int8 / fp8 codes (no fp8 index_copy_)
                store, rows = store.view(torch.uint8), rows.view(torch.uint8)
            store.index_copy_(0, idx, rows)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def export_slot(self, slot: int) -> Dict[str, Any]:
        """Everything slot ``slot`` needs to continue decoding bit for
        bit on ANOTHER engine: the sampling state, the key-ladder cursor
        and the host-staged content of every written KV block. The slot
        is untouched: the caller releases it (handoff) or keeps it."""
        if self.allocator is None:
            raise RuntimeError("export_slot requires kv_layout='paged'")
        if self.spec_enabled:
            raise RuntimeError(
                "export_slot is incompatible with spec_k > 0 (the draft "
                "pool's lookahead state does not travel)"
            )
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        written = int(self._positions[slot])
        blocks = list(self._slot_blocks[slot])
        nwritten = self.allocator.blocks_for_tokens(written)
        ladder = self._ladders[slot]
        return {
            "block_size": self.block_size,
            "n_blocks": len(blocks),
            "blocks": blocks,
            "written": written,
            "token": int(self._tokens[slot]),
            "temp": float(self._temps[slot]),
            "top_k": int(self._top_ks[slot]),
            "top_p": float(self._top_ps[slot]),
            "eos": int(self._eos[slot]),
            "ladder": None if ladder is None else np.array(ladder),
            "cursor": int(self._cursor[slot]),
            "payload": self.export_blocks(blocks[:nwritten]),
        }

    def can_import(self, state: Dict[str, Any]) -> bool:
        """Room for an imported slot now: a free slot and the state's
        block count allocatable."""
        if self.allocator is None:
            return False
        return bool(self.free_slots) and self.allocator.free_count >= int(state["n_blocks"])

    def import_slot(self, slot: int, state: Dict[str, Any],
                    prompt: Optional[np.ndarray] = None) -> None:
        """Seat an exported slot state (:meth:`export_slot`, or a
        directory adoption's): allocate fresh blocks, write the staged
        KV content in place and restore the sampling state, so the next
        :meth:`decode_step` continues the stream bit for bit. ``prompt``
        (with the prefix cache on) registers the full prompt blocks here
        so later requests prefix-hit."""
        if self.allocator is None:
            raise RuntimeError("import_slot requires kv_layout='paged'")
        if self.spec_enabled:
            raise RuntimeError("import_slot is incompatible with spec_k > 0")
        if self._active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        if int(state["block_size"]) != self.block_size:
            raise ValueError(
                f"block_size mismatch: exported {state['block_size']}, "
                f"local {self.block_size}"
            )
        if not self._warmed:
            self.warmup()
        n = int(state["n_blocks"])
        blocks = self.allocator.alloc(n)  # BlockPoolExhausted -> caller
        nwritten = self.allocator.blocks_for_tokens(int(state["written"]))
        self._import_block_payload(blocks[:nwritten], state["payload"])
        self._tables[slot] = 0
        self._tables[slot, :n] = blocks
        self._slot_blocks[slot] = blocks
        self._active[slot] = True
        self._tokens[slot] = int(state["token"])
        self._positions[slot] = int(state["written"])
        self._temps[slot] = np.float32(state["temp"])
        self._top_ks[slot] = int(state["top_k"])
        self._top_ps[slot] = np.float32(state["top_p"])
        self._eos[slot] = int(state["eos"])
        ladder = state.get("ladder")
        self._ladders[slot] = None if ladder is None else np.array(ladder)
        self._cursor[slot] = int(state["cursor"])
        if prompt is not None and self.prefix_cache:
            self.allocator.register_prefix(np.asarray(prompt, np.int32).reshape(-1), blocks)
        self._emit_pool_gauges()

    def adopt_prefix_blocks(self, tokens, payload) -> int:
        """Seed the local prefix cache with directory-fetched full-block
        content (a chain prefetch): allocate, write in place, register,
        then decref into the evictable cache, so the next prefill of a
        prompt starting with those blocks computes only its suffix.
        Returns the blocks seeded (0 when already cached or no room)."""
        if self.allocator is None or not self.prefix_cache:
            return 0
        a = self.allocator
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = min(len(next(iter(payload.values()))) if payload else 0,
                len(toks) // self.block_size)
        if n < 1 or a.peek_prefix(toks, n * self.block_size) >= n or a.free_count < n:
            return 0
        blocks = a.alloc(n)
        self._import_block_payload(blocks, {p: arr[:n] for p, arr in payload.items()})
        a.register_prefix(toks[: n * self.block_size], blocks)
        for bid in blocks:
            a.decref(bid)
        self._emit_pool_gauges()
        return n

    def close(self) -> None:
        """Release the device state: the installed programs, their graphs
        and pool, the members' inputs, the KV stores and the model. The
        engine is unusable afterwards (a fleet replica that restarts
        builds a new one). Takes the capture lock: a graph pool must not
        be freed while another engine captures."""
        with _CAPTURE_LOCK:
            self.programs.clear()
            self._inputs.clear()
            self._counter_bufs = []
            self._graph_pool = None
            self._stores = self._draft_stores = None
            self.model = self._draft = None
            self._warmed = False
