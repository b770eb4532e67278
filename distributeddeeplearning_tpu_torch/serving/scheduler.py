"""Request scheduler over the slot engine (port of
``serving/scheduler.py``): a bounded FIFO admission queue with
backpressure, iteration-level scheduling (admit into free slots between
decode steps, at most ``prefills_per_step`` prefills per tick; a
speculative engine's tick commits 1 .. ``spec_k + 1`` tokens per slot),
per-request deadlines and cancellation, and graceful drain. Instrumented
through the port's obs bus with the JAX package's event names:

spans   ``serve.prefill`` (bucket, slot, prompt_len), ``serve.decode_step``
        (active), ``serve.decode_share``, ``serve.delivery``,
        ``serve.queue_wait`` / ``serve.ttft`` / ``serve.request``
gauges  ``serve.slot_occupancy``, ``serve.queue_depth``, ``serve.programs``
counters ``serve.admitted``, ``serve.completed``, ``serve.tokens``,
        ``serve.rejected``, ``serve.evicted_deadline``, ``serve.cancelled``
points  ``serve.request_done`` (req, reason, ttft_ms, tokens)

**Adaptive admission** (the telemetry feedback path): a pluggable
:class:`AdmissionPolicy` runs at the top of every tick;
:class:`AdaptiveAdmissionPolicy` reads the live plane's atomically
published ``rollup.json`` (``obs/rollup.py``) and, while a *latency* SLO
burns (``obs/slo.py``), derates admission — caps ``prefills_per_step``
and tightens the ``QueueFull`` threshold — and restores both on
``slo_recover``. Derate and restore are visible in the event stream
(``serve.admission_derate`` / ``serve.admission_restore`` points,
``serve.admission_prefills`` / ``serve.admission_queue_limit`` gauges).

``ServeConfig.from_env`` reads the same ``SERVE_*`` variables with the
same defaults: the quantized (``SERVE_KV_DTYPE``, ``SERVE_WEIGHT_DTYPE``)
and speculative (``SERVE_SPEC_K``, ``SERVE_SPEC_DRAFT``,
``SERVE_SPEC_NGRAM_N``) tiers, ``SERVE_ADMISSION_POLICY`` (``static`` |
``adaptive``) and ``SERVE_ROLLUP_PATH`` (default
``$OBS_DIR/rollup.json``). Not ported yet: the brownout ladder
(``spec_off`` and the rest), prefill handoff, push callbacks and the
fleet hooks, which ``Server`` takes no argument for.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.ops import quant
from distributeddeeplearning_tpu_torch.serving.engine import ReqSpec, SlotEngine


class QueueFull(RuntimeError):
    """Backpressure: the bounded admission queue is at capacity."""


# ---------------------------------------------------------------------------
# Admission policies (telemetry feedback)
# ---------------------------------------------------------------------------

def burning_latency_objectives(
    snapshot: Optional[dict], watch_prefix: Optional[str] = None
) -> List[str]:
    """The *latency* objectives currently burning in a rollup snapshot
    — a latency objective is one whose stat is a span quantile
    (p50/p95/p99); rate/gauge objectives describe throughput or health
    and shedding load would not help them (what
    :class:`AdaptiveAdmissionPolicy` derates on)."""
    if not snapshot:
        return []
    out = []
    for st in snapshot.get("slo") or []:
        if not st.get("burning"):
            continue
        if st.get("stat") not in ("p50", "p95", "p99"):
            continue
        if watch_prefix and not str(st.get("metric", "")).startswith(
            watch_prefix
        ):
            continue
        out.append(st.get("objective", "?"))
    return out


class AdmissionPolicy:
    """Hook run at the top of every scheduler tick.

    A policy may adjust ``server.prefills_per_step`` (admissions per
    tick) and ``server.queue_limit`` (the effective ``QueueFull``
    threshold, never above ``server.queue_depth``). The default is
    static: no adjustment ever — exactly the pre-policy scheduler."""

    def tick(self, server: "Server", now: float) -> None:  # noqa: ARG002
        return None


class AdaptiveAdmissionPolicy(AdmissionPolicy):
    """Derate admission while a latency SLO burns; restore on recovery.

    Reads the live plane's ``rollup.json`` snapshot (atomic replace —
    a read sees one consistent view or none) at most every
    ``refresh_s``; no plane running / no snapshot = no signal = static
    behavior. A *latency* objective is one whose stat is a span
    quantile (p50/p95/p99) — rate/gauge objectives describe throughput
    or health, and shedding load would not help them.

    While burning: ``prefills_per_step`` is capped at
    ``derate_prefills`` (running streams keep decoding; the pool just
    stops swallowing new prefill work) and the queue threshold drops to
    ``derate_queue_frac`` of ``queue_depth`` (arrivals shed as
    ``QueueFull`` instead of aging into deadline evictions). Both
    restore when no watched objective burns.
    """

    def __init__(
        self,
        snapshot_path: Optional[str] = None,
        *,
        reader=None,
        refresh_s: float = 0.25,
        derate_prefills: int = 1,
        derate_queue_frac: float = 0.5,
        watch_prefix: Optional[str] = None,
    ) -> None:
        if snapshot_path is None:
            snapshot_path = os.path.join(
                os.environ.get("OBS_DIR", "."), "rollup.json"
            )
        self.snapshot_path = snapshot_path
        self._reader = reader
        self.refresh_s = max(float(refresh_s), 0.0)
        self.derate_prefills = max(int(derate_prefills), 1)
        self.derate_queue_frac = min(max(float(derate_queue_frac), 0.0), 1.0)
        self.watch_prefix = watch_prefix
        self.derated = False
        self._saved: Optional[Tuple[int, int]] = None
        self._next_read = 0.0
        self._last: Optional[dict] = None

    def _read(self) -> Optional[dict]:
        if self._reader is not None:
            return self._reader()
        from distributeddeeplearning_tpu_torch.obs.rollup import read_snapshot

        return read_snapshot(self.snapshot_path)

    def burning_latency(self, snapshot: Optional[dict]) -> List[str]:
        """The burning latency objectives this policy acts on."""
        return burning_latency_objectives(snapshot, self.watch_prefix)

    def tick(self, server: "Server", now: float) -> None:
        if now < self._next_read:
            return
        self._next_read = now + self.refresh_s
        snap = self._read()
        if snap is None:
            return  # no plane publishing: keep whatever state we hold
        self._last = snap
        burning = self.burning_latency(snap)
        if burning and not self.derated:
            self._saved = (server.prefills_per_step, server.queue_limit)
            server.prefills_per_step = min(
                server.prefills_per_step, self.derate_prefills
            )
            server.queue_limit = max(
                1, int(server.queue_depth * self.derate_queue_frac)
            )
            self.derated = True
            obs.point(
                "serve.admission_derate",
                objectives=";".join(burning),
                prefills_per_step=server.prefills_per_step,
                queue_limit=server.queue_limit,
            )
            self._emit_gauges(server)
        elif not burning and self.derated:
            if self._saved is not None:
                server.prefills_per_step, server.queue_limit = self._saved
            self._saved = None
            self.derated = False
            obs.point(
                "serve.admission_restore",
                prefills_per_step=server.prefills_per_step,
                queue_limit=server.queue_limit,
            )
            self._emit_gauges(server)

    @staticmethod
    def _emit_gauges(server: "Server") -> None:
        obs.gauge(
            "serve.admission_prefills", float(server.prefills_per_step)
        )
        obs.gauge("serve.admission_queue_limit", float(server.queue_limit))


@dataclasses.dataclass
class ServeConfig:
    """Engine + scheduler knobs, env-overridable (SERVE_*)."""

    num_slots: int = 8
    buckets: Optional[Tuple[int, ...]] = None
    queue_depth: int = 64
    deadline_ms: Optional[float] = None
    prefills_per_step: int = 1
    top_k_cap: int = 128
    kv_layout: str = "dense"
    block_size: int = 16
    # 0 = auto: dense-equivalent bytes (num_slots * ceil(max_len /
    # block_size) + the trash block).
    num_blocks: int = 0
    prefix_cache: bool = True
    # "bf16" = the compute dtype; "int8"/"fp8" = codes plus f32 scales
    # (ops/quant.py), for the KV pool and the inference weights.
    kv_dtype: str = "bf16"
    weight_dtype: str = "bf16"
    # "xla" = the plain masked path; "fused" = the hand-written decode
    # kernel (ops/paged_decode.py).
    decode_kernel: str = "xla"
    # spec_k > 0: draft-K-then-verify ticks; spec_draft "int8" (the
    # quantized self-draft) or "ngram" (prompt lookup, spec_ngram_n).
    spec_k: int = 0
    spec_draft: str = "int8"
    spec_ngram_n: int = 3
    # "static" = fixed admission; "adaptive" = derate while a latency
    # SLO burns, reading the live plane's rollup snapshot (rollup_path;
    # None = $OBS_DIR/rollup.json).
    admission_policy: str = "static"
    rollup_path: Optional[str] = None

    @classmethod
    def from_env(cls, env=None) -> "ServeConfig":
        e = os.environ if env is None else env
        buckets = None
        if e.get("SERVE_BUCKETS"):
            buckets = tuple(
                int(b) for b in str(e["SERVE_BUCKETS"]).split(",") if b.strip()
            )
        deadline = e.get("SERVE_DEADLINE_MS")
        return cls(
            num_slots=int(e.get("SERVE_SLOTS", cls.num_slots)),
            buckets=buckets,
            queue_depth=int(e.get("SERVE_QUEUE_DEPTH", cls.queue_depth)),
            deadline_ms=float(deadline) if deadline else None,
            prefills_per_step=int(
                e.get("SERVE_PREFILLS_PER_STEP", cls.prefills_per_step)
            ),
            top_k_cap=int(e.get("SERVE_TOP_K_CAP", cls.top_k_cap)),
            kv_layout=str(e.get("SERVE_KV_LAYOUT", cls.kv_layout)),
            block_size=int(e.get("SERVE_BLOCK_SIZE", cls.block_size)),
            num_blocks=int(e.get("SERVE_NUM_BLOCKS", cls.num_blocks)),
            prefix_cache=str(
                e.get("SERVE_PREFIX_CACHE", "1" if cls.prefix_cache else "0")
            ) not in ("0", "false", "off"),
            kv_dtype=str(e.get("SERVE_KV_DTYPE", cls.kv_dtype)),
            weight_dtype=str(e.get("SERVE_WEIGHT_DTYPE", cls.weight_dtype)),
            decode_kernel=str(e.get("SERVE_DECODE_KERNEL", cls.decode_kernel)),
            spec_k=int(e.get("SERVE_SPEC_K", cls.spec_k)),
            spec_draft=str(e.get("SERVE_SPEC_DRAFT", cls.spec_draft)),
            spec_ngram_n=int(e.get("SERVE_SPEC_NGRAM_N", cls.spec_ngram_n)),
            admission_policy=str(
                e.get("SERVE_ADMISSION_POLICY", cls.admission_policy)
            ),
            rollup_path=e.get("SERVE_ROLLUP_PATH") or None,
        )

    def build_admission_policy(self) -> Optional[AdmissionPolicy]:
        """The policy instance this config asks for (None = static)."""
        if self.admission_policy in ("", "static", "off", "none"):
            return None
        if self.admission_policy == "adaptive":
            return AdaptiveAdmissionPolicy(self.rollup_path)
        raise ValueError(
            f"unknown SERVE_ADMISSION_POLICY {self.admission_policy!r} "
            f"(have: static, adaptive)"
        )

    def engine_kwargs(self) -> dict:
        # Reject unknown dtypes/kernels here, naming the supported list,
        # before an engine is built.
        quant.validate_store_dtype("kv_dtype", self.kv_dtype)
        quant.validate_store_dtype("weight_dtype", self.weight_dtype)
        if self.decode_kernel not in ("xla", "fused"):
            raise ValueError(
                f"decode_kernel must be one of ('xla', 'fused'), got "
                f"{self.decode_kernel!r} (SERVE_DECODE_KERNEL)"
            )
        kw = dict(
            num_slots=self.num_slots, buckets=self.buckets,
            top_k_cap=self.top_k_cap, kv_layout=self.kv_layout,
            kv_dtype=self.kv_dtype, weight_dtype=self.weight_dtype,
            decode_kernel=self.decode_kernel,
        )
        if self.kv_layout == "paged":
            kw.update(
                block_size=self.block_size,
                num_blocks=self.num_blocks or None,
                prefix_cache=self.prefix_cache,
            )
        if self.spec_k:
            kw.update(
                spec_k=self.spec_k, spec_draft=self.spec_draft,
                spec_ngram_n=self.spec_ngram_n,
            )
        return kw


@dataclasses.dataclass
class Request:
    """What a client submits. ``rng``: raw key data, an int seed, or None
    (seed 0)."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    rng: Any = None
    deadline_ms: Optional[float] = None

    def spec(self) -> ReqSpec:
        return ReqSpec(
            prompt=np.asarray(self.prompt, np.int32).reshape(-1),
            max_new_tokens=int(self.max_new_tokens),
            temperature=float(self.temperature),
            top_k=self.top_k,
            top_p=self.top_p,
            eos_token=self.eos_token,
            rng=self.rng,
        )


class RequestHandle:
    """Client-side view of one submitted request.

    ``status``: queued → running → one of done / deadline / cancelled.
    ``result()`` blocks until finished and returns prompt + generated
    tokens; :meth:`stream` yields tokens as the serving loop commits
    them."""

    def __init__(self, req: Request, req_id: int, now: float) -> None:
        self.request = req
        self.id = req_id
        self.status = "queued"
        self.finish_reason: Optional[str] = None
        self.new_tokens: List[int] = []
        self.submitted_t = now
        self.queue_wait_s: Optional[float] = None
        self.ttft_s: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.trace = obs.new_trace_id()
        self.deliver_s = 0.0
        self.done = threading.Event()
        self._cond = threading.Condition()
        self._cancel = False
        self._deadline_t = (
            now + req.deadline_ms / 1e3 if req.deadline_ms is not None else None
        )

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.request.prompt, np.int32).reshape(-1),
            np.asarray(self.new_tokens, np.int32),
        ])

    def cancel(self) -> None:
        self._cancel = True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still {self.status}")
        return self.tokens

    def stream(self, timeout: Optional[float] = None):
        """Incremental token iterator: yields each generated token the
        moment the serving loop commits it, ending when the request
        finishes. ``timeout`` bounds the wait for EACH next token;
        requires a second thread pumping the server."""
        i = 0
        while True:
            with self._cond:
                while i >= len(self.new_tokens) and not self.done.is_set():
                    if not self._cond.wait(timeout):
                        raise TimeoutError(
                            f"request {self.id}: no token within {timeout}s"
                        )
                fresh = self.new_tokens[i:]
            for tok in fresh:
                yield int(tok)
            i += len(fresh)
            if self.done.is_set() and i >= len(self.new_tokens):
                return

    def _deliver(self, toks: List[int]) -> None:
        """Serving-loop side: commit tokens, wake stream iterators."""
        t0 = time.monotonic()
        with self._cond:
            self.new_tokens.extend(int(t) for t in toks)
            self._cond.notify_all()
        self.deliver_s += time.monotonic() - t0

    def _notify_done(self) -> None:
        with self._cond:
            self.done.set()
            self._cond.notify_all()

    def expired(self, now: float) -> bool:
        return self._deadline_t is not None and now > self._deadline_t


class Server:
    """Continuous-batching serving loop over a :class:`SlotEngine`.

    Single-pumper model: exactly one thread drives :meth:`step` (or
    :meth:`drain` / :meth:`serve_forever`); ``submit``/``cancel`` are
    safe from any thread. Each tick: reap deadlines/cancels → admit up
    to ``prefills_per_step`` queued requests into free slots → one
    batched decode step (a speculative tick on a ``spec_k > 0`` engine)
    → deliver tokens and evict finished slots.
    """

    def __init__(
        self,
        engine: SlotEngine,
        *,
        queue_depth: int = 64,
        prefills_per_step: int = 1,
        default_deadline_ms: Optional[float] = None,
        admission_policy: Optional[AdmissionPolicy] = None,
    ) -> None:
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if prefills_per_step < 1:
            raise ValueError(
                f"prefills_per_step must be >= 1, got {prefills_per_step}"
            )
        self.engine = engine
        self.queue_depth = queue_depth
        # The policy-adjustable knobs: queue_limit is the effective
        # QueueFull threshold (<= queue_depth, the configured ceiling).
        self.queue_limit = queue_depth
        self.prefills_per_step = prefills_per_step
        self.default_deadline_ms = default_deadline_ms
        self.policy = admission_policy
        self._lock = threading.Lock()
        self._queue: Deque[RequestHandle] = collections.deque()
        self._ids = itertools.count()
        self._by_slot: Dict[int, RequestHandle] = {}
        self._closed = False
        self._tick_trace = obs.new_trace_id()
        self.stats: Dict[str, Any] = {
            "admitted": 0, "completed": 0, "rejected": 0, "cancelled": 0,
            "deadline": 0, "tokens": 0, "decode_steps": 0,
            "occupancy_sum": 0.0, "occupancy_samples": 0, "peak_active": 0,
        }

    @classmethod
    def build(cls, model, params=None, config: Optional[ServeConfig] = None,
              **engine_kw) -> "Server":
        """Engine + server from one :class:`ServeConfig` (env-driven by
        default). ``engine_kw`` reaches :class:`SlotEngine` (``device``,
        ``max_len``, ...)."""
        cfg = config or ServeConfig.from_env()
        policy = cfg.build_admission_policy()
        engine = SlotEngine(model, params, **cfg.engine_kwargs(), **engine_kw)
        return cls(
            engine,
            queue_depth=cfg.queue_depth,
            prefills_per_step=cfg.prefills_per_step,
            default_deadline_ms=cfg.deadline_ms,
            admission_policy=policy,
        )

    # -- client side -------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Enqueue one request (validated eagerly so a malformed request
        fails the caller, not the serving loop). Raises
        :class:`QueueFull` when the bounded queue is at capacity."""
        if self._closed:
            raise RuntimeError("server is closed")
        if request.deadline_ms is None and self.default_deadline_ms:
            request = dataclasses.replace(
                request, deadline_ms=self.default_deadline_ms
            )
        self.engine.validate_spec(request.spec())
        now = time.monotonic()
        with self._lock:
            # queue_limit, not queue_depth: an admission policy may have
            # tightened the effective threshold while an SLO burns.
            if len(self._queue) >= self.queue_limit:
                self.stats["rejected"] += 1
                obs.counter("serve.rejected")
                raise QueueFull(f"admission queue at capacity ({self.queue_limit})")
            handle = RequestHandle(request, next(self._ids), now)
            self._queue.append(handle)
            with obs.trace_ctx(handle.trace):
                obs.gauge("serve.queue_depth", float(len(self._queue)))
        obs.trace_open(handle.trace, req=handle.id)
        return handle

    # -- serving loop ------------------------------------------------------

    def _finish(self, handle: RequestHandle, reason: str) -> None:
        now = time.monotonic()
        handle.status = "done" if reason in ("eos", "length") else reason
        handle.finish_reason = reason
        handle.finished_t = now
        with obs.trace_ctx(handle.trace):
            if reason in ("eos", "length"):
                self.stats["completed"] += 1
                obs.counter("serve.completed")
            if handle.deliver_s:
                obs.span_event(
                    "serve.delivery", handle.deliver_s, req=handle.id,
                    tokens=len(handle.new_tokens),
                )
            obs.span_event(
                "serve.request", now - handle.submitted_t,
                t=handle.submitted_t, req=handle.id, reason=reason,
                tokens=len(handle.new_tokens),
            )
            obs.point(
                "serve.request_done", req=handle.id, reason=reason,
                tokens=len(handle.new_tokens),
                ttft_ms=None if handle.ttft_s is None else round(
                    handle.ttft_s * 1e3, 3
                ),
            )
        obs.trace_close(handle.trace)
        handle._notify_done()

    def _reap(self, now: float) -> None:
        """Deadline/cancel sweep over the queue and the active slots."""
        with self._lock:
            keep: Deque[RequestHandle] = collections.deque()
            for h in self._queue:
                if h._cancel:
                    self.stats["cancelled"] += 1
                    with obs.trace_ctx(h.trace):
                        obs.counter("serve.cancelled")
                    self._finish(h, "cancelled")
                elif h.expired(now):
                    self.stats["deadline"] += 1
                    with obs.trace_ctx(h.trace):
                        obs.counter("serve.evicted_deadline")
                    self._finish(h, "deadline")
                else:
                    keep.append(h)
            self._queue = keep
        for slot, h in list(self._by_slot.items()):
            if h._cancel or h.expired(now):
                reason = "cancelled" if h._cancel else "deadline"
                self.stats["cancelled" if h._cancel else "deadline"] += 1
                with obs.trace_ctx(h.trace):
                    obs.counter(
                        "serve.cancelled" if h._cancel else "serve.evicted_deadline"
                    )
                self.engine.release(slot)
                del self._by_slot[slot]
                self._finish(h, reason)

    def _admit(self, now: float) -> None:
        admitted = 0
        while admitted < self.prefills_per_step:
            free = self.engine.free_slots
            if not free:
                return
            with self._lock:
                if not self._queue:
                    return
                handle = self._queue.popleft()
            # Block-pool gate (paged): FIFO order is preserved — a head
            # request that doesn't fit waits at the front.
            if not self.engine.can_admit(handle.request.spec()):
                with self._lock:
                    self._queue.appendleft(handle)
                return
            with self._lock:
                obs.gauge("serve.queue_depth", float(len(self._queue)))
            slot = free[0]
            handle.queue_wait_s = now - handle.submitted_t
            spec = handle.request.spec()
            with obs.trace_ctx(handle.trace):
                obs.span_event(
                    "serve.queue_wait", handle.queue_wait_s,
                    t=handle.submitted_t, req=handle.id,
                )
                with obs.span(
                    "serve.prefill",
                    bucket=self.engine.bucket_for(spec.prompt.shape[0]),
                    slot=slot, prompt_len=int(spec.prompt.shape[0]),
                ):
                    first, eos_hit = self.engine.prefill(slot, spec)
                handle.status = "running"
                handle.ttft_s = time.monotonic() - handle.submitted_t
                obs.span_event("serve.ttft", handle.ttft_s,
                               t=handle.submitted_t, req=handle.id)
                handle._deliver([first])
                self.stats["admitted"] += 1
                self.stats["tokens"] += 1
                obs.counter("serve.admitted")
                obs.counter("serve.tokens")
            admitted += 1
            if eos_hit or len(handle.new_tokens) >= spec.max_new_tokens:
                self.engine.release(slot)
                self._finish(handle, "eos" if eos_hit else "length")
            else:
                self._by_slot[slot] = handle

    def step(self) -> bool:
        """One scheduler tick. Returns True while work remains (active
        slots or queued requests)."""
        now = time.monotonic()
        if self.policy is not None:
            self.policy.tick(self, now)
        self._reap(now)
        self._admit(now)
        self.stats["peak_active"] = max(self.stats["peak_active"], len(self._by_slot))
        if self._by_slot:
            active = len(self._by_slot)
            tick_t0 = time.monotonic()
            with obs.trace_ctx(self._tick_trace):
                with obs.span("serve.decode_step", active=active):
                    # A speculative tick commits 1 .. spec_k + 1 tokens
                    # per slot; the plain step is its one-token case.
                    if self.engine.spec_enabled:
                        emitted = self.engine.spec_step()
                    else:
                        emitted = [(slot, [token], eos_hit) for slot, token, eos_hit
                                   in self.engine.decode_step()]
            share_s = (time.monotonic() - tick_t0) / active
            self.stats["decode_steps"] += 1
            n_tokens = 0
            for slot, toks, eos_hit in emitted:
                h = self._by_slot.get(slot)
                if h is None:
                    continue
                with obs.trace_ctx(h.trace):
                    obs.span_event(
                        "serve.decode_share", share_s, t=tick_t0,
                        req=h.id, slot=slot, active=active,
                    )
                    h._deliver(toks)
                    self.stats["tokens"] += len(toks)
                    n_tokens += len(toks)
                    if eos_hit or len(h.new_tokens) >= h.request.max_new_tokens:
                        self.engine.release(slot)
                        del self._by_slot[slot]
                        self._finish(h, "eos" if eos_hit else "length")
            obs.counter("serve.tokens", n_tokens)
        with self._lock:
            busy = bool(self._by_slot or self._queue)
        if busy:
            occ = self.engine.occupancy
            self.stats["occupancy_sum"] += occ
            self.stats["occupancy_samples"] += 1
            obs.gauge("serve.slot_occupancy", occ)
        return busy

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: pump until every queued + active request has
        finished."""
        t0 = time.monotonic()
        while self.step():
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("drain timed out with work remaining")

    def close(self) -> None:
        """Stop accepting, drain what was already admitted or queued."""
        self._closed = True
        self.drain()

    @property
    def queued_count(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self) -> int:
        return len(self._by_slot)

    @property
    def occupancy_mean(self) -> float:
        n = self.stats["occupancy_samples"]
        return self.stats["occupancy_sum"] / n if n else 0.0
