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

Every per-request emit runs under the request's trace context, so each
event carries its ``trace`` id across router, replica and tick.

**Adaptive admission** (the telemetry feedback path): a pluggable
:class:`AdmissionPolicy` runs at the top of every tick;
:class:`AdaptiveAdmissionPolicy` reads the live plane's atomically
published ``rollup.json`` (``obs/rollup.py``) and, while a *latency* SLO
burns (``obs/slo.py``), derates admission — caps ``prefills_per_step``
and tightens the ``QueueFull`` threshold — and restores both on
``slo_recover``. Derate and restore are visible in the event stream
(``serve.admission_derate`` / ``serve.admission_restore`` points,
``serve.admission_prefills`` / ``serve.admission_queue_limit`` gauges).
When the burn persists, the fleet's :class:`BrownoutLadder` steps
through declared degradation stages (``spec_off``, ``max_new:N``,
``shed:K``; ``SERVE_BROWNOUT_STAGES``) and walks back on recovery.

The fleet hooks: ``Server(handoff=True)`` exports each slot after its
first token (a disaggregated prefill pool), ``reclaim_queued``,
``take_running``, ``take_handoffs``, ``export_running`` and
``import_running`` move requests between replicas, ``serve_forever``
pumps a background thread, and :func:`generate_with_engine` serves
``inference.generate``'s signature through a server, an engine or a
fleet router.

``ServeConfig.from_env`` reads the same ``SERVE_*`` variables with the
same defaults: the quantized (``SERVE_KV_DTYPE``, ``SERVE_WEIGHT_DTYPE``)
and speculative (``SERVE_SPEC_K``, ``SERVE_SPEC_DRAFT``,
``SERVE_SPEC_NGRAM_N``) tiers, ``SERVE_ADMISSION_POLICY`` (``static`` |
``adaptive``) and ``SERVE_ROLLUP_PATH`` (default
``$OBS_DIR/rollup.json``).
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
# Admission policies (telemetry feedback — docs/SERVING.md)
# ---------------------------------------------------------------------------

def burning_latency_objectives(
    snapshot: Optional[dict], watch_prefix: Optional[str] = None
) -> List[str]:
    """The *latency* objectives currently burning in a rollup snapshot
    — a latency objective is one whose stat is a span quantile
    (p50/p95/p99); rate/gauge objectives describe throughput or health
    and shedding load would not help them. Shared by
    :class:`AdaptiveAdmissionPolicy` (derate) and
    :class:`BrownoutLadder` (the degradation ladder that engages when
    derating alone does not recover)."""
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


# ---------------------------------------------------------------------------
# Brownout degradation ladder (docs/ROBUSTNESS.md serving failure model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BrownoutStage:
    """One declared degradation stage: ``spec_off`` (suspend the
    speculative tier — the plain decode program is already captured),
    ``max_new`` (cap newly dispatched requests at ``value`` tokens), or
    ``shed`` (shed the ``value`` lowest-weight tenant lanes with the
    distinct ``brownout`` outcome)."""

    kind: str
    value: int = 0


def parse_brownout_stages(text: str) -> List[BrownoutStage]:
    """``SERVE_BROWNOUT_STAGES`` grammar: comma-separated stages, e.g.
    ``"spec_off,max_new:8,shed:1"`` — the order IS the ladder (stage k
    applies at brownout level k+1; recovery reverts in reverse)."""
    stages: List[BrownoutStage] = []
    for part in str(text or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, val = part.partition(":")
        kind = kind.strip()
        if kind == "spec_off":
            if val.strip():
                raise ValueError(
                    f"brownout stage {part!r}: spec_off takes no value"
                )
            stages.append(BrownoutStage("spec_off"))
        elif kind in ("max_new", "shed"):
            try:
                v = int(val)
            except ValueError:
                raise ValueError(
                    f"brownout stage {part!r}: {kind} needs an int value "
                    f"({kind}:N)"
                )
            if v < 1:
                raise ValueError(
                    f"brownout stage {part!r}: value must be >= 1"
                )
            stages.append(BrownoutStage(kind, v))
        else:
            raise ValueError(
                f"unknown brownout stage {kind!r} in {part!r} "
                f"(have: spec_off, max_new:N, shed:K)"
            )
    if not stages:
        raise ValueError("SERVE_BROWNOUT_STAGES declared no stages")
    return stages


class BrownoutLadder:
    """Step through declared degradation stages under sustained SLO
    burn; walk back up on recovery.

    :class:`AdaptiveAdmissionPolicy` is the first responder — it
    derates admission the moment a latency SLO burns. This ladder is
    the escalation tier: when the burn *persists* (``escalate_ticks``
    consecutive burning observations — i.e. the derate did not
    recover), it applies the next declared stage via
    ``Router.apply_brownout_stage``; when the burn clears for
    ``recover_ticks`` consecutive observations it reverts one stage, in
    reverse order. Every transition is an obs point
    (``serve.brownout_step``) and the level a gauge
    (``fleet.brownout_stage``) — degradation is telemetry, never a
    silent drop.

    Signal sources mirror the admission policy: an injected ``reader``
    (tests, chaos drills), else the live plane's ``rollup.json``.
    """

    def __init__(
        self,
        stages: List[BrownoutStage],
        *,
        snapshot_path: Optional[str] = None,
        reader=None,
        refresh_s: float = 0.25,
        escalate_ticks: int = 8,
        recover_ticks: int = 12,
        watch_prefix: Optional[str] = None,
    ) -> None:
        if not stages:
            raise ValueError("BrownoutLadder needs at least one stage")
        if snapshot_path is None:
            snapshot_path = os.path.join(
                os.environ.get("OBS_DIR", "."), "rollup.json"
            )
        self.stages = list(stages)
        self.snapshot_path = snapshot_path
        self._reader = reader
        self.refresh_s = max(float(refresh_s), 0.0)
        self.escalate_ticks = max(int(escalate_ticks), 1)
        self.recover_ticks = max(int(recover_ticks), 1)
        self.watch_prefix = watch_prefix
        self.level = 0  # stages[:level] are currently applied
        self._hot = 0
        self._cool = 0
        self._next_read = 0.0
        self._last_burning = False
        self.transitions: List[Dict[str, Any]] = []

    @property
    def exhausted(self) -> bool:
        """Every declared stage is applied and the last observation was
        still burning — shedding alone did not recover the SLO. This is
        the signal the colocation arbiter escalates on: the pool only
        shrinks *training* after the serving-side ladder has been
        walked to the bottom (brownout → shed → shrink,
        docs/ROBUSTNESS.md)."""
        return self.level >= len(self.stages) and self._last_burning

    def _read(self) -> Optional[dict]:
        if self._reader is not None:
            return self._reader()
        from distributeddeeplearning_tpu_torch.obs.rollup import read_snapshot

        return read_snapshot(self.snapshot_path)

    def tick(self, router, now: float) -> Optional[str]:
        """One ladder decision (the router calls this every tick).
        Returns ``"down"`` (degraded one stage), ``"up"`` (recovered
        one), or None."""
        if now < self._next_read:
            return None
        self._next_read = now + self.refresh_s
        snap = self._read()
        if snap is None:
            return None  # no plane publishing: hold the current level
        burning = burning_latency_objectives(snap, self.watch_prefix)
        self._last_burning = bool(burning)
        if burning:
            self._hot += 1
            self._cool = 0
        else:
            self._cool += 1
            self._hot = 0
        if (
            burning and self._hot >= self.escalate_ticks
            and self.level < len(self.stages)
        ):
            stage = self.stages[self.level]
            self.level += 1
            self._hot = 0
            router.apply_brownout_stage(stage, True, key=self.level)
            self._record("down", stage, objectives=";".join(burning))
            return "down"
        if not burning and self._cool >= self.recover_ticks and self.level:
            stage = self.stages[self.level - 1]
            router.apply_brownout_stage(stage, False, key=self.level)
            self.level -= 1
            self._cool = 0
            self._record("up", stage)
            return "up"
        return None

    def _record(self, direction: str, stage: BrownoutStage, **labels) -> None:
        self.transitions.append({
            "direction": direction, "level": self.level,
            "stage": stage.kind, **labels,
        })
        obs.point(
            "serve.brownout_step", direction=direction, level=self.level,
            stage=stage.kind, value=stage.value, **labels,
        )
        obs.gauge("fleet.brownout_stage", float(self.level))


@dataclasses.dataclass
class ServeConfig:
    """Engine + scheduler knobs, env-overridable (SERVE_*)."""

    num_slots: int = 8
    buckets: Optional[Tuple[int, ...]] = None
    queue_depth: int = 64
    deadline_ms: Optional[float] = None
    prefills_per_step: int = 1
    top_k_cap: int = 128
    # Paged KV pool (docs/SERVING.md): "dense" keeps one max_len row per
    # slot; "paged" switches to the block pool + per-slot block tables.
    kv_layout: str = "dense"
    block_size: int = 16
    # 0 = auto: dense-equivalent bytes (num_slots * ceil(max_len /
    # block_size) + the trash block).
    num_blocks: int = 0
    prefix_cache: bool = True
    # Quantized decode tier (docs/SERVING.md): "bf16" = native compute
    # dtype; "int8"/"fp8" store the KV pool / stream the inference
    # weights quantized + f32 scales (ops/quant.py — the registry
    # quant.KV_DTYPES/WEIGHT_DTYPES is the source of truth; fp8 is
    # platform-gated with an int8 fallback). Orthogonal to kv_layout —
    # the paged pool quantizes too.
    kv_dtype: str = "bf16"
    weight_dtype: str = "bf16"
    # Decode attention lowering (SERVE_DECODE_KERNEL): "xla" = the plain
    # masked path; "fused" = the hand-written decode kernel
    # (ops/paged_decode.py). Same program set either way.
    decode_kernel: str = "xla"
    # Speculative decode tier (docs/SERVING.md): spec_k > 0 turns every
    # scheduler tick into draft-K-then-verify — 1..K+1 tokens committed
    # per slot per tick. spec_draft picks the proposal source ("int8" =
    # quantized self-draft, "ngram" = host-side prompt lookup with
    # spec_ngram_n match order, "off" only valid with spec_k == 0).
    spec_k: int = 0
    spec_draft: str = "int8"
    spec_ngram_n: int = 3
    # Telemetry feedback (docs/SERVING.md): "static" = fixed admission;
    # "adaptive" = derate while a latency SLO burns, reading the live
    # plane's rollup snapshot (rollup_path; None = $OBS_DIR/rollup.json).
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
            decode_kernel=str(
                e.get("SERVE_DECODE_KERNEL", cls.decode_kernel)
            ),
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
        # Reject unknown dtypes/kernels HERE, naming the supported list,
        # so a typo'd SERVE_* env var fails before an engine is built.
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
    """What a client submits. ``rng`` follows ``inference.generate``:
    raw PRNG key data, an int seed, or None (PRNGKey(0)).

    ``on_token``: optional streaming callback ``(handle, tokens)``
    invoked from the serving thread the moment tokens are committed
    (the push half of incremental streaming;
    :meth:`RequestHandle.stream` is the pull half). It must be cheap
    and must not raise — a raising callback is recorded as a
    ``serve.stream_callback_error`` point and dropped, never allowed
    to kill the serving loop."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    rng: Any = None
    deadline_ms: Optional[float] = None
    on_token: Any = None
    # Trace identity (docs/OBSERVABILITY.md trace plane): set by the
    # fleet router so a re-routed attempt keeps the original request's
    # trace across the router→replica thread boundary; None mints a
    # fresh trace at admission (direct Server use).
    trace: Optional[str] = None

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

    ``status``: queued → running → one of done / deadline / cancelled
    (the fleet router may also park a reclaimed handle as ``requeued``
    while it re-routes the request — serving/fleet/).
    ``result()`` blocks until finished and returns prompt + generated
    tokens (up to and including eos when one was hit); :meth:`stream`
    yields tokens incrementally as the serving loop commits them.
    """

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
        # Trace plane: the request's causal identity (minted here at
        # admission unless the fleet already owns one) and the wall
        # spent inside _deliver (stream fan-out + client callbacks) —
        # the critical path's delivery phase.
        self.trace = req.trace or obs.new_trace_id()
        self.deliver_s = 0.0
        self.done = threading.Event()
        self._cond = threading.Condition()
        self._cancel = False
        self._deadline_t = (
            now + req.deadline_ms / 1e3 if req.deadline_ms is not None
            else None
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
        """Incremental token iterator: yields each generated token (int)
        the moment the serving loop commits it, ending when the request
        finishes (a cancelled/deadline-evicted request ends the stream
        after its last delivered token — the yielded prefix is still
        exact, `tests/test_serving_fleet.py`). ``timeout`` bounds the
        wait for EACH next token; requires a second thread pumping the
        server (the single-pumper thread iterating its own stream would
        deadlock)."""
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
            # done is sticky and new_tokens never grows after it is set,
            # so a drained iterator can finish without holding the lock.
            if self.done.is_set() and i >= len(self.new_tokens):
                return

    def _deliver(self, toks: List[int]) -> None:
        """Serving-loop side: commit tokens to the handle, wake stream
        iterators, fire the push callback. Never raises."""
        if not toks:
            return
        t0 = time.monotonic()
        with self._cond:
            self.new_tokens.extend(int(t) for t in toks)
            self._cond.notify_all()
        cb = self.request.on_token
        if cb is not None:
            try:
                cb(self, [int(t) for t in toks])
            except Exception as e:  # client code must not kill the loop
                obs.point(
                    "serve.stream_callback_error", req=self.id, error=repr(e)
                )
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
    to ``prefills_per_step`` queued requests into free slots (bucketed
    prefill) → one batched decode step → deliver tokens and evict
    finished slots.
    """

    def __init__(
        self,
        engine: SlotEngine,
        *,
        queue_depth: int = 64,
        prefills_per_step: int = 1,
        default_deadline_ms: Optional[float] = None,
        admission_policy: Optional[AdmissionPolicy] = None,
        handoff: bool = False,
    ) -> None:
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if prefills_per_step < 1:
            raise ValueError(
                f"prefills_per_step must be >= 1, got {prefills_per_step}"
            )
        if handoff and engine.allocator is None:
            raise ValueError(
                "handoff mode requires kv_layout='paged' (the block "
                "table is the handoff unit)"
            )
        self.engine = engine
        # Disaggregated prefill pool (docs/SERVING.md): after the first
        # token, export the slot's state + KV blocks and free the slot
        # instead of decoding here — the fleet router collects the
        # export (take_handoffs) and seats it on a decode replica.
        self.handoff = bool(handoff)
        self._handoffs: List[Tuple[RequestHandle, Dict[str, Any]]] = []
        # Directory pin plane: the fleet router flips handoff_pin on
        # (before any request reaches this server) when it owns a
        # PrefixDirectory, and greedy exports then pin their full
        # prefix blocks HERE, on the pump thread, before the slot is
        # released — a pin from the router thread could race an
        # in-flight eviction. The budget bounds how much of the pool a
        # storm of distinct hot prompts can nail down; past it the
        # export still publishes (payload rides the state), it just
        # maps no resident blocks.
        self.handoff_pin = False
        self._handoff_pins = 0
        self.queue_depth = queue_depth
        # The policy-adjustable knobs: queue_limit is the *effective*
        # QueueFull threshold (<= queue_depth, the configured ceiling);
        # prefills_per_step is mutable for the same reason.
        self.queue_limit = queue_depth
        self.prefills_per_step = prefills_per_step
        self.default_deadline_ms = default_deadline_ms
        self.policy = admission_policy
        self._lock = threading.Lock()
        self._queue: Deque[RequestHandle] = collections.deque()
        self._ids = itertools.count()
        self._by_slot: Dict[int, RequestHandle] = {}
        self._closed = False
        # The shared engine tick's own trace identity: decode steps are
        # fleet-shared work, so the tick span lives on this per-server
        # trace while each occupied slot gets a per-request
        # serve.decode_share attribution (tick wall / occupied slots).
        self._tick_trace = obs.new_trace_id()
        self.stats: Dict[str, Any] = {
            "admitted": 0, "completed": 0, "rejected": 0, "cancelled": 0,
            "deadline": 0, "tokens": 0, "decode_steps": 0,
            "occupancy_sum": 0.0, "occupancy_samples": 0,
            # Peak co-resident requests — the capacity headline the
            # paged-vs-dense bench compares at a fixed pool-byte budget.
            "peak_active": 0,
        }

    @classmethod
    def build(cls, model, params=None, config: Optional[ServeConfig] = None,
              **engine_kw) -> "Server":
        """Engine + server from one :class:`ServeConfig` (env-driven by
        default). ``engine_kw`` reaches :class:`SlotEngine` (``device``,
        ``max_len``, ...)."""
        cfg = config or ServeConfig.from_env()
        engine = SlotEngine(
            model, params, **cfg.engine_kwargs(), **engine_kw,
        )
        return cls(
            engine,
            queue_depth=cfg.queue_depth,
            prefills_per_step=cfg.prefills_per_step,
            default_deadline_ms=cfg.deadline_ms,
            admission_policy=cfg.build_admission_policy(),
        )

    # -- client side -------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Enqueue one request (validated eagerly so a malformed request
        fails the caller, not the serving loop). Raises
        :class:`QueueFull` when the bounded queue is at capacity — the
        backpressure signal a front-end turns into HTTP 429."""
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
                with obs.trace_ctx(request.trace):
                    obs.counter("serve.rejected")
                raise QueueFull(
                    f"admission queue at capacity ({self.queue_limit})"
                )
            handle = RequestHandle(request, next(self._ids), now)
            self._queue.append(handle)
            with obs.trace_ctx(handle.trace):
                obs.gauge("serve.queue_depth", float(len(self._queue)))
        # Flight-recorder registry: this server's process now holds the
        # trace until _finish / reclaim closes it.
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
                # Stream fan-out + client-callback wall for this
                # attempt — the critical path's delivery phase.
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
                        "serve.cancelled" if h._cancel
                        else "serve.evicted_deadline"
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
            # Block-pool gate (paged layout): FIFO order is preserved —
            # a head request that doesn't fit waits at the front until
            # running streams release blocks. A backed-up queue then
            # surfaces as QueueFull at submit (backpressure), exactly
            # like slot exhaustion.
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
                    "serve.prefill", bucket=self.engine.bucket_for(
                        spec.prompt.shape[0]
                    ), slot=slot, prompt_len=int(spec.prompt.shape[0]),
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
                obs.counter("serve.tokens")  # prefill-sampled first token
            admitted += 1
            if eos_hit or len(handle.new_tokens) >= spec.max_new_tokens:
                self.engine.release(slot)
                self._finish(handle, "eos" if eos_hit else "length")
            elif self.handoff:
                # Disaggregated prefill: the slot's job here is done the
                # moment the first token exists. Export state + blocks,
                # free the slot for the next prefill, and park the
                # handle for the router's handoff sweep. The trace
                # leaves with the export (the decode replica re-opens
                # it); ``handoff_t`` anchors the serve.handoff_ms
                # window.
                state = self.engine.export_slot(slot)
                state["handoff_t"] = time.monotonic()
                if (
                    self.handoff_pin
                    and float(state["temp"]) == 0.0
                    and self.engine.allocator is not None
                ):
                    alloc = self.engine.allocator
                    nfull = (
                        int(np.asarray(handle.request.prompt).reshape(-1)
                            .shape[0]) // state["block_size"]
                    )
                    bids = list(state["blocks"][:nfull])
                    fresh = [b for b in bids if not alloc.pinned(b)]
                    budget = alloc.capacity // 4
                    if bids and self._handoff_pins + len(fresh) <= budget:
                        for b in bids:
                            alloc.pin(b)
                        self._handoff_pins += len(fresh)
                        state["pinned"] = bids
                self.engine.release(slot)
                handle.status = "handoff"
                obs.trace_close(handle.trace)
                with self._lock:
                    self._handoffs.append((handle, state))
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
        self.stats["peak_active"] = max(
            self.stats["peak_active"], len(self._by_slot)
        )
        if self._by_slot:
            active = len(self._by_slot)
            tick_t0 = time.monotonic()
            with obs.trace_ctx(self._tick_trace):
                with obs.span("serve.decode_step", active=active):
                    # Speculative tier: one tick commits 1..spec_k+1
                    # tokens per slot (draft + batched verify); the
                    # non-spec step is the single-token special case of
                    # the same shape. A brownout spec_off stage suspends
                    # speculation at runtime — the plain decode program
                    # is already in the closed set, so the fallback
                    # captures nothing.
                    if self.engine.spec_enabled and not getattr(
                        self.engine, "spec_suspended", False
                    ):
                        emitted = self.engine.spec_step()
                    else:
                        emitted = [
                            (slot, [token], eos_hit)
                            for slot, token, eos_hit in
                            self.engine.decode_step()
                        ]
            # Shared-tick attribution (docs/OBSERVABILITY.md): each
            # occupied slot is charged an equal share of the tick wall,
            # so a per-request decode timeline exists even though the
            # engine batches all slots into one program dispatch.
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
                    if eos_hit or (
                        len(h.new_tokens) >= h.request.max_new_tokens
                    ):
                        self.engine.release(slot)
                        del self._by_slot[slot]
                        self._finish(h, "eos" if eos_hit else "length")
            obs.counter("serve.tokens", n_tokens)
        with self._lock:
            busy = bool(self._by_slot or self._queue)
        if busy:
            # Occupancy is sampled on working ticks only — idle polling
            # between arrivals would dilute the mean to meaninglessness.
            occ = self.engine.occupancy
            self.stats["occupancy_sum"] += occ
            self.stats["occupancy_samples"] += 1
            obs.gauge("serve.slot_occupancy", occ)
        return busy

    def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful drain: pump until every queued + active request has
        finished (admissions keep flowing; callers stop submitting)."""
        t0 = time.monotonic()
        while self.step():
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("drain timed out with work remaining")

    def serve_forever(self, stop: threading.Event,
                      idle_sleep_s: float = 0.001) -> None:
        """Pump loop for a background serving thread: steps while work
        exists, naps briefly when idle, drains once ``stop`` is set."""
        while not stop.is_set():
            if not self.step():
                time.sleep(idle_sleep_s)
        self.drain()

    def close(self) -> None:
        """Stop accepting, drain what was already admitted or queued."""
        self._closed = True
        self.drain()

    # -- fleet hooks (serving/fleet/router.py) -----------------------------

    def reclaim_queued(self) -> List[RequestHandle]:
        """Pull every queued-but-not-yet-admitted request back out of
        the server (status → ``requeued``, done NOT set) so a fleet
        router can re-route it to another replica — the drain path's
        zero-drop guarantee. Safe from any thread."""
        with self._lock:
            out = list(self._queue)
            self._queue.clear()
            obs.gauge("serve.queue_depth", 0.0)
        for h in out:
            h.status = "requeued"
            # The trace leaves with the request — this process no
            # longer holds it (flight-recorder registry).
            obs.trace_close(h.trace)
        return out

    def take_running(self) -> List[RequestHandle]:
        """Evict every RUNNING request and hand its handle back (status
        → ``requeued``) for a from-scratch restart elsewhere — the
        *faulted*-replica path. Per-request determinism (the serving
        tier's bitwise-parity contract) makes the restart's stream an
        exact superset of what was already delivered, so the fleet
        handle can splice without duplication. Only call with the pump
        stopped (the single-pumper thread dead or parked)."""
        out = []
        for slot, h in list(self._by_slot.items()):
            try:
                self.engine.release(slot)
            except Exception:
                pass  # a faulted engine's bookkeeping may be wrecked
            del self._by_slot[slot]
            h.status = "requeued"
            obs.trace_close(h.trace)
            out.append(h)
        return out

    def take_handoffs(self) -> List[Tuple[RequestHandle, Dict[str, Any]]]:
        """Collect every pending prefill export (handoff mode). Safe
        from any thread — the router calls this each tick and seats the
        exports on decode replicas. Exports are pure host data, so they
        survive this replica's death: anything already collected can be
        imported anywhere."""
        with self._lock:
            out = self._handoffs
            self._handoffs = []
        return out

    def export_running(
        self, handle: RequestHandle
    ) -> Optional[Dict[str, Any]]:
        """Live migration export: snapshot ``handle``'s slot state + KV
        blocks (:meth:`SlotEngine.export_slot`), release the slot, and
        park the handle (status → ``requeued``). Unlike
        :meth:`take_running`, the export makes the continuation a state
        transplant — the importing replica replays nothing. Only call
        with the pump parked. Returns None when the handle is not
        running here."""
        for slot, h in list(self._by_slot.items()):
            if h is handle:
                state = self.engine.export_slot(slot)
                state["handoff_t"] = time.monotonic()
                self.engine.release(slot)
                del self._by_slot[slot]
                h.status = "requeued"
                obs.trace_close(h.trace)
                return state
        return None

    def import_running(
        self,
        request: Request,
        state: Dict[str, Any],
        prior_tokens: Optional[List[int]] = None,
    ) -> RequestHandle:
        """Seat an exported slot state (handoff or migration) as a
        RUNNING request — no queue, no prefill: the engine restores the
        KV blocks and sampling cursor and the next decode tick continues
        the stream bitwise. ``prior_tokens`` seeds the handle with the
        tokens earlier attempts already delivered so the finish
        condition (``len(new_tokens) >= max_new_tokens``) and the
        stream splice stay exact. Raises when no slot/blocks are free —
        the caller checked :meth:`SlotEngine.can_import` first."""
        if self._closed:
            raise RuntimeError("server is closed")
        free = self.engine.free_slots
        if not free:
            raise RuntimeError("no free slot for import")
        now = time.monotonic()
        slot = free[0]
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        self.engine.import_slot(slot, state, prompt=prompt)
        handle = RequestHandle(request, next(self._ids), now)
        handle.status = "running"
        handle.queue_wait_s = 0.0
        if prior_tokens:
            handle.new_tokens = [int(t) for t in prior_tokens]
        self._by_slot[slot] = handle
        obs.trace_open(handle.trace, req=handle.id)
        return handle

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


def generate_with_engine(
    server_or_engine,
    prompt: np.ndarray,
    *,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_token: Optional[int] = None,
    pad_token: Optional[int] = None,
    rng: Any = None,
    on_token: Any = None,
) -> np.ndarray:
    """``inference.generate``'s signature served by the slot engine:
    each row of ``prompt`` ([B, Tp] int32) becomes one request; rows
    co-decode in the pool and the result is reassembled to
    ``[B, Tp + max_new_tokens]`` (eos freezes a row to ``pad_token``,
    like ``generate``).

    Row 0 uses ``rng`` directly, so at B=1 the output is bitwise-equal
    to sequential ``generate``; rows b>0 sample under
    ``fold_in(rng, b)`` (``generate`` draws all rows from one key per
    step, which has no per-row equivalent).

    ``server_or_engine`` may also be a fleet
    :class:`~distributeddeeplearning_tpu_torch.serving.fleet.router.Router` —
    rows then route through the fleet (default tenant).

    ``on_token``: optional incremental streaming callback
    ``(row_index, token)`` invoked as tokens are committed — the final
    array equals exactly the streamed tokens (oracle-tested).
    """
    from distributeddeeplearning_tpu_torch.serving import keys as keylib
    from distributeddeeplearning_tpu_torch.serving.fleet.router import Router

    router: Optional[Router] = None
    if isinstance(server_or_engine, Router):
        router = server_or_engine
    elif isinstance(server_or_engine, Server):
        server = server_or_engine
    else:
        server = Server(server_or_engine)
    prompt = np.asarray(prompt, np.int32)
    if prompt.ndim != 2:
        raise ValueError(f"prompt must be [B, Tp], got {prompt.shape}")
    if eos_token is not None and pad_token is None:
        pad_token = eos_token
    base_key = ReqSpec(
        prompt=prompt[0], max_new_tokens=max_new_tokens, rng=rng
    ).key_data()
    handles = []
    for b in range(prompt.shape[0]):
        row_key = base_key if b == 0 else keylib.fold_key(base_key, b)
        cb = None
        if on_token is not None:
            def cb(_h, toks, b=b):
                for tok in toks:
                    on_token(b, int(tok))
        req = Request(
            prompt=prompt[b], max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token=eos_token, rng=row_key, on_token=cb,
        )
        handles.append(
            router.submit(req) if router is not None else server.submit(req)
        )
    (router if router is not None else server).drain()
    out = np.full(
        (prompt.shape[0], prompt.shape[1] + max_new_tokens),
        0 if pad_token is None else pad_token, np.int32,
    )
    for b, h in enumerate(handles):
        toks = h.result(timeout=0)
        out[b, : toks.shape[0]] = toks
    return out
