"""Fleet router: per-tenant fair admission over N serving replicas
(port of ``serving/fleet/router.py``).

The front door of the multi-replica serving tier (docs/SERVING.md).
Clients submit tenant-tagged requests; the router owns everything
between submission and a replica's slot pool:

* **Deficit-weighted fair queueing** — one bounded queue per tenant,
  served by token-cost deficit round robin: each dispatch round every
  backlogged tenant banks ``quantum × weight`` deficit and may dispatch
  requests while its deficit covers their ``max_new_tokens`` cost. A
  hot tenant flooding the fleet cannot starve a weight-1 neighbour:
  the neighbour banks deficit every round and dispatches as soon as one
  request's cost is covered, and completed-token shares track weight
  shares under contention (the fleet bench's fairness gate). An idle
  tenant banks nothing (classic DRR — no credit hoarding).
* **Placement** — among ``ready`` replicas that can admit the request
  (free slot, free KV blocks): a **prefix-affinity tier** first
  (``SERVE_PLACEMENT=affinity``, default): requests whose prompt shares
  a block-aligned cached prefix route to the replica whose
  BlockAllocator already holds those blocks (prefill then computes only
  the divergent suffix); ties and affinity-less requests fall to
  **least-loaded** (free-slot + free-block fraction); ``load`` skips
  the affinity tier, ``rr`` round-robins (the A/B control).
* **Health / drain / rejoin** — :meth:`drain_replica` stops placement
  and reclaims the replica's queued requests back into the tenant
  queues (front, original submit order); running streams finish on the
  replica. A **faulted** replica's queued *and* running requests
  re-route: per-request determinism (the serving tier's bitwise-parity
  contract) means a from-scratch restart on another replica replays the
  identical stream, so the fleet handle splices at the exact token
  where delivery stopped — zero drops, zero duplicates, oracle-tested.
  Rejoin eligibility follows the faults exit taxonomy
  (``faults.classify_exit`` — deterministic failures don't rejoin).
* **Self-healing monitor** (docs/ROBUSTNESS.md serving failure model)
  — every tick: stale pump heartbeats hard-fault hung replicas (the
  unjoinable thread is detached, ``fleet.thread_leaked``); a
  straggler (busy-tick EWMA > ``SERVE_STRAGGLER_FACTOR`` x the fleet
  median, sustained) is **quarantined** and its running work hedge
  re-routed through the splice path; a replay diverging from the
  delivered prefix (``fleet.splice_mismatch``) hard-faults the
  divergent replica and heals from the deterministic prefix; faulted
  replicas auto-rejoin behind a per-replica restart budget with
  exponential backoff, and budget exhaustion opens a **circuit
  breaker** (``fleet.breaker_open``) that removes the rid for good.
  A :class:`~distributeddeeplearning_tpu_torch.serving.scheduler.BrownoutLadder`
  (``SERVE_BROWNOUT_STAGES``) degrades under sustained SLO burn and
  walks back on recovery; a seeded
  :class:`~distributeddeeplearning_tpu_torch.serving.chaos.ChaosInjector`
  (``SERVE_CHAOS_PLAN``) makes every one of these paths a
  deterministic drill (``scripts/chaos_bench.py``).
* **Streaming** — tokens flow to :class:`FleetHandle` the moment a
  replica commits them (``Request.on_token`` push), so ``stream()`` /
  client callbacks see a true incremental stream and TTFT is a real
  first-token measurement end to end, queueing and routing included.
* **Autoscale signal** — every router tick publishes
  ``serve.fleet_pressure`` (demanded slots / ready slots, and KV-block
  saturation on paged fleets) plus ``serve.fleet_replicas`` /
  ``serve.fleet_queued`` / ``serve.fleet_active`` gauges; a
  :class:`~distributeddeeplearning_tpu_torch.serving.fleet.controller.FleetController`
  consumes the signal between ticks to add or drain replicas.

Env contract (:meth:`FleetConfig.from_env`, docs/ORCHESTRATION.md):
``SERVE_REPLICAS``, ``SERVE_TENANT_WEIGHTS`` (``name:weight,…``),
``SERVE_PLACEMENT`` (``affinity`` | ``load`` | ``rr``),
``SERVE_FLEET_QUEUE_DEPTH``, ``SERVE_FLEET_QUANTUM``; health/chaos:
``SERVE_STRAGGLER_FACTOR``, ``SERVE_STRAGGLER_TICKS``,
``SERVE_QUARANTINE_TICKS``, ``SERVE_PUMP_HEARTBEAT_S``,
``SERVE_REPLICA_MAX_RESTARTS``, ``SERVE_REPLICA_RESTART_BACKOFF``,
``SERVE_FAULT_JOIN_S``, ``SERVE_BROWNOUT_STAGES``,
``SERVE_CHAOS_PLAN``, ``SERVE_CHAOS_SEED``; disaggregation:
``SERVE_DISAGG``, ``SERVE_POOL_PREFILL``, ``SERVE_POOL_DECODE``,
``SERVE_DISAGG_DIRECTORY``, ``SERVE_DISAGG_PREFETCH``.

**Disaggregated serving** (``SERVE_DISAGG=1``, docs/SERVING.md): the
fleet splits into a *prefill pool* and a *decode pool*. A prefill
replica admits, runs the bucketed prefill, delivers the first token,
then exports the slot's state + KV block content and frees the slot —
the router's handoff sweep seats the export on a decode replica as a
RUNNING stream (no replay; the block table is the handoff unit), so a
bursty long prompt never sits in anyone's decode tick. Greedy exports
also publish into the fleet-wide :class:`PrefixDirectory`: a second
consumer of an identical prompt **adopts** the entry (decode state
transplanted straight from the directory — zero prefill programs run),
and a prompt sharing only a full-block prefix **chain-prefetches**
those blocks into its target replica's local cache. The same
export/import machinery backs :meth:`Router.migrate` — scheduled live
KV-block migration of a running stream between replicas, bitwise
spliced, zero drops.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.serving.blocks import (
    BlockPoolExhausted,
    PrefixDirectory,
)
from distributeddeeplearning_tpu_torch.serving.chaos import SpliceMismatch
from distributeddeeplearning_tpu_torch.serving.fleet.replica import Replica
from distributeddeeplearning_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    RequestHandle,
    ServeConfig,
)

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class FleetConfig:
    """Fleet-level knobs, env-overridable (SERVE_* — docs/SERVING.md).
    Per-replica engine/scheduler knobs stay on :class:`ServeConfig`."""

    replicas: int = 2
    tenant_weights: Optional[Dict[str, float]] = None
    placement: str = "affinity"
    queue_depth: int = 1024
    # DRR quantum: deficit banked per weight unit per fresh cursor
    # visit, in token-cost units (a request costs its max_new_tokens).
    # Smaller = finer-grained interleave (smoother fairness at the cost
    # of more cursor cycles); a weight-1 tenant still always progresses
    # — it banks every visit and dispatches once its deficit covers one
    # request.
    quantum: int = 16
    # Health plane (docs/ROBUSTNESS.md serving failure model): a
    # replica whose busy-tick latency EWMA exceeds straggler_factor x
    # the fleet median for straggler_ticks consecutive monitor sweeps
    # is quarantined (drained of placements, running work hedge
    # re-routed through the splice path) for quarantine_ticks router
    # ticks; a threaded pump whose heartbeat goes stale past
    # heartbeat_timeout_s while it holds work is hard-faulted.
    straggler_factor: float = 4.0
    straggler_ticks: int = 5
    quarantine_ticks: int = 50
    heartbeat_timeout_s: float = 5.0
    # Crash-loop circuit breaker (launch_supervised semantics): a
    # faulted retryable replica auto-rejoins after restart_backoff_s x
    # 2^attempt; after max_restarts rejoins the breaker opens
    # (fleet.breaker_open) and the replica is removed. fault_join_s
    # bounds how long fail/remove wait for a pump before detaching it.
    max_restarts: int = 3
    restart_backoff_s: float = 1.0
    fault_join_s: float = 5.0
    # Brownout degradation ladder (SERVE_BROWNOUT_STAGES, e.g.
    # "spec_off,max_new:8,shed:1") and the chaos plane's drill plan.
    brownout_stages: str = ""
    chaos_plan: str = ""
    chaos_seed: int = 0
    # Disaggregated prefill/decode pools (docs/SERVING.md): pool sizes
    # of 0 auto-split (prefill gets floor(replicas/2), min 1); setting
    # exactly one fixes that pool and the other takes the remainder.
    # ``directory`` enables the fleet-wide prefix directory (adoption +
    # chain prefetch); ``prefetch`` gates just the chain-prefetch leg.
    disagg: bool = False
    prefill_pool: int = 0
    decode_pool: int = 0
    directory: bool = True
    prefetch: bool = True

    @classmethod
    def from_env(cls, env=None) -> "FleetConfig":
        e = os.environ if env is None else env
        weights = None
        if e.get("SERVE_TENANT_WEIGHTS"):
            weights = parse_tenant_weights(e["SERVE_TENANT_WEIGHTS"])
        return cls(
            replicas=int(e.get("SERVE_REPLICAS", cls.replicas)),
            tenant_weights=weights,
            placement=str(e.get("SERVE_PLACEMENT", cls.placement)),
            queue_depth=int(
                e.get("SERVE_FLEET_QUEUE_DEPTH", cls.queue_depth)
            ),
            quantum=int(e.get("SERVE_FLEET_QUANTUM", cls.quantum)),
            straggler_factor=float(
                e.get("SERVE_STRAGGLER_FACTOR", cls.straggler_factor)
            ),
            straggler_ticks=int(
                e.get("SERVE_STRAGGLER_TICKS", cls.straggler_ticks)
            ),
            quarantine_ticks=int(
                e.get("SERVE_QUARANTINE_TICKS", cls.quarantine_ticks)
            ),
            heartbeat_timeout_s=float(
                e.get("SERVE_PUMP_HEARTBEAT_S", cls.heartbeat_timeout_s)
            ),
            max_restarts=int(
                e.get("SERVE_REPLICA_MAX_RESTARTS", cls.max_restarts)
            ),
            restart_backoff_s=float(
                e.get("SERVE_REPLICA_RESTART_BACKOFF", cls.restart_backoff_s)
            ),
            fault_join_s=float(e.get("SERVE_FAULT_JOIN_S", cls.fault_join_s)),
            brownout_stages=str(e.get("SERVE_BROWNOUT_STAGES", "")),
            chaos_plan=str(e.get("SERVE_CHAOS_PLAN", "")),
            chaos_seed=int(e.get("SERVE_CHAOS_SEED", "0")),
            disagg=_env_flag(e.get("SERVE_DISAGG"), cls.disagg),
            prefill_pool=int(e.get("SERVE_POOL_PREFILL", cls.prefill_pool)),
            decode_pool=int(e.get("SERVE_POOL_DECODE", cls.decode_pool)),
            directory=_env_flag(
                e.get("SERVE_DISAGG_DIRECTORY"), cls.directory
            ),
            prefetch=_env_flag(e.get("SERVE_DISAGG_PREFETCH"), cls.prefetch),
        )

    def validate(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.placement not in ("affinity", "load", "rr"):
            raise ValueError(
                f"SERVE_PLACEMENT must be affinity|load|rr, got "
                f"{self.placement!r}"
            )
        if self.queue_depth < 1 or self.quantum < 1:
            raise ValueError("queue_depth and quantum must be >= 1")
        for t, w in (self.tenant_weights or {}).items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        if self.straggler_factor <= 1.0:
            raise ValueError(
                f"SERVE_STRAGGLER_FACTOR must be > 1, got "
                f"{self.straggler_factor}"
            )
        if self.straggler_ticks < 1 or self.quarantine_ticks < 1:
            raise ValueError(
                "straggler_ticks and quarantine_ticks must be >= 1"
            )
        if self.max_restarts < 0 or self.restart_backoff_s < 0:
            raise ValueError(
                "max_restarts and restart_backoff_s must be >= 0"
            )
        if self.brownout_stages:
            from distributeddeeplearning_tpu_torch.serving.scheduler import (
                parse_brownout_stages,
            )

            parse_brownout_stages(self.brownout_stages)
        if self.chaos_plan:
            from distributeddeeplearning_tpu_torch.serving.chaos import (
                parse_chaos_plan,
            )

            parse_chaos_plan(self.chaos_plan)
        if self.prefill_pool < 0 or self.decode_pool < 0:
            raise ValueError(
                "SERVE_POOL_PREFILL and SERVE_POOL_DECODE must be >= 0"
            )
        if self.disagg:
            if self.replicas < 2:
                raise ValueError(
                    f"SERVE_DISAGG needs >= 2 replicas (one per pool), "
                    f"got {self.replicas}"
                )
            pre, dec = self.pool_split()
            if pre < 1 or dec < 1:
                raise ValueError(
                    f"pool split {pre}+{dec} must leave at least one "
                    f"replica in each pool (SERVE_REPLICAS="
                    f"{self.replicas}, SERVE_POOL_PREFILL="
                    f"{self.prefill_pool}, SERVE_POOL_DECODE="
                    f"{self.decode_pool})"
                )
            if pre + dec != self.replicas:
                raise ValueError(
                    f"SERVE_POOL_PREFILL + SERVE_POOL_DECODE = "
                    f"{pre + dec} != SERVE_REPLICAS {self.replicas}"
                )

    def pool_split(self) -> "tuple[int, int]":
        """``(prefill, decode)`` replica counts under ``disagg``
        (``(0, 0)`` otherwise). Unset pools auto-split."""
        if not self.disagg:
            return (0, 0)
        n = self.replicas
        if self.prefill_pool and self.decode_pool:
            return (self.prefill_pool, self.decode_pool)
        if self.prefill_pool:
            return (self.prefill_pool, n - self.prefill_pool)
        if self.decode_pool:
            return (n - self.decode_pool, self.decode_pool)
        pre = max(n // 2, 1)
        return (pre, n - pre)


def _env_flag(raw: Optional[str], default: bool) -> bool:
    """``"1"/"true"/"yes"/"on"`` → True, ``"0"/"false"/"no"/"off"`` →
    False, unset/empty → ``default``."""
    if raw is None or str(raw).strip() == "":
        return bool(default)
    return str(raw).strip().lower() not in ("0", "false", "no", "off")


def parse_tenant_weights(text: str) -> Dict[str, float]:
    """``"a:3,b:1.5,c:1"`` → ``{"a": 3.0, "b": 1.5, "c": 1.0}`` (bare
    ``"a"`` means weight 1)."""
    out: Dict[str, float] = {}
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition(":")
        out[name.strip()] = float(w) if w.strip() else 1.0
    return out


class _Tenant:
    """One tenant's DRR lane: weight, FIFO backlog, banked deficit."""

    __slots__ = ("name", "weight", "queue", "deficit", "tokens_done",
                 "completed")

    def __init__(self, name: str, weight: float) -> None:
        self.name = name
        self.weight = float(weight)
        self.queue: Deque["FleetHandle"] = collections.deque()
        self.deficit = 0.0
        self.tokens_done = 0
        self.completed = 0


class FleetHandle:
    """Client-side view of one fleet request — survives re-routing.

    The underlying per-replica :class:`RequestHandle` is an *attempt*;
    this handle splices attempts into one exact stream: tokens already
    delivered are never re-emitted, and a restarted attempt's replay
    (identical by the per-request determinism contract) is verified
    token-for-token against the delivered prefix
    (``restart_consistent``). API mirrors :class:`RequestHandle`:
    ``tokens`` / ``result()`` / ``stream()`` / ``cancel()``.
    """

    def __init__(self, request: Request, tenant: str, fid: int,
                 now: float) -> None:
        self.request = request
        self.tenant = tenant
        self.id = fid
        self.status = "queued"
        self.finish_reason: Optional[str] = None
        self.new_tokens: List[int] = []
        self.submitted_t = now
        self.ttft_s: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.done = threading.Event()
        self.replica_id: Optional[int] = None
        self.attempts = 0
        self.restart_consistent = True
        # Trace plane (docs/OBSERVABILITY.md): the fleet mints the
        # request's causal identity at submission; every attempt's
        # Request carries it to the replica (Request.trace), and a
        # re-route stamps its cause (hedge|splice|brownout|migration)
        # on the child span the next dispatch emits.
        self.trace = request.trace or obs.new_trace_id()
        self._reroute_cause: Optional[str] = None
        self._requeued_t: Optional[float] = None
        self._reroute_from: Optional[int] = None
        # Splice-integrity ledger (docs/ROBUSTNESS.md serving failure
        # model): every replay mismatch ever seen (the corrupt
        # detector's count — survives healing), the live divergence
        # flag the router's monitor sweep heals, and the per-attempt
        # taint that stops a divergent attempt's tokens from ever
        # reaching the client.
        self.splice_mismatches = 0
        self._divergent = False
        self._sub_tainted = False
        self._chaos = None  # set by the router when a drill is armed
        self._cond = threading.Condition()
        self._cancel = False
        self._client_cb = request.on_token
        self._sub: Optional[RequestHandle] = None
        self._sub_seen = 0  # tokens ingested from the CURRENT attempt
        self._deadline_t = (
            now + request.deadline_ms / 1e3
            if request.deadline_ms is not None else None
        )

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.request.prompt, np.int32).reshape(-1),
            np.asarray(self.new_tokens, np.int32),
        ])

    def cancel(self) -> None:
        self._cancel = True
        sub = self._sub
        if sub is not None:
            sub.cancel()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still {self.status}")
        return self.tokens

    def stream(self, timeout: Optional[float] = None):
        """Incremental token iterator across attempts — yields each
        token exactly once, in order, whatever re-routing happened
        underneath (``RequestHandle.stream`` semantics otherwise).

        **Timeout contract:** ``timeout`` bounds the wait for EACH next
        token. On expiry the stream **cancels the request and raises
        TimeoutError** — the handle detaches from its replica attempt
        and the fleet reaps it as ``cancelled``, so an abandoned stream
        never leaves a zombie request decoding (chaos drills submit
        thousands of bounded streams; without cancel-on-timeout every
        straggler-stalled stream would leak its slot)."""
        i = 0
        while True:
            with self._cond:
                while i >= len(self.new_tokens) and not self.done.is_set():
                    if not self._cond.wait(timeout):
                        self.cancel()
                        raise TimeoutError(
                            f"request {self.id}: no token within "
                            f"{timeout}s (request cancelled)"
                        )
                fresh = self.new_tokens[i:]
            for tok in fresh:
                yield int(tok)
            i += len(fresh)
            if self.done.is_set() and i >= len(self.new_tokens):
                return

    def expired(self, now: float) -> bool:
        return self._deadline_t is not None and now > self._deadline_t

    # -- router side -------------------------------------------------------

    def _attach(self, sub: RequestHandle, replica_id: int,
                seen: int = 0) -> None:
        """Bind one replica attempt. ``seen`` is how many of this
        handle's delivered tokens the attempt ALREADY accounts for: a
        from-scratch dispatch replays from token 0 (``seen=0``, every
        replayed token verified against the delivered prefix), while a
        handoff/migration continuation was seeded with the delivered
        prefix (``import_running(prior_tokens=...)``) and emits only
        fresh tokens — ``seen=len(new_tokens)`` keeps the splice
        cursor exact so the continuation neither re-verifies nor
        mis-indexes."""
        self._sub = sub
        self._sub_seen = seen
        self._sub_tainted = False
        self.replica_id = replica_id
        self.attempts += 1
        self.status = "running"

    def _detach(self) -> None:
        self._sub = None
        self._sub_seen = 0
        self._sub_tainted = False
        self.replica_id = None
        self.status = "queued"

    def _ingest(self, toks: List[int]) -> None:
        """Splice one attempt's delivery into the fleet stream. Called
        from the replica's serving thread (via ``Request.on_token``).

        Replayed tokens (an attempt re-covering the already-delivered
        prefix after a re-route) are verified token-for-token against
        the delivered stream and never re-emitted. A mismatch —
        determinism says a healthy replica cannot produce one, so the
        attempt is emitting corrupt data — **taints the whole attempt**:
        nothing further from it reaches the client, and the router's
        monitor sweep hard-faults the replica and replays the stream
        from the deterministic prefix elsewhere (the corrupt verb's
        detect-and-heal path, docs/ROBUSTNESS.md)."""
        mismatch = False
        fresh: List[int] = []
        with self._cond:
            if self._sub_tainted:
                return
            start = self._sub_seen
            self._sub_seen += len(toks)
            for j, tok in enumerate(toks):
                gi = start + j
                if gi < len(self.new_tokens):
                    t_in = int(tok)
                    if self._chaos is not None:
                        t_in = self._chaos.maybe_corrupt(self.id, t_in)
                    if self.new_tokens[gi] != t_in:
                        self.restart_consistent = False
                        self.splice_mismatches += 1
                        self._divergent = True
                        self._sub_tainted = True
                        mismatch = True
                        break  # drop the attempt's remaining tokens
                else:
                    self.new_tokens.append(int(tok))
                    fresh.append(int(tok))
            if fresh and self.ttft_s is None:
                self.ttft_s = time.monotonic() - self.submitted_t
            if fresh:
                self._cond.notify_all()
        if mismatch:
            obs.point("fleet.restart_divergence", req=self.id)
        if fresh and self._client_cb is not None:
            try:
                self._client_cb(self, fresh)
            except Exception as e:
                obs.point(
                    "serve.stream_callback_error", req=self.id, error=repr(e)
                )

    def _finish(self, reason: str) -> None:
        self.status = "done" if reason in ("eos", "length") else reason
        self.finish_reason = reason
        self.finished_t = time.monotonic()
        with self._cond:
            self.done.set()
            self._cond.notify_all()


class Router:
    """The fleet front end: tenant queues → placement → replicas.

    Single-pumper model like :class:`Server`: one thread drives
    :meth:`step` / :meth:`drain` / :meth:`serve_forever`; ``submit`` /
    ``cancel`` are safe from any thread. Replica pumps are their own
    threads (``Replica.start(threaded=True)``) or are pumped inline by
    :meth:`step` (deterministic tests).
    """

    def __init__(
        self,
        replicas: Optional[List[Replica]] = None,
        *,
        config: Optional[FleetConfig] = None,
        chaos=None,
        brownout=None,
    ) -> None:
        self.config = config or FleetConfig()
        self.config.validate()
        self.replicas: List[Replica] = []
        self._tenants: Dict[str, _Tenant] = {}
        for name, w in (self.config.tenant_weights or {}).items():
            self._tenants[name] = _Tenant(name, w)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._inflight: List[FleetHandle] = []
        self._rr_cursor = 0
        self._drr_cursor = 0
        self._drr_fresh = True
        self._closed = False
        self.last_pressure = 0.0
        # Chaos plane + brownout ladder (env-wired by default; tests
        # and benches inject their own).
        if chaos is None and self.config.chaos_plan:
            from distributeddeeplearning_tpu_torch.serving.chaos import (
                ChaosInjector,
                parse_chaos_plan,
            )

            chaos = ChaosInjector(
                parse_chaos_plan(self.config.chaos_plan),
                seed=self.config.chaos_seed,
            )
        self.chaos = chaos
        if brownout is None and self.config.brownout_stages:
            from distributeddeeplearning_tpu_torch.serving.scheduler import (
                BrownoutLadder,
                parse_brownout_stages,
            )

            brownout = BrownoutLadder(
                parse_brownout_stages(self.config.brownout_stages)
            )
        self.brownout = brownout
        self._ticks = 0  # completed router ticks (the chaos clock)
        # Crash-loop breaker ledger: rid -> {attempts, next_t, pending,
        # open}. Survives a replica's removal so a breaker-open rid can
        # never slip back into rotation.
        self._breakers: Dict[int, Dict[str, Any]] = {}
        self.last_breaker_tick: Optional[int] = None
        # Brownout state applied by apply_brownout_stage.
        self._shed_tenants: set = set()
        self._shed_by_stage: Dict[int, set] = {}
        self._brownout_max_new: Optional[int] = None
        # Disaggregation plane (docs/SERVING.md): the fleet-wide prefix
        # directory (greedy prefill exports publish; adoptions and
        # chain prefetches consume) and the prefill→decode handoff
        # queue — exports waiting for a decode replica with room.
        # Entries retry every tick until seated: backpressure, never a
        # drop.
        self.directory: Optional[PrefixDirectory] = (
            PrefixDirectory()
            if self.config.disagg and self.config.directory else None
        )
        self._pending_handoffs: Deque[Any] = collections.deque()
        # Each seated handoff's export-to-import wall (ms), the
        # serve.handoff_ms gauge's values, most recent last.
        self.handoff_ms: Deque[float] = collections.deque(maxlen=4096)
        self.stats: Dict[str, Any] = {
            "submitted": 0, "dispatched": 0, "requeued": 0, "completed": 0,
            "rejected": 0, "cancelled": 0, "deadline": 0,
            "quarantined": 0, "unquarantined": 0, "splice_mismatch": 0,
            "breaker_open": 0, "rejoins": 0, "brownout": 0,
            "handoffs": 0, "migrations": 0, "directory_hits": 0,
        }
        for r in replicas or []:
            self.add_replica(r, start=False)

    # -- fleet membership --------------------------------------------------

    def add_replica(self, replica: Replica, *, start: bool = True,
                    threaded: bool = True) -> Replica:
        """Register (and by default start) one replica. A rid whose
        circuit breaker is open is refused — a crash-looping replica
        does not slip back in through the membership door."""
        b = self._breakers.get(replica.rid)
        if b is not None and b.get("open"):
            raise RuntimeError(
                f"replica {replica.rid} breaker is open "
                f"(restart budget exhausted)"
            )
        replica.chaos = self.chaos
        self.replicas.append(replica)
        obs.point("fleet.replica_add", replica=replica.rid)
        if start and replica.state == "new":
            replica.start(threaded=threaded)
        return replica

    def _replica(self, rid: int) -> Replica:
        for r in self.replicas:
            if r.rid == rid:
                return r
        raise KeyError(f"no replica {rid}")

    def next_rid(self) -> int:
        """A fresh replica id (controller scale-up). The breaker
        ledger counts as used — a breaker-open rid is never re-minted
        for a new replica."""
        used = [r.rid for r in self.replicas] + list(self._breakers)
        return max(used, default=-1) + 1

    def drain_replica(self, rid: int) -> int:
        """Graceful drain: stop placing onto ``rid``, pull its queued
        requests back into the tenant queues (front — they keep their
        place), let running streams finish there. Returns the number of
        requests re-routed."""
        replica = self._replica(rid)
        replica.begin_drain()
        return self._requeue_from(replica, running_too=False,
                                  cause="migration")

    def fail_replica(self, rid: int, error: Optional[BaseException] = None
                     ) -> int:
        """Treat ``rid`` as faulted NOW (health probe / operator /
        heartbeat monitor): stop its pump and re-route queued AND
        running requests. Double-fault-safe: a second call on an
        already-faulted replica only re-sweeps leftover work (it never
        re-stops, re-classifies, or double-requeues). A pump that will
        not join (hung thread) is *detached* by ``Replica.stop`` — a
        ``fleet.thread_leaked`` point, never a silent zombie still
        mutating the server (the rejoin path rebuilds engine+server, so
        a waking zombie can only touch the abandoned objects)."""
        replica = self._replica(rid)
        already = replica.state == "faulted" and replica._abandon.is_set()
        replica._abandon.set()  # do not drain: we re-route instead
        if not already:
            replica.stop(timeout=self.config.fault_join_s)
        if replica.state != "faulted":
            replica.state = "faulted"
            replica.fault = error
            from distributeddeeplearning_tpu_torch.faults import EXIT_HUNG

            replica.exit_code = EXIT_HUNG
            obs.point(
                "fleet.replica_fault", replica=rid,
                error=repr(error) if error else "declared_failed",
                exit_code=replica.exit_code, retryable=True,
            )
        if self.directory is not None:
            # The dead replica's blocks are gone with its engine:
            # re-home each entry to a surviving holder or drop it.
            # Payload-backed adoption keeps working either way.
            self.directory.drop_replica(rid)
        return self._requeue_from(replica, running_too=True, cause="splice")

    def quarantine_replica(self, rid: int, **labels: Any) -> int:
        """Straggler quarantine: stop placing onto ``rid`` and hedge
        re-route its queued AND running requests through the splice
        path — the replica stays alive (still pumping, on probation for
        ``quarantine_ticks`` router ticks) so a transient stall heals
        without a rebuild. The pump is paused at a tick boundary before
        running slots are evicted (``take_running`` is only safe with
        the pump parked); a pump that never acknowledges the pause is
        hung, and the monitor escalates to :meth:`fail_replica`."""
        replica = self._replica(rid)
        if replica.quarantined:
            return 0
        if not replica.pause(timeout=self.config.fault_join_s):
            return self.fail_replica(
                rid, TimeoutError("pump unresponsive to quarantine pause")
            )
        replica.quarantined = True
        replica.quarantine_until = self._ticks + self.config.quarantine_ticks
        replica.straggle_ticks = 0
        self.stats["quarantined"] += 1
        obs.point("fleet.quarantine", replica=rid, **labels)
        moved = self._requeue_from(replica, running_too=True, cause="hedge")
        replica.resume()
        return moved

    def remove_replica(self, rid: int) -> Replica:
        """Take a drained/faulted replica out of the fleet (its queued
        and — when faulted — running work must already be re-routed;
        this asserts that, it does not silently drop)."""
        replica = self._replica(rid)
        if replica.state not in ("drained", "faulted", "removed"):
            raise RuntimeError(
                f"replica {rid} is {replica.state}; drain or fail it first"
            )
        if replica.server is not None and (
            replica.server.queued_count
            or (replica.state == "faulted" and replica.server.active_count)
        ):
            raise RuntimeError(
                f"replica {rid} still holds un-rerouted requests"
            )
        replica.stop(timeout=self.config.fault_join_s)
        replica.state = "removed"
        replica.release()
        self.replicas = [r for r in self.replicas if r.rid != rid]
        if self.directory is not None:
            self.directory.drop_replica(rid)
        obs.point("fleet.replica_remove", replica=rid)
        return replica

    def rejoin_replica(self, replica_or_rid, *, threaded: Optional[bool]
                       = None) -> Replica:
        """Bring a drained/faulted/removed replica back into rotation
        (``Replica.rejoin`` rules: non-retryable faults refuse).

        Every post-fault rejoin burns the replica's restart budget
        (``SERVE_REPLICA_MAX_RESTARTS``, launch_supervised semantics):
        budget exhausted or breaker already open → refused. An
        already-ready replica (the monitor's auto-heal beat a manual
        call) is returned unchanged."""
        replica = (
            replica_or_rid if isinstance(replica_or_rid, Replica)
            else self._replica(replica_or_rid)
        )
        b = self._breakers.get(replica.rid)
        if b is not None and b["open"]:
            raise RuntimeError(
                f"replica {replica.rid} breaker is open "
                f"(restart budget exhausted)"
            )
        if replica.state in ("ready", "starting", "draining"):
            return replica  # auto-heal already brought it back
        if replica.state == "faulted":
            b = self._breaker(replica.rid)
            if b["attempts"] >= self.config.max_restarts:
                self._open_breaker(replica, b)
                raise RuntimeError(
                    f"replica {replica.rid} restart budget exhausted "
                    f"({b['attempts']}/{self.config.max_restarts}); "
                    f"breaker opened"
                )
            b["attempts"] += 1
            b["pending"] = False
            self.stats["rejoins"] += 1
        replica.rejoin(threaded=threaded)
        if replica not in self.replicas:
            self.replicas.append(replica)
        return replica

    def _breaker(self, rid: int) -> Dict[str, Any]:
        return self._breakers.setdefault(
            rid, {"attempts": 0, "next_t": 0.0, "pending": False,
                  "open": False},
        )

    def _open_breaker(self, replica: Replica, b: Dict[str, Any]) -> None:
        """Budget exhausted (or non-retryable fault): open the circuit,
        re-route whatever the replica still holds, take it out of the
        fleet. The breaker ledger outlives the removal, so the rid can
        never slip back in (``add_replica``/``rejoin_replica`` refuse)."""
        b["open"] = True
        self.last_breaker_tick = self._ticks
        self.stats["breaker_open"] += 1
        obs.point(
            "fleet.breaker_open", replica=replica.rid,
            attempts=b["attempts"], retryable=replica.retryable,
            exit_code=replica.exit_code,
        )
        self._requeue_from(replica, running_too=True, cause="splice")
        if any(r.rid == replica.rid for r in self.replicas):
            self.remove_replica(replica.rid)

    def _requeue_from(self, replica: Replica, *, running_too: bool,
                      cause: str = "migration") -> int:
        """Reclaim a replica's requests and put them back at the front
        of their tenant queues, preserving relative submit order.
        ``cause`` (hedge|splice|migration) rides each handle to the
        next dispatch, which emits the re-route child span under the
        request's trace."""
        subs = replica.reclaim_queued()
        if replica.server is not None and replica.server.handoff:
            # Pending prefill exports are pure host data: they outlive
            # this replica (fault or drain alike), so hand them to the
            # handoff queue instead of replaying the prefill — the
            # lossless half of "a prefill replica dying mid-handoff".
            alive = replica.state not in ("faulted", "removed")
            for sub, state in replica.server.take_handoffs():
                fh = self._fh_for_sub(sub)
                if fh is not None:
                    self._publish_handoff(
                        replica.rid, fh, state, resident=alive
                    )
                    self._pending_handoffs.append(
                        (fh, state, replica.rid, "handoff")
                    )
        if running_too and replica.server is not None:
            # The replica's private event stream must see the
            # trace_close for the running work being taken from it.
            with obs.bound_bus(replica.bus):
                subs += replica.server.take_running()
        moved = 0
        now = time.monotonic()
        with self._lock:
            sub_ids = {id(s) for s in subs}
            victims = [
                fh for fh in self._inflight
                if fh._sub is not None and id(fh._sub) in sub_ids
            ]
            # oldest first so appendleft() restores submit order
            for fh in sorted(victims, key=lambda f: f.id, reverse=True):
                self._inflight.remove(fh)
                fh._detach()
                fh._reroute_cause = cause
                fh._requeued_t = now
                fh._reroute_from = replica.rid
                self._tenant(fh.tenant).queue.appendleft(fh)
                moved += 1
                self.stats["requeued"] += 1
        if moved:
            obs.counter("fleet.requeued", moved, replica=replica.rid)
        return moved

    # -- client side -------------------------------------------------------

    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(name, 1.0)
        return t

    def set_tenant_weight(self, name: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self._tenant(name).weight = float(weight)

    def submit(self, request: Request, tenant: str = DEFAULT_TENANT
               ) -> FleetHandle:
        """Enqueue one tenant-tagged request. Backpressure
        (:class:`QueueFull`) when the fleet-wide backlog is at
        capacity. Validation is eager against any ready replica so a
        malformed request fails the caller, not the dispatch loop."""
        if self._closed:
            raise RuntimeError("router is closed")
        now = time.monotonic()
        if tenant in self._shed_tenants:
            # Brownout shed: a distinct, client-visible outcome — the
            # handle finishes as "brownout" immediately, never a silent
            # drop and never a generic QueueFull masquerade. The shed
            # counter is the trace's terminal marker (cause=brownout).
            fh = FleetHandle(request, tenant, next(self._ids), now)
            self.stats["brownout"] += 1
            with obs.trace_ctx(fh.trace, cause="brownout"):
                obs.counter("serve.brownout_shed", tenant=tenant)
            fh._finish("brownout")
            return fh
        for r in self.replicas:
            if r.placeable:
                r.engine.validate_spec(request.spec())
                break
        with self._lock:
            backlog = sum(len(t.queue) for t in self._tenants.values())
            if backlog >= self.config.queue_depth:
                self.stats["rejected"] += 1
                obs.counter("serve.rejected", tenant=tenant)
                raise QueueFull(
                    f"fleet queue at capacity ({self.config.queue_depth})"
                )
            fh = FleetHandle(request, tenant, next(self._ids), now)
            self._tenant(tenant).queue.append(fh)
            self.stats["submitted"] += 1
        # The trace's fleet-level admission point (req labels let the
        # trace reconstructor name the fleet request id).
        with obs.trace_ctx(fh.trace):
            obs.counter("fleet.submitted", tenant=tenant, req=fh.id)
        return fh

    # -- pump --------------------------------------------------------------

    def step(self, now: Optional[float] = None) -> bool:
        """One router tick: chaos clock → monitor sweep (heartbeat,
        stragglers, splice integrity, breaker auto-heal) → health sweep
        → brownout ladder → finish sweep → DRR dispatch → inline
        replica pumps → fleet gauges. Returns True while work remains
        anywhere in the fleet."""
        now = time.monotonic() if now is None else now
        self._ticks += 1
        if self.chaos is not None:
            self._chaos_tick(now)
        self._monitor_sweep(now)
        self._health_sweep()
        if self.brownout is not None:
            self.brownout.tick(self, now)
        self._finish_sweep()
        self._dispatch(now)
        busy = False
        for r in self.replicas:
            if not r.threaded:
                busy = r.pump_once() or busy
        self._handoff_sweep(time.monotonic())
        self._finish_sweep()
        with self._lock:
            backlog = sum(len(t.queue) for t in self._tenants.values())
            inflight = len(self._inflight)
        self._emit_gauges(backlog, inflight)
        return bool(
            backlog or inflight or busy or self._pending_handoffs
        )

    def _chaos_tick(self, now: float) -> None:
        """Activate the drill directives due at this tick: pump verbs
        arm on their replica; ``corrupt`` picks its victim (the
        lowest-id running handle with a delivered prefix — the replay
        window the flip must land in), arms the one-shot flip, and
        hedge re-routes the victim's replica so the replay happens."""
        for f in self.chaos.due(self._ticks):
            if f.kind == "corrupt":
                with self._lock:
                    running = sorted(
                        (
                            fh for fh in self._inflight
                            if fh.new_tokens and fh.replica_id is not None
                        ),
                        key=lambda fh: (fh.replica_id != f.replica, fh.id),
                    )
                if not running:
                    # nothing replayable yet: re-queue the directive for
                    # the next tick rather than dropping the drill verb
                    # (victims on the named replica are preferred; any
                    # running handle with a delivered prefix will do —
                    # the flip rides the handle, not the replica).
                    self.chaos.defer(f)
                    continue
                fh = running[0]
                fh._chaos = self.chaos
                self.chaos.arm_corrupt(f, fh.id)
                self.quarantine_replica(
                    fh.replica_id, reason="chaos_corrupt_hedge"
                )
            else:
                self.chaos.arm_pump(f, now)

    def _monitor_sweep(self, now: float) -> None:
        """The health monitor (docs/ROBUSTNESS.md serving failure
        model): four checks, all tick-deterministic.

        1. **Heartbeat** — a threaded pump whose heartbeat is stale past
           ``heartbeat_timeout_s`` while the replica holds work is hung
           (alive-but-silent): hard-fault, re-route, detach the thread.
        2. **Stragglers** — a replica whose busy-tick EWMA exceeds
           ``straggler_factor`` x the fleet median for
           ``straggler_ticks`` consecutive sweeps is quarantined; the
           probation expires after ``quarantine_ticks`` router ticks.
        3. **Splice integrity** — a handle whose replay diverged from
           its delivered prefix hard-faults the divergent replica and
           replays from the deterministic prefix (the corrupt
           detect-and-heal path).
        4. **Breaker auto-heal** — faulted retryable replicas rejoin
           after ``restart_backoff_s x 2^attempt``; budget exhausted or
           non-retryable → breaker opens, replica removed.
        """
        cfg = self.config
        for r in list(self.replicas):
            if (
                r.threaded and r.state in ("ready", "draining")
                and r.server is not None and r.heartbeat_t is not None
                and now - r.heartbeat_t > cfg.heartbeat_timeout_s
                and (r.server.active_count or r.server.queued_count)
            ):
                self.fail_replica(
                    r.rid,
                    TimeoutError(
                        f"pump heartbeat stale "
                        f"{now - r.heartbeat_t:.2f}s"
                    ),
                )
        sampled = [
            r for r in self.replicas
            if r.state == "ready" and r.tick_samples >= 3
        ]
        if len(sampled) >= 2:
            ewmas = sorted(r.tick_ewma for r in sampled)
            median = ewmas[(len(ewmas) - 1) // 2]
            for r in sampled:
                if r.quarantined:
                    continue
                if median > 0 and r.tick_ewma > cfg.straggler_factor * median:
                    r.straggle_ticks += 1
                    if r.straggle_ticks >= cfg.straggler_ticks:
                        self.quarantine_replica(
                            r.rid,
                            ewma_ms=round(r.tick_ewma * 1e3, 3),
                            median_ms=round(median * 1e3, 3),
                        )
                else:
                    r.straggle_ticks = 0
        for r in self.replicas:
            if r.quarantined and self._ticks >= r.quarantine_until:
                r.quarantined = False
                r.reset_latency()
                self.stats["unquarantined"] += 1
                obs.point("fleet.unquarantine", replica=r.rid)
        with self._lock:
            divergent = [fh for fh in self._inflight if fh._divergent]
        for fh in divergent:
            rid = fh.replica_id
            self.stats["splice_mismatch"] += 1
            with obs.trace_ctx(fh.trace, cause="splice"):
                obs.point("fleet.splice_mismatch", req=fh.id, replica=rid)
            # The delivered prefix is immutable (already streamed); the
            # divergent attempt is the corrupt one. Heal: hard-fault
            # the replica producing it and replay from the prefix.
            fh._divergent = False
            fh.restart_consistent = True
            if rid is not None and any(r.rid == rid for r in self.replicas):
                self.fail_replica(
                    rid, SpliceMismatch(f"request {fh.id} replay diverged")
                )
            elif fh._sub is not None:
                # replica already gone: just re-queue the handle itself
                with self._lock:
                    if fh in self._inflight:
                        self._inflight.remove(fh)
                        fh._reroute_from = fh.replica_id
                        fh._detach()
                        fh._reroute_cause = "splice"
                        fh._requeued_t = time.monotonic()
                        self._tenant(fh.tenant).queue.appendleft(fh)
                        self.stats["requeued"] += 1
        for r in list(self.replicas):
            if r.state != "faulted":
                continue
            b = self._breaker(r.rid)
            if b["open"]:
                continue
            if not r.retryable or b["attempts"] >= cfg.max_restarts:
                self._open_breaker(r, b)
                continue
            if not b["pending"]:
                b["pending"] = True
                b["next_t"] = now + cfg.restart_backoff_s * (
                    2 ** b["attempts"]
                )
                obs.point(
                    "fleet.rejoin_scheduled", replica=r.rid,
                    attempt=b["attempts"] + 1,
                    backoff_s=round(b["next_t"] - now, 3),
                )
            elif now >= b["next_t"]:
                try:
                    self.rejoin_replica(r.rid)
                except RuntimeError:
                    pass  # breaker opened (budget raced) — ledger has it

    def _health_sweep(self) -> None:
        for r in list(self.replicas):
            if r.state == "faulted" and (
                r.server is not None
                and (r.server.queued_count or r.server.active_count)
            ):
                # the pump is dead: reclaim everything it held
                self._requeue_from(r, running_too=True, cause="splice")

    def _finish_sweep(self) -> None:
        with self._lock:
            inflight = list(self._inflight)
        for fh in inflight:
            sub = fh._sub
            if sub is None:
                continue
            if fh._divergent:
                # splice mismatch pending: the monitor sweep re-routes
                # this handle — finishing it now would deliver a stream
                # cut at the divergence point.
                continue
            if sub.status == "requeued":
                # reclaim raced us (drain path) — the requeue already
                # moved fh back to its tenant queue; nothing to do here.
                continue
            if not sub.done.is_set():
                continue
            reason = sub.finish_reason or "done"
            with self._lock:
                if fh in self._inflight:
                    self._inflight.remove(fh)
            t = self._tenant(fh.tenant)
            if reason in ("eos", "length"):
                t.completed += 1
                t.tokens_done += len(fh.new_tokens)
                self.stats["completed"] += 1
                with obs.trace_ctx(fh.trace):
                    obs.counter("fleet.completed", tenant=fh.tenant)
                    obs.counter(
                        "fleet.tenant_tokens", len(fh.new_tokens),
                        tenant=fh.tenant,
                    )
            else:
                key = "cancelled" if reason == "cancelled" else "deadline"
                self.stats[key] += 1
            fh._finish(reason)

    def _reap_queued(self, t: _Tenant, now: float) -> None:
        finished: List = []
        with self._lock:  # submit() appends under the same lock
            keep: Deque[FleetHandle] = collections.deque()
            for fh in t.queue:
                if fh._cancel:
                    finished.append((fh, "cancelled"))
                elif fh.expired(now):
                    finished.append((fh, "deadline"))
                else:
                    keep.append(fh)
            t.queue = keep
        for fh, reason in finished:
            key = "cancelled" if reason == "cancelled" else "deadline"
            self.stats[key] += 1
            # Trace-stamped: the router-side terminal marker for a
            # request reaped before (or between) replica attempts.
            with obs.trace_ctx(fh.trace):
                obs.counter(
                    "serve.cancelled" if reason == "cancelled"
                    else "serve.evicted_deadline",
                    tenant=t.name,
                )
            fh._finish(reason)

    def _dispatch(self, now: float) -> None:
        """Deficit round robin with a cursor that persists across ticks.

        Classic DRR semantics (the properties the fairness oracle
        pins): the cursor banks ``quantum × weight`` exactly once per
        *fresh visit* to a backlogged tenant, serves that tenant until
        its deficit no longer covers the head request's token cost (or
        its queue empties), then advances. Crucially, when fleet
        capacity runs out **mid-service**, the cursor stays put and
        resumes the same tenant — without banking again — on the next
        tick; otherwise a fleet whose slots free up one at a time would
        hand every trickle slot to whichever tenant the scan happened
        to start at, and weights would stop meaning anything. A head
        request that no replica can admit ends the tick the same way:
        counted free slots can be a replica's slot that is still
        prefilling (popped from its queue, not yet running, its KV
        blocks taken), and moving on from it would bank fresh quanta
        for every tenant on each tick it lasts. A tenant that empties
        its queue forfeits its deficit (no credit hoarding while
        idle)."""
        with self._lock:
            tenants = sorted(self._tenants.values(), key=lambda t: t.name)
        for t in tenants:
            self._reap_queued(t, now)
        if not any(t.queue for t in tenants):
            for t in tenants:
                t.deficit = 0.0
            return
        # Admission capacity = slots that can PREFILL. Decode-pool
        # replicas never take submissions (their work arrives through
        # the handoff sweep), so they are invisible here; adoptions
        # bypass this budget entirely (no prefill slot is consumed).
        capacity = sum(
            r.free_slot_count() for r in self.replicas
            if r.placeable and r.pool != "decode"
        )
        idle_visits = 0
        while capacity > 0 and idle_visits <= len(tenants):
            t = tenants[self._drr_cursor % len(tenants)]
            if not t.queue:
                t.deficit = 0.0
                self._drr_cursor += 1
                self._drr_fresh = True
                idle_visits += 1
                continue
            if self._drr_fresh:
                t.deficit += self.config.quantum * t.weight
                self._drr_fresh = False
            served = 0
            blocked = False
            while t.queue and capacity > 0:
                fh = t.queue[0]
                cost = float(fh.request.max_new_tokens)
                if t.deficit < cost:
                    break
                if self._try_adopt(fh, now):
                    # Directory hit: the stream was seated straight on
                    # a decode replica (or finished outright) — no
                    # prefill slot consumed, so `capacity` is untouched.
                    with self._lock:
                        t.queue.popleft()
                    t.deficit -= cost
                    served += 1
                    continue
                replica = self._place(fh)
                if replica is None:
                    blocked = True  # no replica can admit this request
                    break
                with self._lock:
                    t.queue.popleft()
                t.deficit -= cost
                self._dispatch_to(replica, fh)
                capacity -= 1
                served += 1
            if blocked or (capacity <= 0 and t.queue):
                return  # resume THIS tenant next tick (cursor stays)
            # service ended on its own terms: move on
            if not t.queue:
                t.deficit = 0.0
            self._drr_cursor += 1
            self._drr_fresh = True
            idle_visits = 0 if served else idle_visits + 1

    def _place(self, fh: FleetHandle) -> Optional[Replica]:
        spec = fh.request.spec()
        candidates = [
            r for r in self.replicas
            if r.pool != "decode" and r.placeable and r.can_take(spec)
        ]
        if not candidates:
            return None
        mode = self.config.placement
        if mode == "rr":
            self._rr_cursor += 1
            return candidates[self._rr_cursor % len(candidates)]
        if mode == "affinity":
            hits = [
                (r.prefix_hit_blocks(fh.request.prompt), r)
                for r in candidates
            ]
            best = max(h for h, _ in hits)
            if best > 0:
                candidates = [r for h, r in hits if h == best]
                if len(candidates) == 1:
                    return candidates[0]
        # least-loaded: most free capacity wins (slot + block fractions)
        def score(r: Replica) -> float:
            ld = r.load()
            return ld["free_slots"] + ld["free_blocks"]

        return max(candidates, key=score)

    def _dispatch_to(self, replica: Replica, fh: FleetHandle) -> None:
        if self.directory is not None and replica.pool == "prefill":
            if (
                replica.server is not None and replica.engine is not None
                and replica.engine.prefix_cache
            ):
                # Arm pin-at-export before any request reaches the
                # server: the pump pins a greedy export's full prefix
                # blocks on its own thread, so every block the
                # directory maps stays resident (never a router-thread
                # allocator mutation racing an eviction).
                replica.server.handoff_pin = True
            if self.config.prefetch:
                self._chain_prefetch(replica, fh)
        max_new = fh.request.max_new_tokens
        if self._brownout_max_new is not None:
            # Brownout cap applies at dispatch (new placements only —
            # running streams keep their budget). Replays of a capped
            # request use the same cap via the unchanged fh.request, so
            # the splice contract is unaffected.
            max_new = min(max_new, self._brownout_max_new)
        req = dataclasses.replace(
            fh.request,
            max_new_tokens=max_new,
            on_token=lambda _h, toks, fh=fh: fh._ingest(toks),
            # The trace rides the Request across the router→replica
            # thread boundary (thread-locals do not), so every attempt
            # keeps the original request's causal identity.
            trace=fh.trace,
            # fleet-level deadline already tracked on the FleetHandle;
            # the remaining budget rides to the replica so running
            # streams still get evicted there.
            deadline_ms=(
                None if fh._deadline_t is None
                else max((fh._deadline_t - time.monotonic()) * 1e3, 1.0)
            ),
        )
        sub = replica.submit(req)
        fh._attach(sub, replica.rid)
        with self._lock:
            self._inflight.append(fh)
        self.stats["dispatched"] += 1
        cause = fh._reroute_cause
        with obs.trace_ctx(fh.trace, cause=cause):
            if cause is not None:
                # The re-route child span, linked to the parent trace:
                # covers the requeue→re-dispatch window so the wall a
                # chaos-plane intervention cost the request is an
                # attributed phase, not an unexplained gap.
                t_rq = fh._requeued_t
                dur = 0.0 if t_rq is None else max(
                    time.monotonic() - t_rq, 0.0
                )
                obs.span_event(
                    "fleet.reroute", dur, t=t_rq, req=fh.id,
                    replica=replica.rid, src=fh._reroute_from,
                    attempt=fh.attempts,
                )
            obs.counter("fleet.dispatched", tenant=fh.tenant,
                        replica=replica.rid)
        fh._reroute_cause = None
        fh._requeued_t = None
        fh._reroute_from = None

    # -- disaggregation: handoff, directory, migration ---------------------

    def _fh_for_sub(self, sub: RequestHandle) -> Optional[FleetHandle]:
        with self._lock:
            for fh in self._inflight:
                if fh._sub is sub:
                    return fh
        return None

    def _publish_handoff(self, rid: int, fh: FleetHandle,
                         state: Dict[str, Any], *,
                         resident: bool = True) -> None:
        """Publish a greedy prefill export into the fleet directory.
        ``resident=False`` (the exporter is faulted) publishes payload
        only — the directory must never map blocks on a dead engine."""
        if self.directory is None or float(state["temp"]) != 0.0:
            return
        bids = state.get("pinned", []) if resident else []
        self.directory.publish(
            rid, fh.request.prompt, bids, state["payload"],
            first_token=int(state["token"]),
            block_size=int(state["block_size"]),
        )

    def _chain_prefetch(self, replica: Replica, fh: FleetHandle) -> None:
        """Directory chain prefetch: when the fleet holds more leading
        full blocks of this prompt than ``replica`` does locally, seed
        them into its prefix cache before the submit — the prefill then
        computes only the divergent suffix (prefill-once-per-fleet for
        shared prefixes, not just identical prompts)."""
        eng = replica.engine
        if eng is None or eng.allocator is None or not eng.prefix_cache:
            return
        n, ent, payload = self.directory.lookup_chain(
            fh.request.prompt, eng.block_size
        )
        if ent is None or n < 1:
            return
        if replica.prefix_hit_blocks(fh.request.prompt) >= n:
            return
        prompt = np.asarray(fh.request.prompt, np.int32).reshape(-1)
        seeded = replica.inject_prefix(
            prompt[: n * eng.block_size], payload
        )
        if seeded:
            self.stats["directory_hits"] += 1
            with obs.trace_ctx(fh.trace):
                obs.counter(
                    "serve.directory_hits", req=fh.id, kind="prefetch",
                    blocks=seeded,
                )

    def _try_adopt(self, fh: FleetHandle, now: float) -> bool:
        """Fleet-wide prefix directory fast path: an identical greedy
        prompt already prefilled somewhere in the fleet is ADOPTED —
        decode state transplanted straight from the directory entry
        onto a decode replica, zero prefill programs run. Returns True
        when the handle was seated (or finished outright); False falls
        through to normal placement."""
        if self.directory is None or fh.new_tokens or fh._cancel:
            return False
        req = fh.request
        if float(req.temperature) != 0.0:
            return False
        ent = self.directory.lookup(req.prompt)
        if ent is None:
            return False
        first = int(ent["first_token"])
        eos = -1 if req.eos_token is None else int(req.eos_token)
        if first == eos or req.max_new_tokens <= 1:
            # The adopted stream is already complete: deliver the
            # deterministic first token and finish locally.
            self.directory.adopt(req.prompt)
            self.stats["directory_hits"] += 1
            with obs.trace_ctx(fh.trace):
                obs.counter(
                    "serve.directory_hits", req=fh.id, kind="adopt"
                )
            fh._ingest([first])
            self._complete_local(fh, "eos" if first == eos else "length")
            return True
        bs = int(ent["block_size"])
        t = int(np.asarray(req.prompt).reshape(-1).shape[0])
        # Same budget prefill would have allocated (decode-pool engines
        # run spec_k=0): positions 0 .. t + max_new - 2.
        need = -(-(t + int(req.max_new_tokens) - 1) // bs)
        state = {
            "block_size": bs,
            "n_blocks": need,
            "blocks": [],
            "written": t,
            "token": first,
            "temp": 0.0,
            "top_k": 0,
            "top_p": 0.0,
            "eos": eos,
            "ladder": None,
            "cursor": 1,
            "payload": ent["payload"],
            "handoff_t": now,
        }
        dst = self._decode_target(state)
        if dst is None:
            return False  # no decode room: the prefill path keeps liveness
        self.directory.adopt(req.prompt)
        self.stats["directory_hits"] += 1
        with obs.trace_ctx(fh.trace):
            obs.counter("serve.directory_hits", req=fh.id, kind="adopt")
        fh._ingest([first])
        if not self._import_to(
            dst, fh, state, cause="handoff", src=int(ent["owner"]), now=now
        ):
            # Lost the room mid-import. The delivered first token is
            # safe: a from-scratch dispatch re-verifies it (splice).
            return False
        return True

    def _complete_local(self, fh: FleetHandle, reason: str) -> None:
        """Finish a handle the router itself completed (adoption edge
        cases) with exactly the accounting ``_finish_sweep`` does."""
        with self._lock:
            if fh in self._inflight:
                self._inflight.remove(fh)
        t = self._tenant(fh.tenant)
        t.completed += 1
        t.tokens_done += len(fh.new_tokens)
        self.stats["completed"] += 1
        with obs.trace_ctx(fh.trace):
            obs.counter("fleet.completed", tenant=fh.tenant)
            obs.counter(
                "fleet.tenant_tokens", len(fh.new_tokens), tenant=fh.tenant
            )
        fh._finish(reason)

    def _handoff_sweep(self, now: float) -> None:
        """Collect prefill exports, publish greedy ones to the
        directory, and seat every pending export on a decode replica.
        An export with no room retries next tick — backpressure, never
        a drop; ``_requeue_from`` feeds this same queue when a prefill
        replica faults mid-handoff (the export is host data and
        outlives its producer)."""
        if not self.config.disagg:
            return
        for r in self.replicas:
            if r.pool != "prefill" or r.server is None:
                continue
            for sub, state in r.server.take_handoffs():
                fh = self._fh_for_sub(sub)
                if fh is None:
                    continue  # handle already finished: drop the export
                self._publish_handoff(r.rid, fh, state)
                self._pending_handoffs.append(
                    (fh, state, r.rid, "handoff")
                )
                self.stats["handoffs"] += 1
        retry: Deque[Any] = collections.deque()
        while self._pending_handoffs:
            fh, state, src, cause = self._pending_handoffs.popleft()
            if fh.done.is_set():
                continue
            if fh._cancel:
                self._drop_handoff(fh)
                continue
            if fh.expired(now):
                # No replica owns a parked export, so the router is
                # the one enforcing its deadline.
                self._drop_handoff(fh, reason="deadline")
                continue
            dst = self._decode_target(state)
            if dst is None or not self._import_to(
                dst, fh, state, cause=cause, src=src, now=now
            ):
                retry.append((fh, state, src, cause))
        self._pending_handoffs = retry

    def _drop_handoff(self, fh: FleetHandle,
                      reason: str = "cancelled") -> None:
        """Cancel/deadline-mid-handoff: the exported blocks were
        already released at export and the payload is host data, so
        dropping the state leaks nothing — only the handle needs its
        terminal accounting."""
        with self._lock:
            if fh in self._inflight:
                self._inflight.remove(fh)
        if not fh.done.is_set():
            key = "cancelled" if reason == "cancelled" else "deadline"
            self.stats[key] += 1
            with obs.trace_ctx(fh.trace):
                obs.counter(
                    "serve.cancelled" if reason == "cancelled"
                    else "serve.evicted_deadline",
                    tenant=fh.tenant,
                )
            fh._finish(reason)

    def _decode_target(self, state: Dict[str, Any],
                       exclude: Optional[int] = None) -> Optional[Replica]:
        """Best decode-capable replica that can seat ``state`` right
        now (free slot + allocatable blocks), least-loaded first."""
        cands = [
            r for r in self.replicas
            if r.pool in ("decode", "mixed") and r.placeable
            and r.rid != exclude and r.engine is not None
            and r.engine.can_import(state)
        ]
        if not cands:
            return None

        def score(r: Replica) -> float:
            ld = r.load()
            return ld["free_slots"] + ld["free_blocks"]

        return max(cands, key=score)

    def _import_to(self, replica: Replica, fh: FleetHandle,
                   state: Dict[str, Any], *, cause: str,
                   src: Optional[int], now: float) -> bool:
        """Seat an exported slot state on ``replica`` as a RUNNING
        stream and splice the fleet handle onto it. The pump is parked
        around the import (slot + pool mutation must not race a
        stepping pump); the new attempt is seeded with the delivered
        prefix and attached at ``seen=len(prefix)`` so it emits only
        fresh tokens. Returns False when the import lost its room —
        the caller retries elsewhere or later."""
        if replica.threaded and not replica.pause(
            timeout=self.config.fault_join_s
        ):
            return False
        try:
            prior = list(fh.new_tokens)
            req = dataclasses.replace(
                fh.request,
                on_token=lambda _h, toks, fh=fh: fh._ingest(toks),
                trace=fh.trace,
                deadline_ms=(
                    None if fh._deadline_t is None
                    else max(
                        (fh._deadline_t - time.monotonic()) * 1e3, 1.0
                    )
                ),
            )
            try:
                with obs.bound_bus(replica.bus):
                    sub = replica.server.import_running(
                        req, state, prior_tokens=prior
                    )
            except (RuntimeError, BlockPoolExhausted):
                return False
        finally:
            if replica.threaded:
                replica.resume()
        fh._attach(sub, replica.rid, seen=len(prior))
        with self._lock:
            if fh not in self._inflight:
                self._inflight.append(fh)
        dur = max(now - float(state.get("handoff_t", now)), 0.0)
        span = (
            "fleet.migration" if cause == "migration" else "fleet.handoff"
        )
        with obs.trace_ctx(fh.trace, cause=cause):
            obs.span_event(
                span, dur, req=fh.id, replica=replica.rid, src=src,
                attempt=fh.attempts,
            )
            if cause == "migration":
                obs.counter("serve.migrations")
            else:
                obs.gauge("serve.handoff_ms", round(dur * 1e3, 3))
                self.handoff_ms.append(dur * 1e3)
        return True

    def migrate(self, src_rid: int, dst_rid: Optional[int] = None,
                *, max_streams: int = 1) -> int:
        """Scheduled live KV-block migration (docs/SERVING.md): move up
        to ``max_streams`` running streams off replica ``src_rid`` as
        state transplants — export under a parked pump, import on
        ``dst_rid`` (or the best-fit decode-capable replica), splice
        bitwise at the exact delivered token, zero drops. The splice
        machinery that heals faults, now a first-class operation:
        defragment a pool, empty a replica before drain, rebalance.
        A stream that finds no import room falls back to the
        requeue-replay path (still lossless — the splice verifies the
        replayed prefix). Returns the number of streams moved by
        transplant. Paged, non-speculative engines only
        (``export_slot`` contract)."""
        if dst_rid is not None and dst_rid == src_rid:
            raise ValueError("migrate needs distinct src and dst replicas")
        src = self._replica(src_rid)
        if src.server is None:
            return 0
        if src.threaded and not src.pause(
            timeout=self.config.fault_join_s
        ):
            raise TimeoutError(
                f"replica {src_rid} pump unresponsive to migrate pause"
            )
        moved = 0
        now = time.monotonic()
        try:
            with self._lock:
                live = [
                    fh for fh in self._inflight
                    if fh.replica_id == src_rid and fh._sub is not None
                    and not fh.done.is_set()
                ]
            for fh in live[:max_streams]:
                with obs.bound_bus(src.bus):
                    state = src.server.export_running(fh._sub)
                if state is None:
                    continue  # not running here (handoff-parked, raced)
                dst = (
                    self._replica(dst_rid) if dst_rid is not None
                    else self._decode_target(state, exclude=src_rid)
                )
                if dst is not None and self._import_to(
                    dst, fh, state, cause="migration", src=src_rid,
                    now=now,
                ):
                    moved += 1
                    self.stats["migrations"] += 1
                    continue
                # No destination (or it lost its room): requeue-replay.
                with self._lock:
                    if fh in self._inflight:
                        self._inflight.remove(fh)
                fh._detach()
                fh._reroute_cause = "migration"
                fh._requeued_t = now
                fh._reroute_from = src_rid
                with self._lock:
                    self._tenant(fh.tenant).queue.appendleft(fh)
                    self.stats["requeued"] += 1
        finally:
            if src.threaded:
                src.resume()
        return moved

    def pool_pressure(self, pool: str) -> float:
        """Per-pool autoscale signal (the FleetController's per-pool
        watermarks): prefill pressure is the admission backlog over
        prefill slots, decode pressure is seated streams plus pending
        handoffs over decode slots; both saturate on KV blocks —
        :meth:`pressure` semantics, restricted to one pool."""
        ready = [
            r for r in self.replicas if r.placeable and r.pool == pool
        ]
        slots = sum(r.engine.num_slots for r in ready)
        if pool == "prefill":
            with self._lock:
                demand = sum(
                    len(t.queue) for t in self._tenants.values()
                )
            demand += sum(
                r.server.active_count + r.server.queued_count
                for r in ready
            )
        else:
            demand = len(self._pending_handoffs) + sum(
                r.server.active_count + r.server.queued_count
                for r in ready
            )
        p = demand / max(slots, 1)
        for r in ready:
            a = r.engine.allocator
            if a is not None:
                p = max(p, 1.0 - a.free_count / max(a.capacity, 1))
        return p

    # -- brownout ladder actions (scheduler.BrownoutLadder drives) ---------

    def apply_brownout_stage(self, stage, on: bool, key: int = 0) -> None:
        """Apply (``on=True``) or revert one declared degradation stage
        (docs/ROBUSTNESS.md degradation ladder):

        * ``spec_off`` — suspend speculative decode on every replica
          engine (the plain decode program is already in the closed
          set, so this compiles nothing);
        * ``max_new:N`` — cap ``max_new_tokens`` for newly dispatched
          requests at N;
        * ``shed:K`` — shed the K lowest-weight tenant lanes: queued
          and arriving requests finish with the distinct ``brownout``
          outcome, never silently dropped.

        ``key`` identifies the stage instance so revert releases
        exactly what this stage shed."""
        if stage.kind == "spec_off":
            for r in self.replicas:
                if r.engine is not None:
                    r.engine.spec_suspended = on
        elif stage.kind == "max_new":
            self._brownout_max_new = int(stage.value) if on else None
        elif stage.kind == "shed":
            if on:
                with self._lock:
                    ranked = sorted(
                        (
                            t for t in self._tenants.values()
                            if t.name not in self._shed_tenants
                        ),
                        key=lambda t: (t.weight, t.name),
                    )
                shed = {t.name for t in ranked[: int(stage.value)]}
                self._shed_by_stage[key] = shed
                self._shed_tenants |= shed
                for name in shed:
                    self._flush_shed_lane(name)
            else:
                self._shed_tenants -= self._shed_by_stage.pop(key, set())
        else:
            raise ValueError(f"unknown brownout stage {stage.kind!r}")

    def _flush_shed_lane(self, tenant: str) -> None:
        """Finish every queued request of a newly shed lane with the
        ``brownout`` outcome (running streams are never interrupted —
        shedding relieves *future* load)."""
        with self._lock:
            t = self._tenants.get(tenant)
            victims = list(t.queue) if t is not None else []
            if t is not None:
                t.queue.clear()
                t.deficit = 0.0
        for fh in victims:
            self.stats["brownout"] += 1
            with obs.trace_ctx(fh.trace, cause="brownout"):
                obs.counter("serve.brownout_shed", tenant=tenant)
            fh._finish("brownout")

    # -- autoscale signal --------------------------------------------------

    def pressure(self) -> float:
        """The autoscaling signal: demanded capacity over ready
        capacity. 1.0 = the fleet's slots exactly cover current demand
        (router backlog + replica queues + running streams); above it,
        work is waiting; paged fleets also saturate on KV blocks
        (whichever is scarcer). Derived from the same quantities the
        ``serve.slot_occupancy`` / queue / block-pool rollups carry —
        this is their fleet-level composition."""
        ready = [r for r in self.replicas if r.placeable]
        total_slots = sum(r.engine.num_slots for r in ready)
        with self._lock:
            backlog = sum(len(t.queue) for t in self._tenants.values())
        demand = backlog + sum(
            r.server.active_count + r.server.queued_count for r in ready
        )
        slot_pressure = demand / max(total_slots, 1)
        block_pressure = 0.0
        for r in ready:
            if r.engine.allocator is not None:
                a = r.engine.allocator
                used = 1.0 - a.free_count / max(a.capacity, 1)
                block_pressure = max(block_pressure, used)
        return max(slot_pressure, block_pressure)

    def _emit_gauges(self, backlog: int, inflight: int) -> None:
        p = self.pressure()
        self.last_pressure = p
        obs.gauge("serve.fleet_pressure", round(p, 4))
        obs.gauge(
            "serve.fleet_replicas",
            float(sum(1 for r in self.replicas if r.placeable)),
        )
        obs.gauge("serve.fleet_queued", float(backlog))
        obs.gauge("serve.fleet_active", float(inflight))
        # Health-plane gauges (docs/OBSERVABILITY.md; obs_watch renders
        # them as the fleet-health row).
        obs.gauge(
            "fleet.quarantined",
            float(sum(1 for r in self.replicas if r.quarantined)),
        )
        obs.gauge(
            "fleet.breaker_open",
            float(sum(1 for b in self._breakers.values() if b["open"])),
        )
        obs.gauge(
            "fleet.brownout_stage",
            float(self.brownout.level) if self.brownout is not None else 0.0,
        )
        if self.config.disagg:
            obs.gauge(
                "fleet.prefill_replicas",
                float(sum(
                    1 for r in self.replicas
                    if r.pool == "prefill" and r.placeable
                )),
            )
            obs.gauge(
                "fleet.decode_replicas",
                float(sum(
                    1 for r in self.replicas
                    if r.pool == "decode" and r.placeable
                )),
            )

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """Pump until every submitted request has finished."""
        t0 = time.monotonic()
        while self.step():
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("fleet drain timed out")
            time.sleep(0.0005)

    def serve_forever(self, stop: threading.Event,
                      idle_sleep_s: float = 0.001) -> None:
        while not stop.is_set():
            if not self.step():
                time.sleep(idle_sleep_s)
        self.drain()

    def close(self) -> None:
        """Stop accepting, drain everything, stop every replica pump and
        release its engine (stores, graphs and graph pool)."""
        self._closed = True
        self.drain()
        for r in self.replicas:
            r.stop()
            r.release()

    def tenant_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant accounting (the fairness gate's numerator)."""
        with self._lock:
            return {
                t.name: {
                    "weight": t.weight,
                    "queued": len(t.queue),
                    "completed": t.completed,
                    "tokens_done": t.tokens_done,
                }
                for t in self._tenants.values()
            }

    def fleet_snapshot(self) -> List[Dict[str, Any]]:
        return [r.snapshot() for r in self.replicas]


def build_fleet(
    model,
    params,
    *,
    fleet_config: Optional[FleetConfig] = None,
    serve_config: Optional[ServeConfig] = None,
    max_len: Optional[int] = None,
    obs_dir: Optional[str] = None,
    threaded: bool = True,
    start: bool = True,
    device=None,
) -> Router:
    """Router + N replicas from the env-driven configs (the fleet twin
    of ``Server.build``). ``obs_dir`` defaults to ``$OBS_DIR`` so each
    replica lands its own ``events-p0-s<k>.jsonl`` stream whenever the
    process is capturing events."""
    fcfg = fleet_config or FleetConfig.from_env()
    scfg = serve_config or ServeConfig.from_env()
    if obs_dir is None:
        obs_dir = os.environ.get("OBS_DIR") or None
    router = Router(config=fcfg)
    npre, _ = fcfg.pool_split()
    for k in range(fcfg.replicas):
        pool = "mixed"
        if fcfg.disagg:
            pool = "prefill" if k < npre else "decode"
        router.add_replica(
            Replica(
                k, model, params, scfg, max_len=max_len, obs_dir=obs_dir,
                pool=pool, device=device,
            ),
            start=start, threaded=threaded,
        )
    return router
