"""One serving replica: a warmed SlotEngine + Server on its own pump
(port of ``serving/fleet/replica.py``).

A :class:`Replica` is the fleet's unit of capacity — one compiled slot
pool with its own scheduler, pumped by its own worker thread (or, in
tests and deterministic benches, pumped inline by the router). Two
properties make N of them composable inside one process:

* **Private event stream** — each replica binds its own
  :class:`~distributeddeeplearning_tpu_torch.obs.bus.EventBus` (proc
  ``p<k>-s<rid>`` → ``events-p0-s0.jsonl``, ``events-p0-s1.jsonl``, …)
  around everything its pump runs, via the thread-local binding in
  ``obs/bus.py``. Every existing instrumentation site — scheduler tick
  spans, engine warmup compiles, pool gauges — lands in the replica's
  file untouched, and the tailer / rollup / report machinery renders
  per-replica views for free (``scripts/obs_watch.py``). With no
  ``obs_dir`` the replica stays on the process-global bus.
* **Lifecycle with an exit taxonomy** — ``new → starting → ready →
  draining → drained`` plus ``faulted``/``removed``. A pump that dies
  maps its exception onto the fault exit codes
  (:mod:`distributeddeeplearning_tpu_torch.faults`): a
  ``NonFiniteLossError``-style deterministic failure is non-retryable
  (121 — rejoining would replay it), anything else classifies as a
  retryable crash (125), and :meth:`Replica.retryable` is exactly
  ``classify_exit(rc).retryable`` — the same table the restart
  supervisor uses. The router re-routes a faulted replica's work; a
  retryable replica may :meth:`rejoin` (rebuilding its engine — a
  faulted pool's device state is not trusted).

The health plane (docs/ROBUSTNESS.md serving failure model) rides the
pump: every iteration stamps ``heartbeat_t`` (a hung pump goes stale
and the router hard-faults it), every busy tick feeds the latency EWMA
the straggler detector compares against the fleet median, and the
chaos injector (``SERVE_CHAOS_PLAN``) is consulted at the top of every
tick so fault drills are tick-deterministic. ``stop()`` detaches an
unjoinable thread instead of leaking it silently
(``fleet.thread_leaked``), and a pump *generation* counter guarantees
a detached zombie that later wakes can never pump or drain a rebuilt
server.

On the card each replica's engine runs on ``device`` (default the card)
and its threaded pump makes every launch and copy on a CUDA stream of
its own, so two replicas' device work can overlap; its engine captures
in its worker thread while other replicas keep pumping
(``serving/engine.py``: one capture at a time, ``thread_local`` mode).
The engine takes ownership of the model it is given, so each build
works on a copy of the replica's model. A replica whose engine is
rebuilt or removed releases the old engine's stores, graphs and graph
pool (:meth:`Replica.release`).
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.faults import (
    EXIT_HUNG,
    EXIT_NONFINITE,
    classify_exit,
)
from distributeddeeplearning_tpu_torch.serving.engine import ReqSpec, SlotEngine
from distributeddeeplearning_tpu_torch.serving.scheduler import (
    Request,
    RequestHandle,
    ServeConfig,
    Server,
)
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

# The threaded pumps' CUDA streams by (device, replica id): a replica
# rebuilt, or a new replica of the same id, pumps on the stream its
# predecessor used, because cuBLAS keeps a workspace for every stream it
# has run on for the life of the process.
_PUMP_STREAMS: Dict[Any, "torch.cuda.Stream"] = {}

#: Lifecycle states (docs/SERVING.md fleet section).
STATES = (
    "new", "starting", "ready", "draining", "drained", "faulted", "removed",
)


def _proc_tag(rid: int) -> str:
    """The replica's event-stream identity: the process's own proc tag
    (``DDL_PROCESS_ID`` + any supervisor ``OBS_PROC_SUFFIX`` restart
    suffix) with ``-s<rid>`` appended — ``events-p0-s1.jsonl``. The
    tailer treats it as just another part file; the rollup's per-proc
    view keys on it."""
    base = f"p{int(os.environ.get('DDL_PROCESS_ID', '0'))}"
    base += os.environ.get("OBS_PROC_SUFFIX", "")
    return f"{base}-s{rid}"


class Replica:
    """One SlotEngine + Server behind a private pump and event stream.

    ``model``/``params`` are shared across replicas (each build copies
    the model; ``params`` is an f32 state dict or None); every replica
    captures its own closed program set at :meth:`start` and keeps the
    closed-set invariant independently (``engine.compile_count ==
    engine.programs_expected`` for its lifetime). ``device`` reaches
    the engine (default the card).
    """

    def __init__(
        self,
        rid: int,
        model,
        params,
        config: Optional[ServeConfig] = None,
        *,
        max_len: Optional[int] = None,
        obs_dir: Optional[str] = None,
        run_id: Optional[str] = None,
        idle_sleep_s: float = 0.001,
        pool: str = "mixed",
        device=None,
    ) -> None:
        if pool not in ("mixed", "prefill", "decode"):
            raise ValueError(
                f"pool must be one of ('mixed', 'prefill', 'decode'), "
                f"got {pool!r}"
            )
        self.rid = int(rid)
        self.model = model
        self.params = params
        self.config = config or ServeConfig()
        # Disaggregated serving (docs/SERVING.md): a pool-typed replica
        # serves one phase. "prefill" runs prefills then exports each
        # slot (Server handoff mode); "decode" never takes submissions
        # — work arrives only through import_running. "mixed" is the
        # colocated default (every existing fleet unchanged).
        self.pool = pool
        self.max_len = max_len
        self.obs_dir = obs_dir
        self.run_id = run_id
        self.idle_sleep_s = float(idle_sleep_s)
        self.device = device
        self.state = "new"
        self.threaded = True
        self.engine: Optional[SlotEngine] = None
        self.server: Optional[Server] = None
        self.bus: Optional[obs.EventBus] = None
        self.fault: Optional[BaseException] = None
        self.exit_code: Optional[int] = None
        self.dispatched = 0  # requests this replica was handed
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Set by Router.fail_replica: the pump must NOT gracefully
        # drain on stop — the router is taking the work elsewhere.
        self._abandon = threading.Event()
        # Health plane (Router._monitor_sweep, docs/ROBUSTNESS.md
        # serving failure model): the pump stamps heartbeat_t every
        # iteration it is alive (a hung pump goes stale), and every
        # busy scheduler tick feeds the latency EWMA the straggler
        # detector compares against the fleet median.
        self.heartbeat_t: Optional[float] = None
        self.tick_ewma: float = 0.0
        self.tick_samples: int = 0
        self.straggle_ticks = 0      # consecutive over-factor sightings
        self.quarantined = False     # drained of placements, on probation
        self.quarantine_until = 0    # router tick the probation ends at
        self.leaked_threads = 0      # unjoinable pumps detached by stop()
        # Chaos plane (serving/chaos.py): the router hands every
        # replica its injector; the pump consults it per tick.
        self.chaos = None
        # Quarantine hedge: the router pauses the pump at a tick
        # boundary before evicting running work (take_running is only
        # safe with the pump parked), then resumes it.
        self._pause = threading.Event()
        self._pause_ack = threading.Event()
        self._hang_until = 0.0  # inline pumps' silent-skip window
        # Pump generation: bumped by every start(). A detached zombie
        # thread (stop() join timeout) that later wakes compares its
        # captured generation and exits — it can never pump or drain a
        # rebuilt server, even after rejoin cleared _stop/_abandon.
        self._gen = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, threaded: bool = True) -> "Replica":
        """Build + warm the engine and begin pumping. ``threaded=False``
        builds inline and leaves pumping to :meth:`pump_once` (the
        router's deterministic single-thread mode for tests)."""
        if self.state not in ("new", "drained", "faulted", "removed"):
            raise RuntimeError(f"replica {self.rid} is {self.state}")
        self.threaded = threaded
        self.state = "starting"
        self._gen += 1
        self._stop.clear()
        if self.bus is None and self.obs_dir:
            self.bus = obs.EventBus(
                directory=self.obs_dir,
                run_id=self.run_id or obs.get_bus().run_id,
                proc=_proc_tag(self.rid),
            )
        if threaded:
            self._thread = threading.Thread(
                target=self._worker, args=(self._gen,),
                name=f"replica-{self.rid}", daemon=True,
            )
            self._thread.start()
        else:
            with obs.bound_bus(self.bus):
                self._build()
            self.state = "ready"
        return self

    def _build(self) -> None:
        if self.engine is not None:
            return
        kw = dict(self.config.engine_kwargs())
        if self.max_len is not None:
            kw.setdefault("max_len", self.max_len)
        if self.pool != "mixed":
            kw["pool_role"] = self.pool
        # The engine moves, loads and casts the model it is given.
        engine = SlotEngine(copy.deepcopy(self.model), self.params, device=self.device, **kw)
        engine.warmup()
        self.engine = engine
        self.server = Server(
            engine,
            queue_depth=self.config.queue_depth,
            prefills_per_step=self.config.prefills_per_step,
            default_deadline_ms=self.config.deadline_ms,
            admission_policy=self.config.build_admission_policy(),
            handoff=(self.pool == "prefill"),
        )
        obs.point("fleet.replica_ready", replica=self.rid, pool=self.pool)

    def _chaos_gate(self) -> bool:
        """Consult the chaos injector before a pump tick. Returns False
        when this tick must be skipped (hang: silent-but-alive, the
        heartbeat deliberately NOT stamped); raises :class:`ChaosCrash`
        for crash/flap; sleeps the slow verb's stall inline."""
        if self.chaos is None:
            return True
        action = self.chaos.pump_action(self.rid, time.monotonic())
        if action is None:
            return True
        if action["kind"] == "crash":
            from distributeddeeplearning_tpu_torch.serving.chaos import ChaosCrash

            raise ChaosCrash(f"chaos crash (replica {self.rid})")
        if action["kind"] == "hang":
            if self.threaded:
                # A genuine wedge: the thread sleeps unjoinably — the
                # router's heartbeat monitor hard-faults it and stop()
                # detaches the leaked thread.
                time.sleep(action["secs"])
            else:
                # Inline pumps cannot block the router; silent skip —
                # heartbeat still goes stale, same detection path.
                self._hang_until = time.monotonic() + action["secs"]
            return False
        if action["kind"] == "slow":
            time.sleep(action["stall_s"])
        return True

    def record_tick(self, dur_s: float) -> None:
        """Feed one busy scheduler-tick latency into the straggler
        EWMA (alpha 0.3 — reacts within a few ticks, forgets within a
        probation window)."""
        self.tick_ewma = (
            dur_s if self.tick_samples == 0
            else 0.7 * self.tick_ewma + 0.3 * dur_s
        )
        self.tick_samples += 1

    def reset_latency(self) -> None:
        """Clear the EWMA (leaving quarantine / rejoining): the replica
        must re-offend with fresh samples to be quarantined again."""
        self.tick_ewma = 0.0
        self.tick_samples = 0
        self.straggle_ticks = 0

    def _worker(self, gen: int) -> None:
        from distributeddeeplearning_tpu_torch.utils.device import resolve_device

        dev = resolve_device(self.device)
        if dev.type != "cuda":
            return self._pump(gen)
        stream = _PUMP_STREAMS.get((dev, self.rid))
        if stream is None:
            stream = _PUMP_STREAMS[(dev, self.rid)] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            return self._pump(gen)

    def _pump(self, gen: int) -> None:
        obs.bind_bus(self.bus)
        try:
            self._build()
            if self.state == "starting":  # a drain may already be asked
                self.state = "ready"
            while not self._stop.is_set() and gen == self._gen:
                self.heartbeat_t = time.monotonic()
                if self._pause.is_set():
                    # Parked at a tick boundary for a quarantine hedge:
                    # alive (heartbeat flows) but not stepping.
                    self._pause_ack.set()
                    time.sleep(0.0005)
                    continue
                t0 = time.monotonic()
                if not self._chaos_gate():
                    continue
                busy = self.server.step()
                if busy:
                    # The tick latency includes any injected stall —
                    # the straggler detector sees what a client would.
                    self.record_tick(time.monotonic() - t0)
                if not busy:
                    if self.state == "draining":
                        break  # empty while draining: done
                    time.sleep(self.idle_sleep_s)
            # stop requested with work possibly remaining: finish it —
            # a stopping replica never drops admitted work (the router
            # reclaims *queued* requests before stopping a pump) —
            # unless the router declared this replica failed and is
            # re-routing everything it holds (_abandon), or this is a
            # detached zombie whose replica already restarted (gen).
            if not self._abandon.is_set() and gen == self._gen:
                self.server.drain()
                if self.state in ("draining", "ready", "starting"):
                    self.state = "drained"
                    obs.point("fleet.replica_drained", replica=self.rid)
        except BaseException as e:  # the pump is a thread main: classify
            if gen != self._gen:
                return  # detached zombie: the replica already restarted
            self.fault = e
            code = e.code if isinstance(e, SystemExit) and isinstance(
                getattr(e, "code", None), int
            ) else EXIT_HUNG  # generic crash: retryable class
            if type(e).__name__ == "NonFiniteLossError":
                code = EXIT_NONFINITE
            self.exit_code = int(code)
            self.state = "faulted"
            get_logger().error(
                "replica %d faulted (%s): %r", self.rid,
                classify_exit(self.exit_code).reason, e,
            )
            obs.point(
                "fleet.replica_fault", replica=self.rid, error=repr(e),
                exit_code=self.exit_code,
                retryable=classify_exit(self.exit_code).retryable,
            )
        finally:
            if self.bus is not None:
                self.bus.flush()
            obs.bind_bus(None)

    def pump_once(self) -> bool:
        """Inline pump (unthreaded replicas): one scheduler tick on the
        caller's thread, with this replica's event stream bound. A
        pump-side exception faults the replica exactly like the worker
        path (the router then re-routes its work)."""
        if self.server is None or self.state not in ("ready", "draining"):
            return False
        now = time.monotonic()
        if now < self._hang_until:
            return False  # chaos hang: silent-but-alive, heartbeat stale
        try:
            with obs.bound_bus(self.bus):
                t0 = time.monotonic()
                if not self._chaos_gate():
                    return False
                self.heartbeat_t = time.monotonic()
                busy = self.server.step()
                if busy:
                    # Tick latency includes any injected stall — the
                    # straggler detector sees what a client would.
                    self.record_tick(time.monotonic() - t0)
        except BaseException as e:
            self.fault = e
            self.exit_code = EXIT_HUNG
            self.state = "faulted"
            obs.point(
                "fleet.replica_fault", replica=self.rid, error=repr(e),
                exit_code=self.exit_code, retryable=True,
            )
            return False
        if not busy and self.state == "draining":
            self.state = "drained"
            obs.point("fleet.replica_drained", replica=self.rid)
        return busy

    def begin_drain(self) -> None:
        """Stop taking placements; finish what is running. The router
        reclaims this replica's *queued* requests — see
        ``Router.drain_replica`` — so only in-flight slots remain, and
        the pump parks the state at ``drained`` once they finish."""
        if self.state in ("ready", "starting"):
            self.state = "draining"
            obs.point("fleet.replica_drain", replica=self.rid)

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the pump thread (drains admitted work first). A pump
        that does not join within ``timeout`` — a hung thread blocked
        inside a wedged step or a chaos ``hang`` — is **detached**, not
        leaked silently: the thread object is dropped (``_abandon`` is
        already set on the fault path, so if it ever wakes it exits
        without draining, and a faulted rejoin rebuilds engine+server
        so the zombie can only touch the abandoned objects), and a
        ``fleet.thread_leaked`` point records it for drills to assert
        on."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                self.leaked_threads += 1
                self._abandon.set()  # a waking zombie must not drain
                obs.point(
                    "fleet.thread_leaked", replica=self.rid,
                    state=self.state,
                )
            self._thread = None

    def pause(self, timeout: float = 2.0) -> bool:
        """Park the pump at a tick boundary (quarantine hedge: the
        router must not evict running slots while a step is in flight).
        Returns False when the pump never acknowledged — it is hung,
        and the caller escalates to a hard fault. Inline replicas are
        trivially paused (the router thread IS the pump)."""
        if not self.threaded or self._thread is None:
            return True
        self._pause_ack.clear()
        self._pause.set()
        return self._pause_ack.wait(timeout)

    def resume(self) -> None:
        self._pause.clear()
        self._pause_ack.clear()

    def release(self) -> None:
        """Drop the engine and server, releasing the engine's stores,
        graphs and graph pool (a faulted replica's rebuild, a removed
        replica). A detached zombie pump never touches them again (its
        generation is stale)."""
        if self.engine is not None:
            self.engine.close()
        self.engine = None
        self.server = None

    @property
    def retryable(self) -> bool:
        """May this replica rejoin after a fault? — the supervisor's
        exit-code table (``faults.classify_exit``). A non-faulted
        replica is always rejoinable."""
        if self.exit_code is None:
            return True
        return classify_exit(self.exit_code).retryable

    def rejoin(self, threaded: Optional[bool] = None) -> "Replica":
        """Bring a drained/faulted replica back into service. A faulted
        replica's engine is rebuilt from scratch (its device pool and
        host mirrors are not trusted after an arbitrary pump death); a
        cleanly drained one reuses its warmed programs. Non-retryable
        faults (deterministic failures) refuse — restarting would
        replay them."""
        if self.state not in ("drained", "faulted", "removed"):
            raise RuntimeError(f"replica {self.rid} is {self.state}")
        if not self.retryable:
            raise RuntimeError(
                f"replica {self.rid} fault is non-retryable "
                f"(exit {self.exit_code}: "
                f"{classify_exit(self.exit_code).reason})"
            )
        if self.state == "faulted":
            self.release()
        self.fault = None
        self.exit_code = None
        self._abandon.clear()
        self._pause.clear()
        self._pause_ack.clear()
        self._hang_until = 0.0
        self.quarantined = False
        self.reset_latency()
        self.heartbeat_t = None
        obs.point("fleet.replica_rejoin", replica=self.rid)
        return self.start(
            threaded=self.threaded if threaded is None else threaded
        )

    # -- placement inputs --------------------------------------------------

    @property
    def placeable(self) -> bool:
        return (
            self.state == "ready" and self.server is not None
            and not self.quarantined
        )

    def free_slot_count(self) -> int:
        if self.engine is None:
            return 0
        # Slots not occupied AND not already promised to queued requests
        # the pump will admit on its next ticks — keeps replica queues
        # shallow so a drain has almost nothing to re-route.
        free = self.engine.num_slots - self.server.active_count
        return max(free - self.server.queued_count, 0)

    def load(self) -> Dict[str, float]:
        """Placement score inputs: free-slot and free-block fractions."""
        if self.engine is None:
            return {"free_slots": 0.0, "free_blocks": 1.0}
        free_slots = self.free_slot_count() / max(self.engine.num_slots, 1)
        free_blocks = 1.0
        if self.engine.allocator is not None:
            a = self.engine.allocator
            free_blocks = a.free_count / max(a.capacity, 1)
        return {"free_slots": free_slots, "free_blocks": free_blocks}

    def prefix_hit_blocks(self, prompt: np.ndarray) -> int:
        """How many leading KV blocks of ``prompt`` this replica's
        allocator already holds (0 on dense / prefix-cache-off) — the
        affinity tier's routing signal."""
        if (
            self.engine is None
            or self.engine.allocator is None
            or not self.engine.prefix_cache
        ):
            return 0
        p = np.asarray(prompt, np.int32).reshape(-1)
        return self.engine.allocator.peek_prefix(p, p.shape[0] - 1)

    def can_take(self, spec: ReqSpec) -> bool:
        return (
            self.placeable
            and self.free_slot_count() > 0
            and self.engine.can_admit(spec)
        )

    def submit(self, request: Request) -> RequestHandle:
        """Submit into this replica's server, on its event stream."""
        with obs.bound_bus(self.bus):
            handle = self.server.submit(request)
        self.dispatched += 1
        return handle

    def reclaim_queued(self) -> List[RequestHandle]:
        with obs.bound_bus(self.bus):
            return self.server.reclaim_queued() if self.server else []

    def inject_prefix(self, tokens: np.ndarray, payload) -> int:
        """Directory chain prefetch: seed this replica's local prefix
        cache with full-block KV content fetched from the fleet
        directory, so the NEXT prefill of a prompt sharing those blocks
        computes only its suffix. The pump is paused around the pool
        write (allocator + pool mutation must not race a stepping
        pump); inline replicas need no pause — the caller's thread IS
        the pump. Returns blocks seeded (0 = skipped, always safe)."""
        if self.engine is None or self.state not in ("ready", "draining"):
            return 0
        if self.threaded and not self.pause():
            return 0  # pump never parked: skip, prefill computes it
        try:
            with obs.bound_bus(self.bus):
                return self.engine.adopt_prefix_blocks(tokens, payload)
        finally:
            if self.threaded:
                self.resume()

    def snapshot(self) -> Dict[str, Any]:
        """One row of the router's fleet view."""
        out: Dict[str, Any] = {"replica": self.rid, "state": self.state}
        if self.pool != "mixed":
            out["pool"] = self.pool
        if self.server is not None:
            out.update(
                active=self.server.active_count,
                queued=self.server.queued_count,
                dispatched=self.dispatched,
                completed=self.server.stats["completed"],
                tokens=self.server.stats["tokens"],
            )
        if self.engine is not None:
            out.update(
                slots=self.engine.num_slots,
                occupancy=self.engine.occupancy,
                programs=self.engine.compile_count,
                programs_expected=self.engine.programs_expected,
            )
            if self.engine.allocator is not None:
                out["free_blocks"] = self.engine.allocator.free_count
        if self.quarantined:
            out["quarantined"] = True
        if self.tick_samples:
            out["tick_ewma_ms"] = round(self.tick_ewma * 1e3, 3)
        if self.leaked_threads:
            out["leaked_threads"] = self.leaked_threads
        if self.exit_code is not None:
            out["exit_code"] = self.exit_code
            out["retryable"] = self.retryable
        return out
