"""Serving chaos plane — deterministic fleet fault drills.

The training tier has ``FAULT_PLAN`` (``faults.py``): seeded,
step-indexed faults that make every robustness claim a replayable
drill. The serving fleet had nothing comparable — a replica that is
slow, hung, flapping, or emitting garbage was invisible to the router's
health sweep, and every fleet robustness test hand-choreographed its
failure. This module extends the FAULT_PLAN grammar to **fleet verbs**,
consulted per router tick and per replica pump, so a fault storm is a
deterministic, replayable drill (``scripts/chaos_bench.py`` gates it;
``scripts/faultgen.py chaos-drill`` emits canned storms).

Chaos-plan grammar (``docs/ROBUSTNESS.md`` serving failure model)::

    SERVE_CHAOS_PLAN := directive (";" directive)*
    directive        := kind ":" key "=" value ("," key "=" value)*
    kind             := crash | hang | slow | corrupt | flap
    keys             := tick    (required int >= 1: fires once the
                                 router has completed N ticks)
                        replica (required int: target replica id)
                        factor  (slow only: per-pump stall =
                                 factor x 10 ms, default 4)
                        secs    (hang: silent duration, default 30;
                                 slow: how long the stall persists,
                                 default 1)
                        count   (flap only: crash->rejoin cycles,
                                 default 2)

Verb semantics (the serving twins of the training verbs):

* ``crash`` — the replica's pump raises on its next tick: the existing
  fault path classifies it retryable (125), the router re-routes its
  work, and the crash-loop breaker drives rejoin/backoff/budget.
* ``hang`` — the pump goes silent-but-alive for ``secs`` (no steps, no
  heartbeat): the router's heartbeat monitor hard-faults it, and
  ``Replica.stop`` detaches the unjoinable thread
  (``fleet.thread_leaked``).
* ``slow`` — every pump tick stalls ``factor x 10 ms`` for ``secs``:
  the decode-tick EWMA rises past ``SERVE_STRAGGLER_FACTOR`` x the
  fleet median and the replica is quarantined (hedge re-route via the
  bitwise splice path).
* ``corrupt`` — silent-data-corruption rehearsal: one running request
  on the replica is hedge re-routed and a single token of its **replay
  of the already-delivered prefix** is flipped. The fleet handle's
  splice verifier is the detector: replayed tokens are compared against
  the delivered prefix and never re-emitted, so the corrupt token is
  *detected and healed, never delivered* — the router hard-faults the
  replica producing the divergence and replays the stream from the
  request's deterministic prefix elsewhere. (Fresh-region corruption
  has no reference until a replay exists; the drill therefore targets
  the verifiable region — which is also the only region whose
  corruption the splice contract promises to catch.)
* ``flap`` — ``count`` crash→rejoin cycles: each rejoin re-arms the
  crash, so a ``count`` beyond ``SERVE_REPLICA_MAX_RESTARTS`` must open
  the circuit breaker (``fleet.breaker_open``) and remove the replica.

The injector is seeded (``SERVE_CHAOS_SEED``) and all scheduling is
tick-indexed, so the same plan reproduces the same storm on every run —
the fleet twin of the FaultInjector determinism contract. Parsing
reuses the FAULT_PLAN lexical layer (``faults.split_plan``); the hurt
replicas exit through the same retryable taxonomy
(``faults.classify_exit``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.faults import split_plan

#: Fleet fault verbs (the serving twins of faults.FAULT_KINDS).
FLEET_FAULT_KINDS = ("crash", "hang", "slow", "corrupt", "flap")
_INT_KEYS = ("tick", "replica", "count")

#: One "slow" factor unit: the per-pump stall is ``factor x`` this.
SLOW_UNIT_S = 0.01


class ChaosCrash(RuntimeError):
    """The crash/flap verbs' injected pump death (retryable class)."""


class SpliceMismatch(RuntimeError):
    """A replica's replay diverged from the delivered prefix — the
    corrupt-detection hard fault (retryable: the replica rebuilds)."""


@dataclasses.dataclass(frozen=True)
class FleetFault:
    kind: str
    tick: int
    replica: int
    factor: float = 4.0   # slow: stall = factor * SLOW_UNIT_S per pump
    secs: float = 30.0    # hang duration / slow persistence (slow: 1.0)
    count: int = 2        # flap: crash->rejoin cycles


def parse_chaos_plan(text: str) -> List[FleetFault]:
    """Parse a ``SERVE_CHAOS_PLAN`` string (module docstring grammar)."""
    faults: List[FleetFault] = []
    for raw, kind, pairs in split_plan(text, FLEET_FAULT_KINDS):
        kw: dict = {}
        for k, v in pairs:
            if k not in ("tick", "replica", "factor", "secs", "count"):
                raise ValueError(
                    f"chaos directive {raw!r}: unknown key {k!r}"
                )
            if k == "factor" and kind != "slow":
                raise ValueError(
                    f"chaos directive {raw!r}: factor= applies to slow only"
                )
            if k == "count" and kind != "flap":
                raise ValueError(
                    f"chaos directive {raw!r}: count= applies to flap only"
                )
            kw[k] = int(v) if k in _INT_KEYS else float(v)
        for req in ("tick", "replica"):
            if req not in kw:
                raise ValueError(
                    f"chaos directive {raw!r}: {req}= is required"
                )
        if kw["tick"] < 1:
            raise ValueError(
                f"chaos directive {raw!r}: tick counts COMPLETED router "
                f"ticks and must be >= 1"
            )
        if kw["replica"] < 0:
            raise ValueError(
                f"chaos directive {raw!r}: replica must be >= 0"
            )
        if kind == "slow":
            kw.setdefault("secs", 1.0)
            if kw.get("factor", 4.0) <= 1.0:
                raise ValueError(
                    f"chaos directive {raw!r}: slow factor must be > 1"
                )
        if kw.get("count", 2) < 1:
            raise ValueError(
                f"chaos directive {raw!r}: count must be >= 1"
            )
        faults.append(FleetFault(kind=kind, **kw))
    return faults


def storm_plan(
    replicas: int, seed: int = 0, verbs=FLEET_FAULT_KINDS,
    *, first_tick: int = 5, spread: int = 240,
) -> str:
    """A canned seeded mixed-verb storm over ``replicas`` replicas —
    the ``faultgen chaos-drill`` / ``chaos_bench`` default. One
    directive per verb, ticks drawn deterministically from ``seed`` in
    ``[first_tick, first_tick + spread)``, targets cycled over the
    fleet. Returns the plan string (always re-parseable)."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    rng = np.random.RandomState(seed)
    parts = []
    for i, verb in enumerate(verbs):
        if verb not in FLEET_FAULT_KINDS:
            raise ValueError(
                f"unknown chaos verb {verb!r} (have "
                f"{', '.join(FLEET_FAULT_KINDS)})"
            )
        tick = first_tick + int(rng.randint(0, spread))
        rid = int(rng.randint(0, replicas)) if replicas > 1 else 0
        d = f"{verb}:tick={tick},replica={rid}"
        if verb == "slow":
            d += ",factor=8,secs=0.8"
        elif verb == "hang":
            d += ",secs=1.5"
        elif verb == "flap":
            d += ",count=3"
        parts.append(d)
    plan = ";".join(parts)
    parse_chaos_plan(plan)  # canned plans must always validate
    return plan


class ChaosInjector:
    """Tick-indexed fleet fault execution, consulted from two sides.

    * The **router** calls :meth:`router_tick` once per completed tick:
      due faults arm per-replica pump actions (crash/hang/slow/flap)
      or, for ``corrupt``, pick a victim request (deterministically —
      the lowest-id running handle with a delivered prefix) and arm a
      one-shot replay flip for it; the router then hedge re-routes the
      victim so the flip lands in the splice verifier's window.
    * Each **replica pump** calls :meth:`pump_action` at the top of
      every tick and executes what it is told: raise
      (:class:`ChaosCrash`), go silent, or stall.

    Everything fires at most once (slow persists for its window), so a
    replayed drill is bitwise the same storm. Thread-safe: the router
    arms from its thread; pumps consult from theirs.
    """

    def __init__(self, faults: List[FleetFault], seed: int = 0) -> None:
        self.pending = list(faults)
        self.seed = int(seed)
        self.rng = np.random.RandomState(self.seed)
        self._lock = threading.Lock()
        # rid -> list of armed pump actions (mutated under _lock).
        self._armed: Dict[int, List[dict]] = {}
        # fleet-handle id -> one-shot replay flip armed by `corrupt`.
        self._flips: Dict[int, bool] = {}
        self.fired: List[dict] = []  # the drill's ledger (assertable)

    @classmethod
    def from_env(cls, env=None) -> Optional["ChaosInjector"]:
        """Build from ``SERVE_CHAOS_PLAN`` (+ ``SERVE_CHAOS_SEED``);
        None when no plan is set — the fleet runs chaos-free."""
        e = os.environ if env is None else env
        plan = e.get("SERVE_CHAOS_PLAN")
        if not plan:
            return None
        return cls(
            parse_chaos_plan(plan), seed=int(e.get("SERVE_CHAOS_SEED", "0"))
        )

    # -- router side -------------------------------------------------------

    def due(self, tick: int) -> List[FleetFault]:
        with self._lock:
            hit = [f for f in self.pending if f.tick == tick]
            if hit:
                self.pending = [f for f in self.pending if f.tick != tick]
        return hit

    def quiescent(self) -> bool:
        """True once every process-hurting directive has run its course
        (no pending directives, no armed crash/flap/hang) — the drill's
        run-to-completion signal. A persisting ``slow`` window or a
        flip armed on an already-finished handle does not block
        quiescence (neither can change fleet membership)."""
        with self._lock:
            if any(f.kind != "corrupt" for f in self.pending):
                return False
            return not any(
                a["kind"] in ("crash", "flap", "hang")
                for acts in self._armed.values() for a in acts
            )

    def defer(self, fault: FleetFault) -> None:
        """Re-queue a directive for the next tick (the router defers a
        ``corrupt`` until a replayable victim exists)."""
        with self._lock:
            self.pending.append(
                dataclasses.replace(fault, tick=fault.tick + 1)
            )

    def arm_pump(self, fault: FleetFault, now: float) -> None:
        """Arm a crash/hang/slow/flap action on the fault's replica."""
        action = {
            "kind": fault.kind,
            "secs": fault.secs,
            "stall_s": fault.factor * SLOW_UNIT_S,
            "until": now + fault.secs,   # slow persistence window
            "remaining": fault.count if fault.kind == "flap" else 1,
        }
        with self._lock:
            self._armed.setdefault(fault.replica, []).append(action)
        obs.point(
            "chaos.fault_armed", kind=fault.kind, tick=fault.tick,
            replica=fault.replica,
        )

    def arm_corrupt(self, fault: FleetFault, fh_id: int) -> None:
        """Arm a one-shot replay-token flip for fleet handle ``fh_id``
        (the router hedge re-routes it; the flip fires wherever the
        replay lands)."""
        with self._lock:
            self._flips[fh_id] = True
        obs.point(
            "chaos.fault_armed", kind="corrupt", tick=fault.tick,
            replica=fault.replica, req=fh_id,
        )

    def maybe_corrupt(self, fh_id: int, token: int) -> int:
        """Consulted by the fleet handle for every token ingested in
        the **replay region** (already-delivered prefix). Flips the
        first such token of an armed handle — guaranteed caught by the
        splice verifier, guaranteed never delivered."""
        with self._lock:
            if not self._flips.pop(fh_id, False):
                return token
        flipped = int(token) ^ 1
        self._record("corrupt", req=fh_id, token=int(token), flipped=flipped)
        return flipped

    # -- replica pump side -------------------------------------------------

    def pump_action(self, rid: int, now: float) -> Optional[dict]:
        """The action (if any) this replica's pump must execute on this
        tick. Crash/flap and hang fire once (flap re-arms until its
        cycle count drains); slow persists until its window closes."""
        with self._lock:
            actions = self._armed.get(rid)
            if not actions:
                return None
            for a in list(actions):
                if a["kind"] in ("crash", "flap"):
                    a["remaining"] -= 1
                    if a["remaining"] <= 0:
                        actions.remove(a)
                    out = dict(a, kind="crash")
                    break
                if a["kind"] == "hang":
                    actions.remove(a)
                    out = a
                    break
                if a["kind"] == "slow":
                    if now >= a["until"]:
                        actions.remove(a)
                        continue
                    out = a
                    break
            else:
                return None
        if not out.get("logged"):
            out["logged"] = True
            self._record(out["kind"], replica=rid)
        return dict(out)

    def _record(self, kind: str, **labels) -> None:
        self.fired.append({"kind": kind, **labels})
        obs.point("chaos.fault_fired", kind=kind, **labels)
