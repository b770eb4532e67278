"""Autoscaler: turn the router's pressure signal into replica count
(port of ``serving/fleet/controller.py``).

The :class:`~distributeddeeplearning_tpu_torch.serving.fleet.router.Router`
publishes ``serve.fleet_pressure`` every tick (demanded capacity /
ready capacity, block saturation on paged fleets). This controller
consumes that signal *between* ticks and moves the fleet toward the
demand: sustained pressure above the high watermark adds a replica
(factory-built, warmed in its own thread — serving never pauses);
sustained pressure below the low watermark drains the least-loaded
replica (its queued requests re-route immediately, running streams
finish) and removes it once drained.

**Pools** (disaggregated fleets, docs/SERVING.md): a homogeneous fleet
scales as one pool against the fleet-wide pressure — the legacy path,
unchanged. ``ControllerConfig.pools`` lifts the same watermark
hysteresis to per-pool control: each named pool (``prefill`` /
``decode``) carries its own :class:`PoolWatermarks`, reads its own
``Router.pool_pressure`` signal, and counts its own hot/cold streaks,
so a prefill burst grows the prefill pool without touching decode.
The arbiter's lease accounting is pool-blind on purpose: every
scale-up still leases ``replica:<rid>`` and every completed drain
releases it — colocation sees devices, not pool labels.

Signal sources, in priority order:

* an injected ``reader`` callable (tests);
* the live plane's ``rollup.json`` (``snapshot_path`` — the gauge as
  every other consumer sees it, dashboard included);
* the router's own ``last_pressure`` (in-process default), or
  ``Router.pool_pressure`` when pools are configured.

Hysteresis is tick-counted, not wall-timed, so the controller is
deterministic under synthetic pressure traces (oracle-tested) and the
caller owns the cadence (``FleetController.tick`` from the serving
loop, a supervisor thread, or a cron).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.serving.fleet.replica import Replica
from distributeddeeplearning_tpu_torch.serving.fleet.router import Router


@dataclasses.dataclass
class PoolWatermarks:
    """One pool's scaling envelope: replica bounds + watermark
    hysteresis. The flat (single-pool) config is the degenerate case
    of one of these applied to the whole fleet."""

    min_replicas: int = 1
    max_replicas: int = 4
    high_pressure: float = 1.0   # demand >= ready capacity
    low_pressure: float = 0.35
    up_ticks: int = 3            # consecutive hot ticks before scale-up
    down_ticks: int = 8          # consecutive cold ticks before drain

    def validate(self, pool: str = "") -> None:
        tag = f" (pool {pool!r})" if pool else ""
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min {self.min_replicas} <= max "
                f"{self.max_replicas}{tag}"
            )
        if self.low_pressure >= self.high_pressure:
            raise ValueError(
                f"low watermark {self.low_pressure} must be below high "
                f"{self.high_pressure}{tag}"
            )
        if self.up_ticks < 1 or self.down_ticks < 1:
            raise ValueError(f"up_ticks and down_ticks must be >= 1{tag}")


@dataclasses.dataclass
class ControllerConfig:
    """Watermarks + hysteresis for the autoscaler. ``pools`` (e.g.
    ``{"prefill": PoolWatermarks(...), "decode": PoolWatermarks(...)}``)
    switches to per-pool control; None keeps the flat single-pool
    policy on the fleet-wide pressure signal."""

    min_replicas: int = 1
    max_replicas: int = 4
    high_pressure: float = 1.0   # demand >= ready capacity
    low_pressure: float = 0.35
    up_ticks: int = 3            # consecutive hot ticks before scale-up
    down_ticks: int = 8          # consecutive cold ticks before drain
    # Crash-loop respect (docs/ROBUSTNESS.md serving failure model): a
    # breaker opening means a replica crash-looped through its whole
    # restart budget — blindly adding capacity right after would feed
    # the same failure. Scale-up is held for this many router ticks
    # after the most recent breaker opening (0 = never hold).
    breaker_block_ticks: int = 10
    # Hardware is NOT infinite: when scale-up is denied (breaker
    # cooldown or an arbiter lease refusal) the controller backs off
    # for this many router ticks instead of re-asking every tick.
    denied_backoff_ticks: int = 10
    pools: Optional[Dict[str, PoolWatermarks]] = None

    def validate(self) -> None:
        self.flat_watermarks().validate()
        for pool, wm in (self.pools or {}).items():
            wm.validate(pool)

    def flat_watermarks(self) -> PoolWatermarks:
        """The single-pool envelope the flat fields describe."""
        return PoolWatermarks(
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            high_pressure=self.high_pressure,
            low_pressure=self.low_pressure,
            up_ticks=self.up_ticks,
            down_ticks=self.down_ticks,
        )


# The flat policy runs as "one unnamed pool spanning the fleet": pool
# None selects every replica and the legacy fleet-wide pressure signal.
_FLAT = None


class FleetController:
    """Add/drain replicas from the ``serve.fleet_pressure`` signal.

    ``factory(rid)`` — or ``factory(rid, pool)`` under per-pool
    watermarks — builds a NEW (unstarted) :class:`Replica`; the
    controller starts it through ``Router.add_replica``. ``tick()``
    returns the action taken (``"scale_up"`` / ``"drain"`` /
    ``"remove"`` / None) so callers and tests can assert the policy.
    """

    def __init__(
        self,
        router: Router,
        factory: Callable[..., Replica],
        config: Optional[ControllerConfig] = None,
        *,
        reader: Optional[Callable[[], Optional[float]]] = None,
        snapshot_path: Optional[str] = None,
        threaded_replicas: bool = True,
        arbiter=None,
    ) -> None:
        self.router = router
        self.factory = factory
        self.config = config or ControllerConfig()
        self.config.validate()
        self._reader = reader
        self.snapshot_path = snapshot_path
        self.threaded_replicas = threaded_replicas
        # Colocation (serving/arbiter.py): when an arbiter owns the
        # pool, every scale-up must hold a lease on freed devices —
        # the controller asks, it does not assume free hardware.
        self.arbiter = arbiter
        # Hot/cold streaks per pool (the flat policy is pool None).
        self._hot: Dict[Optional[str], int] = {}
        self._cold: Dict[Optional[str], int] = {}
        self._denied_until: Optional[int] = None
        try:
            params = [
                p for p in
                inspect.signature(factory).parameters.values()
                if p.kind in (p.POSITIONAL_ONLY,
                              p.POSITIONAL_OR_KEYWORD)
                or p.kind == p.VAR_POSITIONAL
            ]
            self._factory_takes_pool = (
                len(params) >= 2
                or any(p.kind == p.VAR_POSITIONAL for p in params)
            )
        except (TypeError, ValueError):
            self._factory_takes_pool = False
        self.actions: List[Dict[str, Any]] = []

    # -- signal ------------------------------------------------------------

    def read_pressure(self, pool: Optional[str] = _FLAT
                      ) -> Optional[float]:
        if self._reader is not None:
            try:
                return self._reader(pool) if pool is not None else (
                    self._reader()
                )
            except TypeError:
                return self._reader()
        if pool is not None:
            return float(self.router.pool_pressure(pool))
        if self.snapshot_path:
            from distributeddeeplearning_tpu_torch.obs.rollup import read_snapshot

            snap = read_snapshot(self.snapshot_path)
            if snap:
                g = (snap.get("gauges") or {}).get("serve.fleet_pressure")
                if g and g.get("value") is not None:
                    return float(g["value"])
            return None
        return float(self.router.last_pressure)

    # -- policy ------------------------------------------------------------

    def _pool_replicas(self, pool: Optional[str]) -> List[Replica]:
        if pool is None:
            return list(self.router.replicas)
        return [r for r in self.router.replicas if r.pool == pool]

    def _ready_count(self, pool: Optional[str] = _FLAT) -> int:
        return sum(
            1 for r in self._pool_replicas(pool)
            if r.state in ("starting", "ready")
        )

    def tick(self) -> Optional[str]:
        """One control decision. Finalizes any replica that finished
        draining (remove), then applies the watermark hysteresis —
        flat, or once per configured pool (first action wins the
        tick)."""
        # Finalize drains the policy started earlier. A leased replica's
        # devices return to the arbiter only once the drain completed —
        # zero-drop: running streams finished, nothing was cut mid-air.
        for r in list(self.router.replicas):
            if r.state == "drained":
                self.router.remove_replica(r.rid)
                if self.arbiter is not None:
                    self.arbiter.release_lease(f"replica:{r.rid}")
                self._record("remove", r.rid)
                return "remove"
        # Training reclaim (priority order, docs/ROBUSTNESS.md): when
        # the arbiter wants its devices back, drain one leased replica
        # per tick regardless of the pressure hysteresis.
        if self.arbiter is not None and self.arbiter.reclaiming:
            for r in self.router.replicas:
                if r.state == "ready" and self.arbiter.has_lease(
                    f"replica:{r.rid}"
                ):
                    self.router.drain_replica(r.rid)
                    self._record("drain", r.rid, reason="reclaim")
                    obs.point(
                        "fleet.scale_down", replica=r.rid,
                        reason="reclaim",
                    )
                    return "drain"
        if self.config.pools:
            for pool, wm in sorted(self.config.pools.items()):
                action = self._pool_tick(pool, wm)
                if action is not None:
                    return action
            return None
        return self._pool_tick(_FLAT, self.config.flat_watermarks())

    def _pool_tick(self, pool: Optional[str], wm: PoolWatermarks
                   ) -> Optional[str]:
        """The watermark hysteresis for ONE pool (pool None = the whole
        fleet on the legacy fleet-wide signal)."""
        p = self.read_pressure(pool)
        if p is None:
            return None
        cfg = self.config
        if p >= wm.high_pressure:
            self._hot[pool] = self._hot.get(pool, 0) + 1
            self._cold[pool] = 0
        elif p <= wm.low_pressure:
            self._cold[pool] = self._cold.get(pool, 0) + 1
            self._hot[pool] = 0
        else:
            self._hot[pool] = self._cold[pool] = 0
        ready = self._ready_count(pool)
        if self._hot.get(pool, 0) >= wm.up_ticks and (
            ready < wm.max_replicas
        ):
            # Backing off after a denial: do not re-ask (and re-emit)
            # every tick — that is the spin this guard exists to stop.
            if (
                self._denied_until is not None
                and self.router._ticks < self._denied_until
            ):
                return None
            # Respect open breakers: right after a replica crash-looped
            # through its restart budget, hold scale-up for a cooldown
            # window instead of feeding the same failure more capacity.
            # (The Router's membership door separately refuses a
            # breaker-open rid forever.)
            last = self.router.last_breaker_tick
            if (
                cfg.breaker_block_ticks
                and last is not None
                and self.router._ticks - last < cfg.breaker_block_ticks
            ):
                self._deny("breaker", p, breaker_tick=last, pool=pool)
                return None
            rid = self.router.next_rid()
            # Colocated pool: the arbiter must lease the devices first
            # — hardware is whatever training has actually freed. The
            # lease key stays pool-blind: devices are devices.
            if self.arbiter is not None and not self.arbiter.request_lease(
                f"replica:{rid}"
            ):
                self._deny("lease", p, replica=rid, pool=pool)
                return None
            replica = (
                self.factory(rid, pool)
                if pool is not None and self._factory_takes_pool
                else self.factory(rid)
            )
            self.router.add_replica(
                replica, start=True, threaded=self.threaded_replicas,
            )
            self._hot[pool] = 0
            self._denied_until = None
            self._record("scale_up", rid, pressure=p, pool=pool)
            obs.point(
                "fleet.scale_up", replica=rid, pressure=round(p, 4),
                **({"pool": pool} if pool is not None else {}),
            )
            return "scale_up"
        if self._cold.get(pool, 0) >= wm.down_ticks and (
            ready > wm.min_replicas
        ):
            victim = self._pick_drain_victim(pool)
            if victim is not None:
                self.router.drain_replica(victim.rid)
                self._cold[pool] = 0
                self._record("drain", victim.rid, pressure=p, pool=pool)
                obs.point(
                    "fleet.scale_down", replica=victim.rid,
                    pressure=round(p, 4),
                    **({"pool": pool} if pool is not None else {}),
                )
                return "drain"
        return None

    def _pick_drain_victim(self, pool: Optional[str] = _FLAT
                           ) -> Optional[Replica]:
        """Least-loaded ready replica (fewest running + queued) of the
        pool: the cheapest drain — it finishes fastest and re-routes
        the least."""
        ready = [
            r for r in self._pool_replicas(pool) if r.state == "ready"
        ]
        if not ready:
            return None
        return min(
            ready,
            key=lambda r: (
                r.server.active_count + r.server.queued_count
                if r.server is not None else 0
            ),
        )

    def _deny(self, reason: str, pressure: float, *,
              pool: Optional[str] = _FLAT, **labels: Any) -> None:
        """Scale-up refused (breaker cooldown / arbiter lease): emit
        one ``fleet.scaleup_denied`` and enter a tick-counted backoff
        instead of re-asking every tick."""
        self._denied_until = (
            self.router._ticks + self.config.denied_backoff_ticks
        )
        if pool is not None:
            labels = {"pool": pool, **labels}
        self.actions.append({
            "action": "scaleup_denied", "reason": reason,
            "pressure": pressure, **labels,
        })
        obs.point(
            "fleet.scaleup_denied", reason=reason,
            pressure=round(pressure, 4), **labels,
        )

    def _record(self, action: str, rid: int, *,
                pool: Optional[str] = _FLAT, **extra: Any) -> None:
        if pool is not None:
            extra = {"pool": pool, **extra}
        self.actions.append({"action": action, "replica": rid, **extra})
