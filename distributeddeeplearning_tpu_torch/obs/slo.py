"""Declarative SLO engine — objectives, multi-window burn rates, events.

Copied from ``distributeddeeplearning_tpu/obs/slo.py`` (it never
imported jax); its points go through the port's bus.

Objectives are parsed from an ``SLO_SPEC`` env var or file (the same
style as the robustness tier's ``FAULT_PLAN`` grammar — a small,
deterministic string language, not config-framework machinery) and
evaluated against the live rollup windows
(:class:`~distributeddeeplearning_tpu_torch.obs.rollup.WindowedAggregator`).

Grammar::

    SLO_SPEC    := objective ((";" | newline) objective)*
    objective   := metric [":" stat] predicate ["over" window]
    stat        := p50 | p95 | p99    (span quantile, seconds)
                 | rate               (counter, events/second)
                 | last               (gauge, last value — the default)
    predicate   := op value [unit]    op := < | <= | > | >=
                 | "finite"           (gauge must not be NaN/Inf)
    unit        := ms | s | us | %    (% = x0.01, for rates/fractions)
    window      := <float>s | <float>m | <float>h   (default 60s)

    SLO_SPEC="serve.ttft:p99 < 250ms over 60s; epoch.loss finite"
    SLO_SPEC="serve.rejected:rate < 1% over 30s"     # < 0.01 events/s

**Burn rate** is how hot an objective runs relative to its target:
``value / threshold`` for ``<`` objectives (and the reciprocal for
``>``), so burn 1.0 = exactly at target, 2.0 = failing twice over.
Following the multi-window pattern (SRE workbook alerting), each
objective is evaluated over its own window AND a ``long_factor``×
longer one: a **breach** needs both windows burning (>1) — a single
slow request cannot page — and **recovery** needs only the short
window clean, so the all-clear is fast once the cause stops.

Transitions emit ``slo_breach`` / ``slo_recover`` points through the
process-global bus, landing in the same event stream the plane tails —
the feedback loop's signal (``serving/scheduler.AdmissionPolicy``) and
the post-hoc report's SLO timeline are both built from them.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Any, Dict, List, Optional

from distributeddeeplearning_tpu_torch.obs.bus import point as _emit_point

DEFAULT_WINDOW_S = 60.0
DEFAULT_LONG_FACTOR = 5.0
#: JSON-safe stand-in for an unbounded burn (nonfinite gauge, zero
#: denominator): large enough to rank worst, finite enough to serialize.
BURN_MAX = 1e9

QUANTILE_STATS = {"p50": 0.50, "p95": 0.95, "p99": 0.99}
STATS = (*QUANTILE_STATS, "rate", "last", "finite")

_UNITS = {"ms": 1e-3, "s": 1.0, "us": 1e-6, "%": 0.01, "": 1.0}
_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0}

_OBJ_RE = re.compile(
    r"^\s*(?P<metric>[A-Za-z0-9_.\-]+?)"
    r"(?::(?P<stat>[A-Za-z0-9]+))?"
    r"\s*(?:(?P<op><=|>=|<|>)\s*(?P<value>[0-9.eE+\-]+)\s*"
    r"(?P<unit>ms|us|s|%)?|(?P<finite>finite))"
    r"(?:\s+over\s+(?P<win>[0-9.]+)\s*(?P<winunit>[smh]))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Objective:
    """One parsed SLO objective."""

    metric: str
    stat: str  # p50|p95|p99|rate|last|finite
    op: str  # "<", "<=", ">", ">=" ("<" for finite: burn semantics)
    threshold: float  # normalized (seconds for quantiles, /s for rates)
    window_s: float
    raw: str  # the objective's source text (its identity in events)


def parse_objective(text: str) -> Objective:
    m = _OBJ_RE.match(text)
    if not m:
        raise ValueError(
            f"unparseable SLO objective {text!r} (grammar: "
            f"'metric[:stat] (<|<=|>|>=) value[ms|us|s|%] [over Ns]' "
            f"or 'metric finite')"
        )
    stat = m.group("stat")
    if m.group("finite"):
        if stat is not None:
            raise ValueError(
                f"SLO objective {text!r}: 'finite' takes no :stat"
            )
        stat = "finite"
    elif stat is None:
        stat = "last"
    if stat not in STATS:
        raise ValueError(
            f"SLO objective {text!r}: unknown stat {stat!r} "
            f"(have {', '.join(STATS)})"
        )
    window_s = DEFAULT_WINDOW_S
    if m.group("win"):
        window_s = float(m.group("win")) * _WINDOW_UNITS[m.group("winunit")]
    if window_s <= 0:
        raise ValueError(f"SLO objective {text!r}: window must be > 0")
    if stat == "finite":
        return Objective(
            metric=m.group("metric"), stat=stat, op="<", threshold=1.0,
            window_s=window_s, raw=" ".join(text.split()),
        )
    threshold = float(m.group("value")) * _UNITS[m.group("unit") or ""]
    if threshold <= 0:
        raise ValueError(
            f"SLO objective {text!r}: threshold must be > 0 "
            f"(burn rate = value/threshold)"
        )
    return Objective(
        metric=m.group("metric"), stat=stat, op=m.group("op"),
        threshold=threshold, window_s=window_s,
        raw=" ".join(text.split()),
    )


def parse_slo_spec(text: str) -> List[Objective]:
    """Parse a full ``SLO_SPEC`` (";"- or newline-separated objectives;
    ``#`` starts a comment — file form)."""
    objectives: List[Objective] = []
    for line in (text or "").splitlines() or [""]:
        line = line.split("#", 1)[0]
        for chunk in line.split(";"):
            if chunk.strip():
                objectives.append(parse_objective(chunk))
    return objectives


class SloEngine:
    """Evaluate objectives per window, track state, emit transitions."""

    def __init__(
        self,
        objectives: List[Objective],
        *,
        long_factor: float = DEFAULT_LONG_FACTOR,
        emit=_emit_point,
    ) -> None:
        self.objectives = list(objectives)
        self.long_factor = max(float(long_factor), 1.0)
        self._emit = emit
        self._state: Dict[str, Dict[str, Any]] = {
            o.raw: {"burning": False, "worst_burn": 0.0, "breaches": 0}
            for o in self.objectives
        }

    @classmethod
    def from_env(cls, env=None, **kw) -> Optional["SloEngine"]:
        """Build from ``SLO_SPEC`` — an inline spec, or the path of a
        spec file (checked first, so specs can be version-controlled).
        None when unset/empty."""
        e = os.environ if env is None else env
        spec = e.get("SLO_SPEC")
        if not spec:
            return None
        if os.path.isfile(spec):
            with open(spec) as fh:
                spec = fh.read()
        objectives = parse_slo_spec(spec)
        return cls(objectives, **kw) if objectives else None

    def retain_s(self) -> float:
        """History the aggregator must keep for the slow windows."""
        return max(
            (o.window_s * self.long_factor for o in self.objectives),
            default=DEFAULT_WINDOW_S,
        )

    # -- evaluation --------------------------------------------------------

    def _measure(
        self, obj: Objective, agg, window_s: float, now: Optional[float],
    ) -> Optional[float]:
        if obj.stat in QUANTILE_STATS:
            return agg.span_quantile(
                obj.metric, QUANTILE_STATS[obj.stat],
                window_s=window_s, now=now,
            )
        if obj.stat == "rate":
            return agg.counter_rate(obj.metric, window_s=window_s, now=now)
        # last / finite: gauges are last-value-wins, not windowed.
        v = agg.gauge_last(obj.metric)
        try:
            return None if v is None else float(v)
        except (TypeError, ValueError):
            return float("nan")

    def _burn(self, obj: Objective, value: Optional[float]) -> float:
        """value/threshold normalized so burn > 1 == objective failing."""
        if value is None:
            return 0.0
        if obj.stat == "finite":
            return BURN_MAX if not math.isfinite(value) else 0.0
        if not math.isfinite(value):
            return BURN_MAX
        if obj.op in ("<", "<="):
            return value / obj.threshold
        return BURN_MAX if value <= 0 else obj.threshold / value

    def evaluate(self, agg, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass against an aggregator. Returns the status
        list the rollup snapshot publishes; emits ``slo_breach`` /
        ``slo_recover`` points on transitions."""
        statuses = []
        for obj in self.objectives:
            st = self._state[obj.raw]
            value = self._measure(obj, agg, obj.window_s, now)
            burn = self._burn(obj, value)
            if obj.stat in QUANTILE_STATS or obj.stat == "rate":
                value_long = self._measure(
                    obj, agg, obj.window_s * self.long_factor, now
                )
                burn_long = self._burn(obj, value_long)
            else:
                burn_long = burn  # gauges have no windowed history
            st["worst_burn"] = max(st["worst_burn"], burn)
            if not st["burning"] and burn > 1.0 and burn_long > 1.0:
                st["burning"] = True
                st["breaches"] += 1
                self._emit(
                    "slo_breach", objective=obj.raw, metric=obj.metric,
                    stat=obj.stat, burn=round(burn, 3),
                    burn_long=round(burn_long, 3),
                    value=value, threshold=obj.threshold,
                    window_s=obj.window_s,
                )
            elif st["burning"] and burn <= 1.0:
                st["burning"] = False
                self._emit(
                    "slo_recover", objective=obj.raw, metric=obj.metric,
                    stat=obj.stat, burn=round(burn, 3),
                    value=value, threshold=obj.threshold,
                    window_s=obj.window_s,
                )
            statuses.append({
                "objective": obj.raw,
                "metric": obj.metric,
                "stat": obj.stat,
                "op": obj.op,
                "threshold": obj.threshold,
                "window_s": obj.window_s,
                "value": value,
                "burn": round(min(burn, BURN_MAX), 3),
                "burn_long": round(min(burn_long, BURN_MAX), 3),
                "burning": st["burning"],
                "worst_burn": round(min(st["worst_burn"], BURN_MAX), 3),
                "breaches": st["breaches"],
            })
        return statuses

    @property
    def any_burning(self) -> bool:
        return any(st["burning"] for st in self._state.values())
