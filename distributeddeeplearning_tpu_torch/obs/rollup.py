"""Windowed rollups over the live event stream — bounded, snapshotted.

Copied from ``distributeddeeplearning_tpu/obs/rollup.py`` (it never
imported jax); the port's serving scheduler reads its snapshot through
``serving/scheduler.AdaptiveAdmissionPolicy``.

The post-mortem report (`obs/report.py`) holds every event in memory;
a *live* consumer cannot. This module aggregates the tailer's stream
into rolling-window rollups with strictly bounded state:

* **counters** — windowed sums + per-second rates;
* **gauges** — last value wins (plus its age, so a reader can tell a
  fresh measurement from a stale one);
* **spans** — p50/p95/p99/max via **fixed-bucket log histograms**: a
  span's duration lands in bucket ``floor(log_g(dur/MIN))``; quantiles
  are read back as the geometric midpoint of the bucket at the target
  rank. Memory is O(buckets) per span name per window slice — never
  O(events) — and the price is a bounded relative error of at most one
  bucket width (``GROWTH − 1`` ≈ 5%), oracle-tested against exact
  percentiles in ``tests/test_live_plane.py``.

Time is sliced into ``slice_s`` sub-windows keyed by integer wall slice;
expired slices are dropped, so a window holds at most
``window_s / slice_s`` slices regardless of event rate or run length.
The aggregator's clock is **event time** (the max wall seen) unless the
caller supplies ``now`` — deterministic under synthetic streams, wall
clock in production.

:func:`write_snapshot` publishes the rollup as an **atomically
replaced** ``rollup.json`` (write-temp + ``os.replace``), so any reader
— dashboard, supervisor, the serving scheduler's admission policy —
always sees one consistent view, never a half-written file.

:class:`LivePlane` ties tailer → aggregator → SLO engine → snapshot
into the one object ``serve_bench`` and the tests drive.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any, Dict, Iterable, List, Optional, Sequence

from distributeddeeplearning_tpu_torch.obs.tail import Tailer

SNAPSHOT_BASENAME = "rollup.json"
SNAPSHOT_SCHEMA = 1

# Log-histogram geometry: ~1 µs .. ~3 h in 5% steps. Fixed bucket count
# => fixed memory and a fixed quantile error bound (one bucket ratio).
HIST_MIN_S = 1e-6
HIST_GROWTH = 1.05
HIST_BUCKETS = 480  # MIN * GROWTH**480 ≈ 1.5e4 s

_LOG_G = math.log(HIST_GROWTH)


def hist_bucket(dur_s: float) -> int:
    """Bucket index for one span duration (clamped to the fixed range)."""
    if dur_s <= HIST_MIN_S:
        return 0
    return min(int(math.log(dur_s / HIST_MIN_S) / _LOG_G), HIST_BUCKETS - 1)


def hist_value(bucket: int) -> float:
    """Representative duration for a bucket (geometric midpoint), so the
    round-trip error is at most sqrt(GROWTH) either way."""
    return HIST_MIN_S * HIST_GROWTH ** (bucket + 0.5)


def hist_quantile(counts: Dict[int, int], q: float) -> float:
    """Quantile from a sparse ``{bucket: count}`` histogram."""
    total = sum(counts.values())
    if total == 0:
        return 0.0
    rank = q * (total - 1)
    seen = 0
    for b in sorted(counts):
        seen += counts[b]
        if seen > rank:
            return hist_value(b)
    return hist_value(max(counts))


class _Slice:
    """Aggregates for one ``slice_s`` sub-window."""

    __slots__ = ("counters", "hists", "span_max", "points", "events",
                 "traces", "reroute_causes")

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.hists: Dict[str, Dict[int, int]] = {}
        self.span_max: Dict[str, float] = {}
        self.points: Dict[str, int] = {}
        self.events = 0
        # Trace plane: distinct request traces touching this slice +
        # chaos re-route causes (hedge/splice/brownout/migration).
        # Bounded by in-flight requests per slice, not event count.
        self.traces: set = set()
        self.reroute_causes: Dict[str, int] = {}


class WindowedAggregator:
    """Rolling rollups over a live event stream, O(window) memory.

    ``window_s`` is the default reporting window; ``retain_s`` (>=
    window) is how much history is kept so longer sub-windows (the SLO
    engine's slow burn-rate window) can still be answered.
    """

    def __init__(
        self,
        window_s: float = 60.0,
        *,
        slice_s: float = 1.0,
        retain_s: Optional[float] = None,
    ) -> None:
        if window_s <= 0 or slice_s <= 0:
            raise ValueError("window_s and slice_s must be > 0")
        self.window_s = float(window_s)
        self.slice_s = float(slice_s)
        self.retain_s = max(float(retain_s or 0.0), self.window_s)
        self._slices: Dict[int, _Slice] = {}
        # name -> (wall, value): last value wins, whole-stream (a gauge
        # that stopped updating is still the current state, just old).
        self.gauges: Dict[str, tuple] = {}
        # proc -> name -> (wall, value): the same last-value-wins gauges
        # keyed by emitting stream. One process's serving fleet runs N
        # replicas, each on its own event stream (proc "p0-s<k>" —
        # obs/bus.py bound_bus); collapsing their occupancy/queue gauges
        # into one last-writer-wins cell would hide N-1 replicas, so the
        # per-proc view keeps each stream's own state. Bounded by
        # (#procs × #gauge names), not by event count.
        self.gauges_by_proc: Dict[str, Dict[str, tuple]] = {}
        self.events_total = 0
        #: event-time clock: the max wall timestamp ever ingested
        self.now: Optional[float] = None

    # -- ingest ------------------------------------------------------------

    def add(self, event: dict) -> None:
        """Ingest one wall-stamped event (tailer output). Events with no
        wall time (file had no meta line) are counted but not windowed —
        they cannot be placed on the shared timeline."""
        self.events_total += 1
        wall = event.get("wall")
        kind = event.get("kind")
        name = event.get("name", "")
        if wall is None:
            return
        if self.now is None or wall > self.now:
            self.now = wall
        key = int(wall // self.slice_s)
        sl = self._slices.get(key)
        if sl is None:
            sl = self._slices[key] = _Slice()
            self._expire()
        sl.events += 1
        tid = event.get("trace")
        if tid:
            sl.traces.add(tid)
        if name == "fleet.reroute" and event.get("cause"):
            cause = str(event["cause"])
            sl.reroute_causes[cause] = sl.reroute_causes.get(cause, 0) + 1
        if kind == "counter":
            try:
                v = float(event.get("value", 1))
            except (TypeError, ValueError):
                v = 1.0
            sl.counters[name] = sl.counters.get(name, 0.0) + v
        elif kind == "gauge":
            prev = self.gauges.get(name)
            if prev is None or wall >= prev[0]:
                self.gauges[name] = (wall, event.get("value"))
            proc = str(event.get("p", "?"))
            per = self.gauges_by_proc.setdefault(proc, {})
            pprev = per.get(name)
            if pprev is None or wall >= pprev[0]:
                per[name] = (wall, event.get("value"))
        elif kind == "span":
            try:
                dur = float(event.get("dur", 0.0))
            except (TypeError, ValueError):
                return
            h = sl.hists.setdefault(name, {})
            b = hist_bucket(dur)
            h[b] = h.get(b, 0) + 1
            if dur > sl.span_max.get(name, 0.0):
                sl.span_max[name] = dur
        elif kind == "point":
            sl.points[name] = sl.points.get(name, 0) + 1

    def add_all(self, events: Iterable[dict]) -> None:
        for e in events:
            self.add(e)

    def _expire(self) -> None:
        if self.now is None:
            return
        floor = int((self.now - self.retain_s) // self.slice_s)
        for key in [k for k in self._slices if k < floor]:
            del self._slices[key]

    # -- window reads ------------------------------------------------------

    def _window_slices(
        self, window_s: Optional[float], now: Optional[float]
    ) -> List[_Slice]:
        now = self.now if now is None else now
        if now is None:
            return []
        w = min(window_s or self.window_s, self.retain_s)
        lo = int((now - w) // self.slice_s)
        # Upper bound: the reader's clock OR the newest event seen,
        # whichever is later. A producer whose wall clock runs slightly
        # ahead of the reader's (cross-host skew) stamps events "in the
        # future" — those belong to the newest window, not the void.
        hi = int(max(now, self.now or now) // self.slice_s)
        return [
            sl for k, sl in self._slices.items() if lo < k <= hi
        ]

    def counter_sum(
        self, name: str, *, window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> float:
        return sum(
            sl.counters.get(name, 0.0)
            for sl in self._window_slices(window_s, now)
        )

    def counter_rate(
        self, name: str, *, window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> float:
        w = min(window_s or self.window_s, self.retain_s)
        return self.counter_sum(name, window_s=window_s, now=now) / w

    def gauge_last(self, name: str) -> Optional[Any]:
        g = self.gauges.get(name)
        return None if g is None else g[1]

    def span_hist(
        self, name: str, *, window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Dict[int, int]:
        merged: Dict[int, int] = {}
        for sl in self._window_slices(window_s, now):
            for b, c in sl.hists.get(name, {}).items():
                merged[b] = merged.get(b, 0) + c
        return merged

    def span_quantile(
        self, name: str, q: float, *, window_s: Optional[float] = None,
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Windowed quantile in seconds (None when no samples)."""
        h = self.span_hist(name, window_s=window_s, now=now)
        if not h:
            return None
        return hist_quantile(h, q)

    # -- snapshot ----------------------------------------------------------

    def snapshot(
        self, *, now: Optional[float] = None, slo: Optional[list] = None,
    ) -> Dict[str, Any]:
        """The consistent view a reader gets: every name seen in the
        current window, rolled up."""
        now = self.now if now is None else now
        slices = self._window_slices(None, now)
        counter_names: set = set()
        span_names: set = set()
        point_names: set = set()
        for sl in slices:
            counter_names.update(sl.counters)
            span_names.update(sl.hists)
            point_names.update(sl.points)
        counters = {}
        for name in sorted(counter_names):
            s = self.counter_sum(name, now=now)
            counters[name] = {
                "sum": s, "rate_per_s": round(s / self.window_s, 6),
            }
        spans = {}
        for name in sorted(span_names):
            h = self.span_hist(name, now=now)
            n = sum(h.values())
            mx = max(
                (sl.span_max.get(name, 0.0) for sl in slices), default=0.0
            )
            spans[name] = {
                "count": n,
                "p50_ms": round(hist_quantile(h, 0.50) * 1e3, 3),
                "p95_ms": round(hist_quantile(h, 0.95) * 1e3, 3),
                "p99_ms": round(hist_quantile(h, 0.99) * 1e3, 3),
                "max_ms": round(mx * 1e3, 3),
            }
        points = {}
        for name in sorted(point_names):
            points[name] = sum(sl.points.get(name, 0) for sl in slices)
        gauges = {}
        for name, (wall, value) in sorted(self.gauges.items()):
            gauges[name] = {
                "value": value,
                "age_s": (
                    round(max(now - wall, 0.0), 3) if now is not None
                    else None
                ),
            }
        snap: Dict[str, Any] = {
            "schema": SNAPSHOT_SCHEMA,
            "generated_wall": now,
            "window_s": self.window_s,
            "events_total": self.events_total,
            "counters": counters,
            "gauges": gauges,
            "spans": spans,
            "points": points,
        }
        # Trace-plane window view: distinct request traces active in
        # the window + chaos re-routes by cause. Published only when
        # the stream is actually trace-stamped.
        trace_ids: set = set()
        reroutes: Dict[str, int] = {}
        for sl in slices:
            trace_ids.update(sl.traces)
            for cause, n in sl.reroute_causes.items():
                reroutes[cause] = reroutes.get(cause, 0) + n
        if trace_ids or reroutes:
            snap["traces"] = {
                "distinct": len(trace_ids),
                "reroutes": dict(sorted(reroutes.items())),
            }
        # Per-stream gauge view (serving fleet): published only when more
        # than one stream emitted gauges — the single-stream case is
        # exactly the flat `gauges` section already.
        if len(self.gauges_by_proc) > 1:
            snap["procs"] = {
                proc: {
                    name: {
                        "value": value,
                        "age_s": (
                            round(max(now - wall, 0.0), 3)
                            if now is not None else None
                        ),
                    }
                    for name, (wall, value) in sorted(per.items())
                }
                for proc, per in sorted(self.gauges_by_proc.items())
            }
        if slo is not None:
            snap["slo"] = slo
        return snap


# ---------------------------------------------------------------------------
# Snapshot persistence (atomic publish / consistent read)
# ---------------------------------------------------------------------------

def write_snapshot(path: str, snapshot: Dict[str, Any]) -> str:
    """Atomically replace ``path`` with ``snapshot`` as JSON. Readers
    racing the writer see either the old snapshot or the new one, whole
    — never a torn file (same-directory temp + ``os.replace``)."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        prefix=".rollup-", suffix=".tmp", dir=directory
    )
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(snapshot, fh, default=str)
            fh.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def read_snapshot(path: str) -> Optional[Dict[str, Any]]:
    """Read a published snapshot; None when absent or (transiently)
    unreadable — a reader must degrade to 'no signal', never crash."""
    try:
        with open(path) as fh:
            snap = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    return snap if isinstance(snap, dict) else None


# ---------------------------------------------------------------------------
# The live plane: tail -> rollup -> SLO -> snapshot
# ---------------------------------------------------------------------------

class LivePlane:
    """One pollable object for the whole live telemetry plane.

    Each :meth:`poll`: drain the tailer, feed the aggregator, evaluate
    the SLO engine (when one is attached — breach/recover points are
    emitted through the process-global bus), and publish the rollup
    snapshot atomically. Everything is host-side file work: no device,
    zero device syncs.
    """

    def __init__(
        self,
        directory: str,
        *,
        window_s: float = 60.0,
        slice_s: float = 1.0,
        slo_engine=None,
        snapshot_path: Optional[str] = None,
    ) -> None:
        self.directory = os.path.abspath(directory)
        self.tailer = Tailer(self.directory)
        retain = window_s
        if slo_engine is not None:
            retain = max(retain, slo_engine.retain_s())
        self.agg = WindowedAggregator(
            window_s, slice_s=slice_s, retain_s=retain
        )
        self.slo = slo_engine
        self.snapshot_path = snapshot_path or os.path.join(
            self.directory, SNAPSHOT_BASENAME
        )
        self.last_snapshot: Optional[Dict[str, Any]] = None

    def poll(
        self, *, now: Optional[float] = None, write: bool = True,
    ) -> Dict[str, Any]:
        """Ingest new events and publish/return the fresh snapshot.
        ``now`` defaults to event time (deterministic); pass
        ``time.time()`` for wall-clock windows in a live dashboard."""
        self.agg.add_all(self.tailer.poll())
        statuses = None
        if self.slo is not None:
            statuses = self.slo.evaluate(self.agg, now=now)
        snap = self.agg.snapshot(now=now, slo=statuses)
        snap["run_dir"] = self.directory
        snap["files"] = len(self.tailer.files)
        if write:
            write_snapshot(self.snapshot_path, snap)
        self.last_snapshot = snap
        return snap
