"""Per-request critical-path reconstruction from trace-stamped events.

Copied from ``distributeddeeplearning_tpu/obs/traces.py`` (it never
imported jax).

The read side of the trace plane. The serving
stack stamps every per-request emit with a ``trace`` id
(``obs/bus.py`` :func:`~distributeddeeplearning_tpu_torch.obs.bus.trace_ctx`);
this module groups a merged event timeline (``obs/report.py``'s
``load``) by trace and rebuilds each request's critical path:

    router queue → replica queue_wait → prefill → decode ticks
    (per-slot shares) → delivery [+ re-route windows]

with **gap accounting**: the reconstructed phases must sum to the
measured end-to-end latency within the documented tolerance
(``max(GAP_TOL_S, GAP_TOL_FRAC * e2e)``); any unattributed wall is
flagged as ``gap_s`` — never silently absorbed into a phase. Every
chaos-plane intervention that touched the request (hedge quarantine,
splice heal, brownout shed, graceful migration) appears as a causal
annotation carrying its ``cause``.

A trace with an admission point but no terminal outcome is an
**orphan** — the chaos bench gates on there being none after a storm.

The training side reuses the same reconstructor idea for per-step
attribution (:func:`training_attribution`): each ``step`` span's
iteration window decomposes into data wait (``data.wait`` overlap),
dispatch (the step span itself), collective time (``collective*`` /
``comm.*`` spans, when instrumented) and a flagged residual.

File-format-only — safe anywhere the report machinery runs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

#: Gap-accounting tolerance: a reconstruction is consistent when the
#: unattributed wall satisfies ``gap_s <= max(GAP_TOL_S, GAP_TOL_FRAC *
#: e2e_s)``. The floor absorbs scheduler overhead between ticks
#: (reap/admit sweeps, pump sleeps); the fraction absorbs undetected
#: stall windows on a disturbed replica *before* the monitor re-routes
#: (those become attributed ``reroute`` wall only after detection).
GAP_TOL_FRAC = 0.35
GAP_TOL_S = 0.5

#: Phase attribution: trace-stamped span name → critical-path phase.
PHASE_SPANS = {
    "serve.queue_wait": "queue_wait",
    "serve.prefill": "prefill",
    "serve.decode_share": "decode",
    "serve.delivery": "delivery",
    "fleet.reroute": "reroute",
    # Disaggregation (docs/SERVING.md): the prefill→decode handoff
    # window and a scheduled live migration are attributed wall, same
    # bucket as a re-route — time the stream spent between engines.
    "fleet.handoff": "reroute",
    "fleet.migration": "reroute",
}
PHASES = ("router_wait", "queue_wait", "prefill", "decode", "delivery",
          "reroute")

#: Any of these marks the trace as an admitted request (vs. e.g. the
#: scheduler's shared engine-tick trace, which only carries
#: ``serve.decode_step`` spans).
_ADMISSION_NAMES = {
    "fleet.submitted", "serve.queue_depth", "serve.queue_wait",
    "serve.brownout_shed",
}
#: Chaos-plane / lifecycle interventions surfaced as causal annotations.
_INTERVENTION_NAMES = {
    "fleet.reroute", "fleet.splice_mismatch", "fleet.restart_divergence",
    "serve.brownout_shed", "fleet.handoff", "fleet.migration",
}


def gap_tolerance_s(e2e_s: float) -> float:
    """The documented per-request gap budget (see module docstring)."""
    return max(GAP_TOL_S, GAP_TOL_FRAC * max(float(e2e_s), 0.0))


def _w(e: dict) -> Optional[float]:
    """An event's timeline position: merged wall when the loader
    stamped one, raw monotonic otherwise (single-host part files share
    a clock, so raw ``t`` still orders and subtracts correctly)."""
    w = e.get("wall")
    return e.get("t") if w is None else w


def _labels(e: dict) -> dict:
    lab = e.get("labels")
    return lab if isinstance(lab, dict) else {}


def events_by_trace(events: Iterable[dict]) -> Dict[str, List[dict]]:
    """Group an event iterable by its ``trace`` stamp (unstamped events
    are dropped — they belong to no request)."""
    out: Dict[str, List[dict]] = {}
    for e in events:
        tid = e.get("trace")
        if tid:
            out.setdefault(str(tid), []).append(e)
    return out


def _critical_path(tid: str, evs: List[dict]) -> Optional[Dict[str, Any]]:
    """One trace's reconstruction, or None for non-request traces."""
    names = {e.get("name") for e in evs}
    if not (names & _ADMISSION_NAMES):
        return None  # engine-tick trace or stray stamp: not a request
    evs = sorted(evs, key=lambda e: (_w(e) is None, _w(e) or 0.0))
    phases = {p: 0.0 for p in PHASES}
    interventions: List[Dict[str, Any]] = []
    causes: List[str] = []
    outcome: Optional[str] = None
    reason: Optional[str] = None
    tenant: Optional[str] = None
    req: Optional[Any] = None
    tokens = 0
    ttft_s: Optional[float] = None
    attempts = 0
    submit_wall: Optional[float] = None      # fleet.submitted
    first_replica_wall: Optional[float] = None  # first replica submit
    start: Optional[float] = None
    end: Optional[float] = None
    for e in evs:
        name = e.get("name")
        kind = e.get("kind")
        w = _w(e)
        dur = float(e.get("dur") or 0.0)
        lab = _labels(e)
        if w is not None:
            start = w if start is None else min(start, w)
            e_end = w + (dur if kind == "span" else 0.0)
            end = e_end if end is None else max(end, e_end)
        phase = PHASE_SPANS.get(name) if kind == "span" else None
        if phase is not None:
            phases[phase] += dur
        if name == "fleet.submitted":
            tenant = lab.get("tenant", tenant)
            req = lab.get("req", req)
            if w is not None and submit_wall is None:
                submit_wall = w
        elif name == "serve.queue_depth" and w is not None:
            if first_replica_wall is None:
                first_replica_wall = w
        elif name == "serve.queue_wait":
            attempts += 1
        elif name == "serve.ttft" and ttft_s is None:
            ttft_s = dur
        elif name == "serve.request":
            r = lab.get("reason", "done")
            reason = r
            outcome = "done" if r in ("eos", "length") else r
            tokens = max(tokens, int(lab.get("tokens") or 0))
            if req is None:
                req = lab.get("req")
        elif name == "serve.brownout_shed":
            outcome = reason = "brownout"
            tenant = lab.get("tenant", tenant)
        elif name == "serve.cancelled" and outcome is None:
            outcome = reason = "cancelled"
        elif name == "serve.evicted_deadline" and outcome is None:
            outcome = reason = "deadline"
        elif name == "fleet.completed" and outcome is None:
            # Router-side completion marker: the terminal when the
            # replica stream that held serve.request is gone (replica
            # removed, file truncated by a later run).
            outcome = "done"
        if name in _INTERVENTION_NAMES:
            cause = e.get("cause") or (
                "brownout" if name == "serve.brownout_shed" else None
            )
            interventions.append({
                "what": name, "cause": cause, "wall": w,
                "dur_s": round(dur, 6) if kind == "span" else None,
                "replica": lab.get("replica"),
                "src": lab.get("src"),
            })
            if cause:
                causes.append(cause)
    # Router-queue wait: fleet submission → first replica submission.
    # Direct-server traces have no fleet.submitted, so this stays 0.
    if submit_wall is not None and first_replica_wall is not None:
        phases["router_wait"] = max(first_replica_wall - submit_wall, 0.0)
    e2e = max((end or 0.0) - (start or 0.0), 0.0)
    attributed = sum(phases.values())
    gap = e2e - attributed
    tol = gap_tolerance_s(e2e)
    return {
        "trace": tid,
        "req": req,
        "tenant": tenant,
        "outcome": outcome or "orphan",
        "reason": reason,
        "attempts": max(attempts, 1 if outcome else attempts),
        "tokens": tokens,
        "ttft_s": None if ttft_s is None else round(ttft_s, 6),
        "start_wall": start,
        "end_wall": end,
        "e2e_s": round(e2e, 6),
        "phases": {k: round(v, 6) for k, v in phases.items()},
        "gap_s": round(gap, 6),
        "gap_frac": round(gap / e2e, 4) if e2e > 0 else 0.0,
        "gap_tolerance_s": round(tol, 6),
        "within_tolerance": bool(-0.01 <= gap <= tol),
        "interventions": interventions,
        "causes": sorted(set(causes)),
        "events": len(evs),
    }


def reconstruct(loaded_or_events) -> Dict[str, Any]:
    """Rebuild every request trace from a loaded run.

    Accepts ``obs.report.load(...)``'s dict or a bare event iterable.
    Returns ``{"requests": [...], "orphans": [...], "count", "sheds",
    "orphan_count", "within_tolerance", "causes": {cause: n}}`` —
    requests sorted by start time, orphans (admission point without a
    terminal outcome) listed separately so gates can assert on them.
    """
    if isinstance(loaded_or_events, dict):
        events = loaded_or_events.get("events", [])
    else:
        events = list(loaded_or_events)
    requests: List[Dict[str, Any]] = []
    orphans: List[Dict[str, Any]] = []
    for tid, evs in events_by_trace(events).items():
        cp = _critical_path(tid, evs)
        if cp is None:
            continue
        (orphans if cp["outcome"] == "orphan" else requests).append(cp)
    requests.sort(key=lambda r: r.get("start_wall") or 0.0)
    orphans.sort(key=lambda r: r.get("start_wall") or 0.0)
    cause_hist: Dict[str, int] = {}
    for r in requests:
        for c in r["causes"]:
            cause_hist[c] = cause_hist.get(c, 0) + 1
    return {
        "requests": requests,
        "orphans": orphans,
        "count": len(requests),
        "orphan_count": len(orphans),
        "sheds": sum(1 for r in requests if r["outcome"] == "brownout"),
        "within_tolerance": sum(
            1 for r in requests if r["within_tolerance"]
        ),
        "causes": cause_hist,
    }


def _quantile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
    return vals[idx]


def _ran(requests: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Requests that actually ran phases: brownout sheds never did, and
    a skeleton trace (router-side markers only — its replica stream was
    truncated by a later run in the same dir) has nothing to baseline."""
    return [
        r for r in requests
        if r["outcome"] != "brownout" and sum(r["phases"].values()) > 0.0
    ]


def phase_p50s(requests: List[Dict[str, Any]]) -> Dict[str, float]:
    """The fleet-wide p50 of each phase (the digest's baseline)."""
    ran = _ran(requests)
    out: Dict[str, float] = {}
    for p in PHASES:
        out[p] = _quantile([r["phases"].get(p, 0.0) for r in ran], 0.5)
    out["gap"] = _quantile([max(r["gap_s"], 0.0) for r in ran], 0.5)
    out["e2e"] = _quantile([r["e2e_s"] for r in ran], 0.5)
    return out


def top_slow(
    requests: List[Dict[str, Any]], k: int = 5,
    p50s: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """The top-``k`` slowest requests, each decomposed per phase
    against the fleet p50 of that phase and labelled with the dominant
    culprit — the phase (or unattributed gap) with the largest excess
    over its baseline."""
    if p50s is None:
        p50s = phase_p50s(requests)
    ran = _ran(requests)
    rows: List[Dict[str, Any]] = []
    for r in sorted(ran, key=lambda r: r["e2e_s"], reverse=True)[:k]:
        excess = {
            p: r["phases"].get(p, 0.0) - p50s.get(p, 0.0) for p in PHASES
        }
        excess["gap"] = max(r["gap_s"], 0.0) - p50s.get("gap", 0.0)
        culprit = max(excess, key=lambda p: excess[p])
        rows.append({
            **r,
            "excess": {p: round(v, 6) for p, v in excess.items()},
            "culprit": culprit,
            "culprit_excess_s": round(excess[culprit], 6),
        })
    return rows


# ---------------------------------------------------------------------------
# Training-side reuse: per-step attribution
# ---------------------------------------------------------------------------

def _overlap_s(spans: List[dict], lo: float, hi: float) -> float:
    """Total wall of ``spans`` overlapping the window ``[lo, hi]``."""
    total = 0.0
    for e in spans:
        w = _w(e)
        if w is None:
            continue
        s, t = w, w + float(e.get("dur") or 0.0)
        total += max(min(t, hi) - max(s, lo), 0.0)
    return total


def training_attribution(loaded_or_events) -> Optional[Dict[str, Any]]:
    """Per-step attribution for the training loop, reusing the trace
    plane's gap-accounting: each step's iteration window (previous step
    end → this step end) decomposes into data wait (``data.wait`` span
    overlap), dispatch (the ``step`` span itself), collective
    (``collective*`` / ``comm.*`` spans, zero until instrumented) and a
    flagged ``other`` residual. Returns None when no ``step`` spans
    exist (a serving-only run). Per process, so multi-host runs don't
    cross-attribute."""
    if isinstance(loaded_or_events, dict):
        events = loaded_or_events.get("events", [])
    else:
        events = list(loaded_or_events)
    spans = [e for e in events if e.get("kind") == "span"]
    steps = [e for e in spans if e.get("name") == "step"]
    if not steps:
        return None
    by_proc: Dict[Any, Dict[str, List[dict]]] = {}
    for e in spans:
        name = str(e.get("name") or "")
        grp = by_proc.setdefault(e.get("p"), {
            "step": [], "wait": [], "coll": [],
        })
        if name == "step":
            grp["step"].append(e)
        elif name == "data.wait":
            grp["wait"].append(e)
        elif name.startswith("collective") or name.startswith("comm."):
            grp["coll"].append(e)
    totals = {"dispatch_s": 0.0, "data_wait_s": 0.0, "collective_s": 0.0,
              "other_s": 0.0, "wall_s": 0.0}
    slowest: List[Dict[str, Any]] = []
    n_steps = 0
    for p, grp in by_proc.items():
        ordered = sorted(
            (e for e in grp["step"] if _w(e) is not None),
            key=lambda e: _w(e),
        )
        prev_end: Optional[float] = None
        for e in ordered:
            w, dur = _w(e), float(e.get("dur") or 0.0)
            lo = w if prev_end is None else min(prev_end, w)
            hi = w + dur
            window = max(hi - lo, 0.0)
            data_wait = _overlap_s(grp["wait"], lo, w)
            coll = _overlap_s(grp["coll"], lo, hi)
            other = max(window - dur - data_wait - coll, 0.0)
            totals["dispatch_s"] += dur
            totals["data_wait_s"] += data_wait
            totals["collective_s"] += coll
            totals["other_s"] += other
            totals["wall_s"] += window
            n_steps += 1
            slowest.append({
                "p": p, "epoch": _labels(e).get("epoch"),
                "wall_s": round(window, 6), "dispatch_s": round(dur, 6),
                "data_wait_s": round(data_wait, 6),
                "collective_s": round(coll, 6),
                "other_s": round(other, 6),
            })
            prev_end = hi
    slowest.sort(key=lambda s: s["wall_s"], reverse=True)
    return {
        "steps": n_steps,
        "procs": len(by_proc),
        **{k: round(v, 6) for k, v in totals.items()},
        "slowest": slowest[:5],
    }
