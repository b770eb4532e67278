"""Merge + summarize event-bus JSONL files into a run report.

Copied from ``distributeddeeplearning_tpu/obs/report.py`` (it never
imported jax), the port's launcher calling :func:`merge_run_dir` at
world exit; the trace section reads the port's ``obs/traces.py``.

Consumes the files :mod:`distributeddeeplearning_tpu_torch.obs.bus` writes —
one ``events-p<k>.jsonl`` per process (plus the launcher's
``events-launcher.jsonl``) — and renders the run-level picture the old
stdout logs could never reconstruct: a per-process timeline, span
duration percentiles, host-sync counts by call-site label, compile vs
step time, and cross-process (epoch-boundary) skew.

Merging aligns clocks via each file's ``meta`` line: every event's wall
time is ``meta.wall0 + (t - meta.mono0)``, so files from different
hosts/processes sort into one consistent timeline. ``merge_run_dir`` is
what the launcher calls at world exit ("host 0 merges"); the CLI
(``scripts/obs_report.py``) accepts a run directory, a merged file, or
any set of part files.

This module is deliberately jax-free: a report must be renderable on a
machine with no accelerator stack at all (e.g. from artifacts copied off
a preempted pod).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

MERGED_BASENAME = "events.jsonl"


# ---------------------------------------------------------------------------
# Loading + merging
# ---------------------------------------------------------------------------

def _part_files(directory: str) -> List[str]:
    """Per-process event files in a run dir (flight dumps excluded —
    they duplicate ring events that may also have been flushed)."""
    out = []
    for p in sorted(glob.glob(os.path.join(directory, "events*.jsonl"))):
        if os.path.basename(p) != MERGED_BASENAME:
            out.append(p)
    return out


def discover(paths: Iterable[str]) -> List[str]:
    """Resolve CLI arguments (dirs / files) to concrete event files.
    A directory resolves to its merged ``events.jsonl`` when present,
    else to all its part files."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            merged = os.path.join(p, MERGED_BASENAME)
            if os.path.exists(merged):
                files.append(merged)
            else:
                files.extend(_part_files(p))
        elif os.path.exists(p):
            files.append(p)
        else:
            raise FileNotFoundError(p)
    return files


def _parse_file(path: str) -> Tuple[List[dict], List[dict]]:
    metas, events = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # truncated tail line from a killed process
            if rec.get("kind") in ("meta", "flight_meta"):
                metas.append(rec)
            else:
                events.append(rec)
    return metas, events


def load(paths: Iterable[str]) -> Dict[str, Any]:
    """Load event files into ``{"metas": {p: meta}, "events": [...]}``.

    Every event gains a ``wall`` field computed from its process's meta
    clock pair; events from a process with no meta line keep monotonic
    time only (``wall = None``) and sort last.
    """
    files = discover(paths)
    if not files:
        raise FileNotFoundError("no event files found")
    metas: Dict[Any, dict] = {}
    events: List[dict] = []
    for f in files:
        ms, evs = _parse_file(f)
        for m in ms:
            # First meta per process wins (merged files repeat them).
            metas.setdefault(m.get("p"), m)
        events.extend(evs)
    for e in events:
        m = metas.get(e.get("p"))
        if m is not None and "t" in e:
            e["wall"] = m["wall0"] + (e["t"] - m["mono0"])
        else:
            e.setdefault("wall", None)
    events.sort(key=lambda e: (e["wall"] is None, e.get("wall") or 0.0))
    return {"metas": metas, "events": events, "files": files}


def merge_run_dir(
    directory: str, out_name: str = MERGED_BASENAME
) -> Optional[str]:
    """Merge every part file in ``directory`` into one wall-clock-sorted
    ``events.jsonl`` (meta lines first). Returns the merged path, or
    None when there was nothing to merge."""
    parts = _part_files(directory)
    if not parts:
        return None
    loaded = load(parts)
    out = os.path.join(directory, out_name)
    with open(out, "w") as fh:
        for _, meta in sorted(
            loaded["metas"].items(), key=lambda kv: str(kv[0])
        ):
            fh.write(json.dumps(meta, default=str) + "\n")
        for e in loaded["events"]:
            fh.write(json.dumps(e, default=str) + "\n")
    return out


# ---------------------------------------------------------------------------
# Summarising
# ---------------------------------------------------------------------------

def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(loaded: Dict[str, Any]) -> Dict[str, Any]:
    """Aggregate a loaded run into the report's data model."""
    events = loaded["events"]
    spans: Dict[str, List[float]] = {}
    span_total: Dict[str, float] = {}
    counters: Dict[str, float] = {}
    sync_by_label: Dict[str, int] = {}
    gauges: Dict[str, float] = {}
    gauge_means: Dict[str, List[float]] = {}  # name -> [sum, count]
    points: Dict[str, int] = {}
    # SLO engine transitions (obs/slo.py): per-objective breach/recover
    # timeline + the worst burn rate observed at any transition.
    slo_by_obj: Dict[str, Dict[str, Any]] = {}
    # Pool-ownership timeline (train/serve colocation, serving/
    # arbiter.py): every arbiter decision plus every CHANGE of the
    # pool.train_world / pool.serve_replicas gauges, wall-stamped, so
    # the report shows who held the one device pool when.
    pool_timeline: List[Dict[str, Any]] = []
    pool_last: Dict[str, Any] = {}
    procs: Dict[Any, Dict[str, Any]] = {}
    # name -> epoch -> {proc: end_wall}; cross-process skew is read off
    # the per-epoch boundary (every process ends epoch k once).
    epoch_ends: Dict[Any, Dict[Any, float]] = {}

    for e in events:
        p = e.get("p")
        info = procs.setdefault(
            p, {"events": 0, "first_wall": None, "last_wall": None}
        )
        info["events"] += 1
        w = e.get("wall")
        if w is not None:
            if info["first_wall"] is None:
                info["first_wall"] = w
            info["last_wall"] = w
        kind, name = e.get("kind"), e.get("name", "")
        labels = e.get("labels") or {}
        if kind == "span":
            dur = float(e.get("dur", 0.0))
            spans.setdefault(name, []).append(dur)
            span_total[name] = span_total.get(name, 0.0) + dur
            if name == "epoch" and w is not None:
                epoch_ends.setdefault(labels.get("epoch"), {})[p] = w + dur
        elif kind == "counter":
            counters[name] = counters.get(name, 0) + float(e.get("value", 1))
            if name == "host_sync":
                lbl = labels.get("label", "?")
                sync_by_label[lbl] = sync_by_label.get(lbl, 0) + int(
                    e.get("value", 1)
                )
        elif kind == "gauge":
            gauges[name] = e.get("value")
            if name in ("pool.train_world", "pool.serve_replicas"):
                v = e.get("value")
                if pool_last.get(name) != v:
                    pool_last[name] = v
                    pool_timeline.append(
                        {"wall": w, "event": name, "value": v}
                    )
            try:
                m = gauge_means.setdefault(name, [0.0, 0])
                m[0] += float(e.get("value", 0.0))
                m[1] += 1
            except (TypeError, ValueError):
                pass
        elif kind == "point":
            points[name] = points.get(name, 0) + 1
            if name.startswith("arbiter."):
                pool_timeline.append({
                    "wall": w, "event": name,
                    "labels": {
                        k: v for k, v in sorted(labels.items())
                        if k != "path"
                    },
                })
            if name in ("slo_breach", "slo_recover"):
                obj = labels.get("objective", "?")
                entry = slo_by_obj.setdefault(
                    obj,
                    {"breaches": 0, "recovers": 0, "worst_burn": 0.0,
                     "timeline": []},
                )
                kind_short = "breach" if name == "slo_breach" else "recover"
                entry["breaches" if kind_short == "breach"
                      else "recovers"] += 1
                try:
                    burn = float(labels.get("burn", 0.0))
                except (TypeError, ValueError):
                    burn = 0.0
                entry["worst_burn"] = max(entry["worst_burn"], burn)
                entry["timeline"].append({
                    "wall": w, "event": kind_short, "burn": burn,
                    "value": labels.get("value"),
                })

    span_stats = {}
    for name, durs in spans.items():
        d = sorted(durs)
        span_stats[name] = {
            "count": len(d),
            "total_s": sum(d),
            "p50_ms": _percentile(d, 0.50) * 1e3,
            "p99_ms": _percentile(d, 0.99) * 1e3,
            "max_ms": d[-1] * 1e3,
        }

    # Per-host skew: how far apart processes finish the same epoch.
    skews = []
    for epoch, by_proc in epoch_ends.items():
        if len(by_proc) > 1:
            vals = list(by_proc.values())
            skews.append((max(vals) - min(vals)) * 1e3)
    for p, meta in loaded["metas"].items():
        if p in procs:
            procs[p]["host"] = meta.get("host")
            procs[p]["pid"] = meta.get("pid")
            procs[p]["slice"] = meta.get("slice")

    compile_s = sum(
        v["total_s"] for k, v in span_stats.items() if "compile" in k
    )
    step_s = span_stats.get("step", {}).get("total_s", 0.0)

    # Data-plane view (streamed shards + host prefetch, docs/DATA.md):
    # consumer wait percentiles, buffer depth, delivery rate, and the
    # resume cost — 0 skipped batches on a cursor stream (O(1) seek),
    # the replayed count on legacy datasets.
    data_plane = None
    if any(
        k.startswith("data.") for k in (*span_stats, *counters, *gauges)
    ):
        data_plane = {
            "wait": span_stats.get("data.wait"),
            "buffer_depth": gauges.get("data.buffer_depth"),
            "bytes": counters.get("data.bytes", 0),
            "bytes_per_s": gauges.get("data.bytes_per_s"),
            "resume_skip_batches": gauges.get("data.resume_skip_batches"),
            "resume_skip_ms": gauges.get("data.resume_skip_ms"),
            "resume_seeks": points.get("resume_seek", 0),
        }

    # Serving view (continuous-batching tier): how request time splits
    # across queue-wait vs prefill vs batched decode, plus occupancy.
    serving = None
    if any(
        k.startswith("serve.")
        for k in (*span_stats, *counters, *points, *gauges)
    ):
        occ = gauge_means.get("serve.slot_occupancy")
        serving = {
            "requests_done": points.get("serve.request_done", 0),
            "admitted": counters.get("serve.admitted", 0),
            "completed": counters.get("serve.completed", 0),
            "rejected": counters.get("serve.rejected", 0),
            "deadline_evictions": counters.get("serve.evicted_deadline", 0),
            "cancelled": counters.get("serve.cancelled", 0),
            "tokens": counters.get("serve.tokens", 0),
            "occupancy_mean": occ[0] / occ[1] if occ and occ[1] else None,
            # Paged KV pool (kv_layout="paged"): final free/total block
            # gauges + cumulative prefix-cache hit blocks. All None/0 on
            # the dense layout, which emits none of them.
            "block_pool_free": gauges.get("serve.block_pool_free"),
            "block_pool_total": gauges.get("serve.block_pool_total"),
            "prefix_hits": gauges.get(
                "serve.prefix_hits",
                counters.get("serve.prefix_hit_blocks"),
            ),
            # Dtype-aware byte gauges (quantized decode tier): what one
            # cached token position / the resident params cost — int8
            # engines report the int8 + scale bytes, never just payload.
            "kv_bytes_per_token": gauges.get("serve.kv_bytes_per_token"),
            "param_bytes": gauges.get("serve.param_bytes"),
            # Speculative tier (spec_k > 0): cumulative accepted /
            # rejected draft tokens, the last tick's accept rate and
            # draft/verify wall split. All None/0 without speculation,
            # which emits none of them.
            "spec_tokens_accepted": counters.get(
                "serve.spec_tokens_accepted", 0
            ),
            "spec_tokens_rejected": counters.get(
                "serve.spec_tokens_rejected", 0
            ),
            "spec_accept_rate": gauges.get("serve.spec_accept_rate"),
            "spec_draft_ms": gauges.get("serve.spec_draft_ms"),
            "spec_verify_ms": gauges.get("serve.spec_verify_ms"),
            "queue_wait": span_stats.get("serve.queue_wait"),
            "ttft": span_stats.get("serve.ttft"),
            "prefill": span_stats.get("serve.prefill"),
            "decode_step": span_stats.get("serve.decode_step"),
            "request": span_stats.get("serve.request"),
            # Chaos / self-healing plane (serving fleet failure model,
            # docs/ROBUSTNESS.md): quarantines, splice-mismatch heals,
            # breaker openings, detached pump threads, brownout
            # transitions + the final ladder level. All 0/None on a
            # fleet that never needed to heal, which emits none of them.
            "quarantines": points.get("fleet.quarantine", 0),
            "splice_mismatches": points.get("fleet.splice_mismatch", 0),
            "breaker_opens": points.get("fleet.breaker_open", 0),
            "thread_leaks": points.get("fleet.thread_leaked", 0),
            "chaos_faults": points.get("chaos.fault_fired", 0),
            "brownout_steps": points.get("serve.brownout_step", 0),
            "brownout_shed": counters.get("serve.brownout_shed", 0),
            "brownout_stage": gauges.get("fleet.brownout_stage"),
            # Disaggregated serving (docs/SERVING.md): the final pool
            # split, prefill->decode handoff seam stats, fleet prefix-
            # directory hits and scheduled live migrations. All 0/None
            # on a colocated fleet, which emits none of them.
            "prefill_replicas": gauges.get("fleet.prefill_replicas"),
            "decode_replicas": gauges.get("fleet.decode_replicas"),
            "handoffs": span_stats.get("fleet.handoff"),
            "handoff_ms": gauges.get("serve.handoff_ms"),
            "directory_hits": counters.get("serve.directory_hits", 0),
            "migrations": counters.get("serve.migrations", 0),
        }

    # Trace plane (obs/traces.py): per-request critical paths with gap
    # accounting, reconstructed from the same merged timeline.
    trace_summary = None
    if any("trace" in e for e in events):
        try:
            from distributeddeeplearning_tpu_torch.obs import traces as _traces
            recon = _traces.reconstruct(events)
            if recon["count"] or recon["orphan_count"]:
                p50s = _traces.phase_p50s(recon["requests"])
                trace_summary = {
                    "requests": recon["count"],
                    "orphans": recon["orphan_count"],
                    "sheds": recon["sheds"],
                    "within_tolerance": recon["within_tolerance"],
                    "causes": recon["causes"],
                    "p50s": p50s,
                    "top_slow": _traces.top_slow(
                        recon["requests"], k=3, p50s=p50s
                    ),
                }
        except Exception:
            trace_summary = None  # report renders even off malformed traces

    for entry in slo_by_obj.values():
        entry["timeline"].sort(
            key=lambda e: (e["wall"] is None, e["wall"] or 0.0)
        )
    pool_timeline.sort(
        key=lambda e: (e["wall"] is None, e["wall"] or 0.0)
    )

    run_ids = {m.get("run") for m in loaded["metas"].values()}
    return {
        "run_ids": sorted(r for r in run_ids if r),
        "files": loaded["files"],
        "procs": procs,
        "spans": span_stats,
        "counters": counters,
        "host_sync_by_label": sync_by_label,
        "gauges": gauges,
        "points": points,
        "compile_s": compile_s,
        "step_s": step_s,
        "data_plane": data_plane,
        "serving": serving,
        "traces": trace_summary,
        "slo": slo_by_obj or None,
        "pool": pool_timeline or None,
        "max_epoch_skew_ms": max(skews) if skews else 0.0,
        "epochs_seen": len(epoch_ends),
    }


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def render(summary: Dict[str, Any], top_n: int = 20) -> str:
    """Human-readable run report (one string, print-ready)."""
    out: List[str] = []
    add = out.append
    add(f"run: {', '.join(summary['run_ids']) or '<unknown>'}")
    add(f"files: {len(summary['files'])}")
    add("")
    add("timeline (per process):")
    t0s = [
        i["first_wall"] for i in summary["procs"].values()
        if i.get("first_wall") is not None
    ]
    base = min(t0s) if t0s else 0.0
    for p, info in sorted(summary["procs"].items(), key=lambda kv: str(kv[0])):
        fw, lw = info.get("first_wall"), info.get("last_wall")
        spanstr = (
            f"+{fw - base:8.3f}s .. +{lw - base:8.3f}s"
            if fw is not None else "<no wall clock>"
        )
        host = info.get("host", "?")
        add(
            f"  [{p}] {spanstr}  {info['events']:6d} events"
            f"  host={host} pid={info.get('pid', '?')}"
        )
    add("")
    add(f"{'span':32s} {'count':>7s} {'total s':>9s} "
        f"{'p50 ms':>9s} {'p99 ms':>9s} {'max ms':>9s}")
    ranked = sorted(
        summary["spans"].items(), key=lambda kv: -kv[1]["total_s"]
    )[:top_n]
    for name, s in ranked:
        add(
            f"{name:32s} {s['count']:7d} {s['total_s']:9.3f} "
            f"{s['p50_ms']:9.3f} {s['p99_ms']:9.3f} {s['max_ms']:9.3f}"
        )
    add("")
    add(f"compile vs step time: compile {summary['compile_s']:.3f}s, "
        f"step {summary['step_s']:.3f}s")
    dp = summary.get("data_plane")
    if dp:
        add("")
        add("data plane (streamed shards / host prefetch):")
        w = dp.get("wait")
        if w:
            add(
                f"  wait           n={w['count']:<6d} "
                f"total {w['total_s']:8.3f}s  p50 {w['p50_ms']:8.2f}ms  "
                f"p99 {w['p99_ms']:8.2f}ms"
            )
        parts = []
        if dp.get("buffer_depth") is not None:
            parts.append(f"buffer depth {dp['buffer_depth']:.0f}")
        if dp.get("bytes_per_s"):
            parts.append(f"{dp['bytes_per_s'] / 2**20:.1f} MiB/s")
        if dp.get("bytes"):
            parts.append(f"{dp['bytes'] / 2**20:.1f} MiB delivered")
        if parts:
            add("  " + ", ".join(parts))
        skip = dp.get("resume_skip_batches")
        if skip is not None:
            how = (
                "O(1) cursor seek" if (skip == 0 and dp.get("resume_seeks"))
                else "O(step) prefix replay"
            )
            add(
                f"  resume: {skip:.0f} batch(es) replayed in "
                f"{dp.get('resume_skip_ms') or 0.0:.1f} ms ({how})"
            )
    srv = summary.get("serving")
    if srv:
        add("")
        add("serving (continuous batching):")
        add(
            f"  requests: {srv['requests_done']} done "
            f"({srv['completed']:.0f} completed, "
            f"{srv['deadline_evictions']:.0f} deadline, "
            f"{srv['cancelled']:.0f} cancelled, "
            f"{srv['rejected']:.0f} rejected), "
            f"{srv['tokens']:.0f} tokens"
        )
        if srv["occupancy_mean"] is not None:
            add(f"  slot occupancy (mean over working ticks): "
                f"{srv['occupancy_mean']:.2f}")
        if srv.get("block_pool_total"):
            total = srv["block_pool_total"]
            free = srv.get("block_pool_free") or 0.0
            util = 1.0 - free / total if total else 0.0
            hits = srv.get("prefix_hits") or 0
            add(
                f"  block pool: {free:.0f}/{total:.0f} free at exit "
                f"(final util {util:.2f}), prefix hits {hits:.0f} blocks"
            )
        if srv.get("kv_bytes_per_token") is not None:
            pb = srv.get("param_bytes") or 0.0
            add(
                f"  bytes (dtype-aware): "
                f"{srv['kv_bytes_per_token']:.0f} B KV/token, "
                f"params {pb / 2**20:.1f} MiB resident"
            )
        # Speculative acceptance line: how many draft tokens the verify
        # kept vs threw away, cumulative over the run.
        acc = srv.get("spec_tokens_accepted") or 0
        rej = srv.get("spec_tokens_rejected") or 0
        if acc or rej:
            total = acc + rej
            add(
                f"  speculative: {acc:.0f}/{total:.0f} draft tokens "
                f"accepted ({acc / total:.0%})"
                + (
                    f", last tick accept {srv['spec_accept_rate']:.2f}"
                    if srv.get("spec_accept_rate") is not None else ""
                )
                + (
                    f", draft {srv['spec_draft_ms']:.1f}ms / verify "
                    f"{srv['spec_verify_ms']:.1f}ms per tick"
                    if srv.get("spec_draft_ms") is not None
                    and srv.get("spec_verify_ms") is not None else ""
                )
            )
        # Fleet health line: what the self-healing tier had to do
        # (chaos drills assert on these; a clean run prints nothing).
        heals = []
        if srv.get("chaos_faults"):
            heals.append(f"{srv['chaos_faults']:.0f} chaos faults fired")
        if srv.get("quarantines"):
            heals.append(f"{srv['quarantines']:.0f} quarantine(s)")
        if srv.get("splice_mismatches"):
            heals.append(
                f"{srv['splice_mismatches']:.0f} splice mismatch(es) healed"
            )
        if srv.get("breaker_opens"):
            heals.append(f"{srv['breaker_opens']:.0f} breaker(s) opened")
        if srv.get("thread_leaks"):
            heals.append(f"{srv['thread_leaks']:.0f} pump thread(s) detached")
        if srv.get("brownout_steps"):
            stage = srv.get("brownout_stage")
            heals.append(
                f"{srv['brownout_steps']:.0f} brownout step(s)"
                + (f" (final stage {stage:.0f})" if stage is not None
                   else "")
                + (f", {srv['brownout_shed']:.0f} shed" if srv.get(
                    "brownout_shed") else "")
            )
        if heals:
            add("  fleet health: " + ", ".join(heals))
        # Disaggregation line: the pool split and what flowed over the
        # prefill->decode seam (colocated fleets emit none of this).
        if (
            srv.get("prefill_replicas") is not None
            or srv.get("directory_hits") or srv.get("migrations")
        ):
            ho = srv.get("handoffs")
            add(
                f"  disaggregated: "
                f"{(srv.get('prefill_replicas') or 0):.0f} prefill + "
                f"{(srv.get('decode_replicas') or 0):.0f} decode replicas"
                + (
                    f", {ho['count']} handoff(s) "
                    f"(seam p50 {ho['p50_ms']:.2f}ms)" if ho else ""
                )
                + f", directory hits {srv['directory_hits']:.0f}"
                + (
                    f", {srv['migrations']:.0f} live migration(s)"
                    if srv.get("migrations") else ""
                )
            )
        # Per-request latency anatomy: where the time went.
        for label, key in (
            ("queue wait", "queue_wait"), ("ttft", "ttft"),
            ("prefill", "prefill"), ("decode step", "decode_step"),
            ("request total", "request"),
        ):
            s = srv.get(key)
            if s:
                add(
                    f"  {label:14s} n={s['count']:<6d} "
                    f"total {s['total_s']:8.3f}s  p50 {s['p50_ms']:8.2f}ms  "
                    f"p99 {s['p99_ms']:8.2f}ms"
                )
    tr = summary.get("traces")
    if tr:
        add("")
        add("traces (request critical paths, obs/traces.py):")
        add(
            f"  {tr['requests']} request(s) reconstructed "
            f"({tr['within_tolerance']} within gap tolerance, "
            f"{tr['sheds']} shed), {tr['orphans']} orphan(s)"
        )
        if tr.get("causes"):
            add("  interventions: " + ", ".join(
                f"{c}x{n}" for c, n in sorted(tr["causes"].items())
            ))
        for r in tr.get("top_slow", []):
            add(
                f"  slow: req={r.get('req', '?')} "
                f"e2e {r['e2e_s'] * 1e3:.1f}ms "
                f"culprit={r['culprit']} "
                f"(+{r['culprit_excess_s'] * 1e3:.1f}ms vs p50)"
            )
        add("  full digest: make trace-report")
    slo = summary.get("slo")
    if slo:
        add("")
        add("SLO (breach/recover timeline, obs/slo.py):")
        t0s = [
            e["wall"] for s in slo.values() for e in s["timeline"]
            if e["wall"] is not None
        ]
        slo_base = min(t0s) if t0s else 0.0
        for obj, s in sorted(slo.items()):
            state = (
                "STILL BREACHED" if s["breaches"] > s["recovers"]
                else "recovered"
            )
            add(
                f"  {obj}: {s['breaches']} breach(es), worst burn "
                f"{s['worst_burn']:.2f}x, {state}"
            )
            for e in s["timeline"]:
                when = (
                    f"+{e['wall'] - slo_base:8.3f}s"
                    if e["wall"] is not None else "<no wall>"
                )
                add(
                    f"    {when}  {e['event']:7s}  burn {e['burn']:.2f}x"
                    + (
                        f"  value {e['value']}"
                        if e.get("value") is not None else ""
                    )
                )
    pool = summary.get("pool")
    if pool:
        add("")
        add("pool ownership (arbiter timeline, serving/arbiter.py):")
        t0s = [e["wall"] for e in pool if e["wall"] is not None]
        pool_base = min(t0s) if t0s else 0.0
        for e in pool:
            when = (
                f"+{e['wall'] - pool_base:8.3f}s"
                if e["wall"] is not None else "<no wall>"
            )
            if "value" in e:
                add(f"  {when}  {e['event']:20s}  = {e['value']}")
            else:
                lbls = ", ".join(
                    f"{k}={v}" for k, v in (e.get("labels") or {}).items()
                )
                add(f"  {when}  {e['event']:20s}  {lbls}".rstrip())
    if summary["epochs_seen"]:
        add(f"epochs: {summary['epochs_seen']}, max cross-process "
            f"epoch-end skew: {summary['max_epoch_skew_ms']:.1f} ms")
    if summary["host_sync_by_label"]:
        add("host syncs (device->host materialisations) by call site:")
        for lbl, n in sorted(
            summary["host_sync_by_label"].items(), key=lambda kv: -kv[1]
        ):
            add(f"  {lbl:30s} {n:6d}")
    if summary["counters"]:
        add("counters:")
        for name, v in sorted(summary["counters"].items()):
            add(f"  {name:30s} {v:10.0f}")
    if summary["gauges"]:
        add("final gauges:")
        for name, v in sorted(summary["gauges"].items()):
            add(f"  {name:30s} {v}")
    if summary["points"]:
        add("events: " + ", ".join(
            f"{k}x{v}" for k, v in sorted(summary["points"].items())
        ))
    return "\n".join(out)
