"""Serving chaos bench — a seeded mixed-verb fault storm, gated.

The fleet tier's robustness protocol (BASELINE.md style, one JSON line
on stdout; recertify row ``serve_lm_chaos``). One seeded multi-tenant
closed backlog (``serving/loadgen.py``) is served twice by the SAME
fleet geometry (``SERVE_REPLICAS`` >= 2 router-fronted replicas, 3
weighted tenants):

1. **undisturbed** — no chaos, the reference run;
2. **storm** — the same backlog under a seeded ``SERVE_CHAOS_PLAN``
   mixing the fleet verbs (default: one of each —
   crash + hang + slow + corrupt + flap, ``chaos.storm_plan``), with a
   brownout ladder armed (``SERVE_BROWNOUT_STAGES``, default
   ``spec_off,shed:1``) and driven by a deterministic injected burn
   window, so degradation is part of the drill.

Gates (exit non-zero unless ALL hold):

* **zero-drop + splice parity** — every non-shed request finishes with
  a token stream BITWISE identical to the undisturbed run (the
  re-route/replay/splice machinery surviving the whole storm); every
  shed request carries the distinct ``brownout`` outcome — nothing is
  silently dropped.
* **corrupt detect-and-heal** — the storm's ``corrupt`` injection is
  caught by the splice verifier (>= 1 ``splice_mismatch``), the
  offending replica is hard-faulted, and the healed streams still gate
  bitwise — the flipped token is never delivered (parity proves it).
* **breaker budget respected** — the ``flap`` verb's crash-loop burns
  through ``SERVE_REPLICA_MAX_RESTARTS`` and MUST open the circuit
  breaker (``breaker_open`` >= 1, the replica removed); every other
  faulted replica rejoins inside its budget.
* **closed program sets** — every replica that survived untouched ends
  with zero mid-measure compiles; replicas rebuilt by the breaker path
  re-close at exactly ``programs_expected`` (rebuild compiles are
  itemized, never silently folded into "zero").
* **bounded TTFT** — storm p99 TTFT (fleet-level, streaming-measured)
  <= ``SERVE_CHAOS_TTFT_MAX_RATIO`` (8.0) x the undisturbed p99.

Env knobs (defaults): ``SERVE_REPLICAS`` (2), ``SERVE_TENANT_WEIGHTS``
("gold:3,silver:2,bronze:1"), ``SERVE_SLOTS`` (4), ``SERVE_BUCKETS``
("8,16"), ``SERVE_REQUESTS`` (36), ``SERVE_MAX_NEW`` (16),
``SERVE_SEED`` (0), ``SERVE_CHAOS_PLAN`` (storm_plan(replicas,
SERVE_CHAOS_SEED)), ``SERVE_CHAOS_SEED`` (0),
``SERVE_REPLICA_MAX_RESTARTS`` (2), ``SERVE_REPLICA_RESTART_BACKOFF``
(0.05), ``SERVE_STRAGGLER_FACTOR`` (4.0), ``SERVE_STRAGGLER_TICKS``
(5), ``SERVE_QUARANTINE_TICKS`` (60), ``SERVE_PUMP_HEARTBEAT_S``
(0.75), ``SERVE_BROWNOUT_STAGES`` ("spec_off,shed:1"),
``SERVE_CHAOS_TTFT_MAX_RATIO`` (8.0), ``BENCH_MODEL`` (lm_tiny),
``BENCH_VOCAB`` (32000), plus ``OBS_DIR`` for the per-replica event
streams and the fleet-health gauges.

The twin of ``scripts/chaos_bench.py`` in the port: the same record, gates
and defaults; the engines run on ``BENCH_DEVICE`` (``cuda``; ``cpu`` when
asked for, as the tests do), each threaded replica on its own CUDA
stream, with f32 seeded weights (``models.convert.init_params``, seed
0); ``detail.platform`` names the device type.

Usage::

    python -m distributeddeeplearning_tpu_torch.chaos_bench [--events]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from distributeddeeplearning_tpu_torch.serving.loadgen import (
    build_tenant_requests,
    percentile,
    profile_shapes,
)


def _emit_record(record: dict) -> None:
    print(json.dumps(record), flush=True)
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.get_bus()
    bus.point("bench_result", **record)
    bus.flush()


def run_storm(model, params, reqs, scfg, fcfg, max_len, tenants, *,
              chaos_plan, brownout_stages, burn_window):
    """Serve the backlog through an n-replica fleet; with a chaos plan
    the storm runs with the brownout ladder driven by a deterministic
    injected burn window (router ticks [a, b) read as burning)."""
    from distributeddeeplearning_tpu_torch.serving import (
        BrownoutLadder,
        ChaosInjector,
        Replica,
        Request,
        Router,
        parse_brownout_stages,
        parse_chaos_plan,
    )

    fcfg = dataclasses.replace(
        fcfg, chaos_plan="", brownout_stages="",
    )
    router = Router(config=fcfg)
    obs_dir = os.environ.get("OBS_DIR") or None
    for k in range(fcfg.replicas):
        router.add_replica(
            Replica(k, model, params, scfg, max_len=max_len,
                    device=model.tok_embed.device, obs_dir=obs_dir),
            start=True, threaded=True,
        )
    t0 = time.perf_counter()
    while not all(r.state == "ready" for r in router.replicas):
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("fleet warmup timed out")
        time.sleep(0.01)
    # Warm pass (round-robin) so first-dispatch overheads stay out of
    # the measurement, exactly like fleet_bench.
    warm_placement = router.config.placement
    router.config.placement = "rr"
    for _ in range(fcfg.replicas):
        router.submit(Request(
            prompt=reqs[0]["prompt"], max_new_tokens=2, temperature=0.0,
        ))
    router.drain(timeout=300)
    router.config.placement = warm_placement

    # Arm the drill AFTER the warm pass so the chaos clock (and the
    # injected burn window) start at storm tick 0, not somewhere inside
    # the warm drain's tick stream.
    router._ticks = 0
    chaos = None
    if chaos_plan:
        chaos = ChaosInjector(
            parse_chaos_plan(chaos_plan), seed=fcfg.chaos_seed
        )
        router.chaos = chaos
        for r in router.replicas:
            r.chaos = chaos
    brownout = None
    if brownout_stages:
        # Deterministic burn signal: the ladder sees "burning" exactly
        # inside the declared router-tick window — the drill's stand-in
        # for a live plane reporting a latency SLO on fire.
        def reader():
            a, b = burn_window
            burning = a <= router._ticks < b
            return {
                "slo": [
                    {"objective": "chaos_drill_ttft", "stat": "p99",
                     "metric": "serve.ttft", "burning": burning}
                ]
            }

        brownout = BrownoutLadder(
            parse_brownout_stages(brownout_stages),
            reader=reader, refresh_s=0.0, escalate_ticks=2,
            recover_ticks=4,
        )
        router.brownout = brownout

    engines_pre = {
        r.rid: (id(r.engine), r.engine.compile_count)
        for r in router.replicas
    }
    handles = []
    t0 = time.perf_counter()
    for r in reqs:
        handles.append((r, router.submit(Request(
            prompt=r["prompt"], max_new_tokens=r["max_new"],
            temperature=0.0,
        ), tenant=r["tenant"])))
    # Paced router ticks (the chaos clock): 5 ms per tick keeps the
    # storm's tick-indexed verbs landing mid-flight instead of all
    # firing before the first prefill, and both runs pace identically.
    while router.step():
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("storm drain timed out: work left and no replica to take it")
        time.sleep(0.005)
    # Run the storm to quiescence: the flap crash-loop must burn its
    # whole cycle count through rejoin/backoff so the breaker verdict
    # is real, and mid-rebuild replicas must settle. Hard cap so an
    # undeliverable directive cannot wedge the bench.
    t_q = time.perf_counter()
    while time.perf_counter() - t_q < 30.0:
        router.step()
        settled = not any(
            r.state in ("faulted", "starting") for r in router.replicas
        )
        if settled and (chaos is None or chaos.quiescent()):
            break
        time.sleep(0.01)
    dt = time.perf_counter() - t0

    tokens = sum(len(fh.new_tokens) for _, fh in handles)
    ttft_ms = [
        fh.ttft_s * 1e3 for _, fh in handles if fh.ttft_s is not None
    ]
    ledger = []
    for r in router.replicas:
        pre = engines_pre.get(r.rid)
        rebuilt = pre is None or pre[0] != id(r.engine)
        ledger.append({
            "replica": r.rid,
            "state": r.state,
            "rebuilt": rebuilt,
            "compile_count": r.engine.compile_count if r.engine else 0,
            "programs_expected":
                r.engine.programs_expected if r.engine else 0,
            "compiles_during_measure": (
                0 if rebuilt or pre is None
                else r.engine.compile_count - pre[1]
            ),
            "leaked_threads": r.leaked_threads,
        })
    run = {
        "replicas": fcfg.replicas,
        "tokens_per_sec": round(tokens / dt, 1) if dt else 0.0,
        "wall_s": round(dt, 2),
        "tokens": tokens,
        "ttft_p50_ms": round(percentile(ttft_ms, 0.5), 2),
        "ttft_p99_ms": round(percentile(ttft_ms, 0.99), 2),
        "stats": dict(router.stats),
        "per_replica": ledger,
        "chaos_fired": list(chaos.fired) if chaos else [],
        "brownout_transitions":
            list(brownout.transitions) if brownout else [],
        "final_replica_count": len(router.replicas),
    }
    streams = [list(fh.new_tokens) for _, fh in handles]
    outcomes = [fh.finish_reason for _, fh in handles]
    splice_ok = all(fh.restart_consistent for _, fh in handles)
    mismatches = sum(fh.splice_mismatches for _, fh in handles)
    # Trace plane: each backlog request's trace id + dispatch count, so
    # the trace-verification gate can key the reconstructed critical
    # paths back to what the storm actually did to each request.
    trace_info = [
        {"trace": fh.trace, "attempts": fh.attempts,
         "outcome": fh.finish_reason}
        for _, fh in handles
    ]
    router.close()
    return run, streams, outcomes, splice_ok, mismatches, trace_info


def trace_gates(storm_traces, obs_dir):
    """Trace-verification gate (docs/OBSERVABILITY.md trace plane):
    reconstruct critical paths from the storm's event files and check

    * every backlog request's trace reconstructs (admission + terminal
      — no orphan);
    * every re-routed (hedged/spliced/migrated) request's trace carries
      the ``fleet.reroute`` child span with a correct ``cause``;
    * every non-shed request's phase sum matches its measured
      end-to-end latency within the documented gap tolerance.

    Returns the gate dict; the caller folds ``*_ok`` values into the
    bench verdict."""
    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.obs import report, traces

    obs.flush()  # the router-side (process-global) stream
    loaded = report.load([obs_dir])
    recon = traces.reconstruct(loaded)
    # The run dir may also hold warm-pass (and stale) traces — gate on
    # the storm backlog's trace ids only.
    ids = {t["trace"] for t in storm_traces}
    by_trace = {
        r["trace"]: r for r in recon["requests"] + recon["orphans"]
        if r["trace"] in ids
    }
    orphans = [
        r["trace"] for r in recon["orphans"] if r["trace"] in ids
    ]
    missing = sorted(ids - set(by_trace))
    rerouted = [
        t for t in storm_traces
        if t["attempts"] >= 2 and t["outcome"] != "brownout"
    ]
    bad_reroutes = []
    for t in rerouted:
        r = by_trace.get(t["trace"])
        spans = [
            iv for iv in (r["interventions"] if r else [])
            if iv["what"] == "fleet.reroute"
        ]
        if not spans or any(
            iv.get("cause") not in ("hedge", "splice", "migration")
            for iv in spans
        ):
            bad_reroutes.append(t["trace"])
    over_tolerance = [
        r["trace"] for tid, r in sorted(by_trace.items())
        if r["outcome"] not in ("brownout", "orphan")
        and not r["within_tolerance"]
    ]
    return {
        "traces_reconstructed": len(by_trace),
        "traces_expected": len(ids),
        "all_reconstructed_ok": not missing and not orphans,
        "trace_orphans": len(orphans),
        "rerouted_requests": len(rerouted),
        "reroute_cause_ok": not bad_reroutes,
        "bad_reroute_traces": bad_reroutes,
        "phase_sum_ok": not over_tolerance,
        "over_tolerance_traces": over_tolerance,
    }


def main() -> int:
    if "--events" in sys.argv[1:] or os.environ.get("OBS_DIR"):
        from distributeddeeplearning_tpu_torch import obs

        if not os.environ.get("OBS_DIR"):
            os.environ["OBS_DIR"] = os.path.join(
                "runs", f"chaos-bench-{int(time.time())}"
            )
        obs.configure_from_env()
    if os.environ.get("COMPILATION_CACHE_DIR"):
        from distributeddeeplearning_tpu_torch.training.warmup import (
            enable_persistent_cache,
        )

        enable_persistent_cache(os.environ["COMPILATION_CACHE_DIR"])

    import torch

    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import FleetConfig, ServeConfig
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device
    from distributeddeeplearning_tpu_torch.serving.chaos import storm_plan
    from distributeddeeplearning_tpu_torch.serving.fleet.router import (
        parse_tenant_weights,
    )

    env = os.environ
    model_name = env.get("BENCH_MODEL", "lm_tiny")
    vocab = int(env.get("BENCH_VOCAB", "32000"))
    n_requests = int(env.get("SERVE_REQUESTS", "36"))
    max_new = int(env.get("SERVE_MAX_NEW", "16"))
    seed = int(env.get("SERVE_SEED", "0"))
    profile = env.get("SERVE_PROFILE", "mixed")
    weights = parse_tenant_weights(
        env.get("SERVE_TENANT_WEIGHTS", "gold:3,silver:2,bronze:1")
    )
    ttft_max_ratio = float(env.get("SERVE_CHAOS_TTFT_MAX_RATIO", "8.0"))

    scfg = ServeConfig.from_env()
    if env.get("SERVE_SLOTS") is None:
        scfg.num_slots = 4
    if scfg.buckets is None:
        scfg.buckets = (8, 16)
    fcfg = FleetConfig.from_env()
    fcfg.tenant_weights = weights
    # Drill-tempo robustness knobs unless the operator pinned them.
    if env.get("SERVE_REPLICA_MAX_RESTARTS") is None:
        fcfg.max_restarts = 2
    if env.get("SERVE_REPLICA_RESTART_BACKOFF") is None:
        fcfg.restart_backoff_s = 0.05
    if env.get("SERVE_STRAGGLER_FACTOR") is None:
        # 4x, not lower: N pump threads time-slicing one core (GIL)
        # show sustained latency asymmetry that a tighter factor reads
        # as a straggler even in the undisturbed run.
        fcfg.straggler_factor = 4.0
    if env.get("SERVE_STRAGGLER_TICKS") is None:
        fcfg.straggler_ticks = 5
    if env.get("SERVE_QUARANTINE_TICKS") is None:
        fcfg.quarantine_ticks = 60
    if env.get("SERVE_PUMP_HEARTBEAT_S") is None:
        fcfg.heartbeat_timeout_s = 0.75
    chaos_plan = env.get("SERVE_CHAOS_PLAN") or storm_plan(
        fcfg.replicas, seed=fcfg.chaos_seed
    )
    brownout_stages = env.get("SERVE_BROWNOUT_STAGES", "spec_off,shed:1")
    burn_window = (20, 40)  # router ticks the injected SLO burn spans

    shapes = profile_shapes(profile, max_new)
    max_len = max(tp + n_new for tp, n_new in shapes)
    tenants = sorted(weights)
    metric = "serve_lm_chaos_tokens_per_sec"
    try:
        device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
        if not model_name.startswith("lm_"):
            raise SystemExit(f"BENCH_MODEL must be an lm_* model, got {model_name!r}")
        # f32 seeded weights (seed 0); each replica's engine takes a
        # copy of ``model`` and loads ``params``.
        params = convert.init_params(
            model_name[3:], vocab, torch.Generator(device=device).manual_seed(0),
            max_len)
        model = get_model(model_name, num_classes=vocab, max_seq_len=max_len,
                          dtype=torch.float32, device=device)
        reqs = build_tenant_requests(
            tenants, n_requests, 0.0, seed, vocab, shapes
        )

        base, base_streams, base_outcomes, _, _, _ = run_storm(
            model, params, reqs, scfg, fcfg, max_len, tenants,
            chaos_plan="", brownout_stages="", burn_window=burn_window,
        )
        (storm, storm_streams, storm_outcomes, splice_ok, mismatches,
         storm_traces) = run_storm(
            model, params, reqs, scfg, fcfg, max_len, tenants,
            chaos_plan=chaos_plan, brownout_stages=brownout_stages,
            burn_window=burn_window,
        )

        shed_idx = [
            i for i, o in enumerate(storm_outcomes) if o == "brownout"
        ]
        kept_idx = [
            i for i in range(len(reqs)) if i not in set(shed_idx)
        ]
        parity = all(
            storm_streams[i] == base_streams[i] for i in kept_idx
        )
        completed_ok = all(
            storm_outcomes[i] in ("eos", "length") for i in kept_idx
        )
        shed_marked = all(
            storm_outcomes[i] == "brownout" for i in shed_idx
        )
        corrupt_armed = any(
            f["kind"] == "corrupt" for f in storm["chaos_fired"]
        )
        corrupt_detected = (
            storm["stats"]["splice_mismatch"] >= 1 and mismatches >= 1
        )
        corrupt_healed = corrupt_detected and splice_ok and parity
        flap_count = next(
            (f.count for f in _parse(chaos_plan) if f.kind == "flap"), 0
        )
        expect_breaker = flap_count > fcfg.max_restarts
        breaker_ok = (
            storm["stats"]["breaker_open"] >= 1 if expect_breaker
            else storm["stats"]["breaker_open"] == 0
        )
        closed = all(
            row["compile_count"] == row["programs_expected"]
            for run in (base, storm) for row in run["per_replica"]
            if row["compile_count"]
        )
        clean = all(
            row["compiles_during_measure"] == 0
            for run in (base, storm) for row in run["per_replica"]
        )
        ttft_ratio = (
            storm["ttft_p99_ms"] / base["ttft_p99_ms"]
            if base["ttft_p99_ms"] else 0.0
        )
        ttft_ok = (
            ttft_ratio <= ttft_max_ratio
            or storm["ttft_p99_ms"] <= base["ttft_p99_ms"]
        )
        brownout_down = any(
            t["direction"] == "down"
            for t in storm["brownout_transitions"]
        )
        brownout_up = any(
            t["direction"] == "up" for t in storm["brownout_transitions"]
        )
        # Trace-verification gate — only when the event streams were
        # captured (OBS_DIR); without files there is nothing to audit.
        tgates = None
        if os.environ.get("OBS_DIR"):
            tgates = trace_gates(storm_traces, os.environ["OBS_DIR"])
        trace_ok = tgates is None or (
            tgates["all_reconstructed_ok"]
            and tgates["reroute_cause_ok"]
            and tgates["phase_sum_ok"]
        )
        ok = (
            parity and completed_ok and shed_marked and closed and clean
            and (corrupt_detected and corrupt_healed if corrupt_armed
                 else True)
            and breaker_ok and ttft_ok and brownout_down and brownout_up
            and trace_ok
        )
        detail = {
            "profile": profile,
            "requests": n_requests,
            "replicas": fcfg.replicas,
            "slots_per_replica": scfg.num_slots,
            "tenant_weights": weights,
            "platform": device.type,
            "chaos_plan": chaos_plan,
            "chaos_seed": fcfg.chaos_seed,
            "brownout_stages": brownout_stages,
            "burn_window_ticks": list(burn_window),
            "max_restarts": fcfg.max_restarts,
            "undisturbed": base,
            "storm": storm,
            "ttft_p99_ratio": round(ttft_ratio, 2),
            "ttft_max_ratio": ttft_max_ratio,
            "gates": {
                "parity_non_shed": parity,
                "completed_non_shed": completed_ok,
                "shed_marked_brownout": shed_marked,
                "shed_count": len(shed_idx),
                "corrupt_detected": corrupt_detected,
                "corrupt_healed": corrupt_healed,
                "splice_mismatches": mismatches,
                "breaker_respected": breaker_ok,
                "breaker_opened": storm["stats"]["breaker_open"],
                "programs_closed": closed,
                "zero_untouched_recompiles": clean,
                "ttft_bounded": ttft_ok,
                "brownout_step_down": brownout_down,
                "brownout_step_up": brownout_up,
                "trace_plane_ok": trace_ok,
            },
        }
        if tgates is not None:
            detail["trace_gates"] = tgates
        record = {
            "metric": metric,
            "value": storm["tokens_per_sec"],
            "unit": "tokens/sec",
            "vs_baseline": round(
                storm["tokens_per_sec"] / base["tokens_per_sec"], 2
            ) if base["tokens_per_sec"] else 0.0,
            "detail": detail,
        }
        _emit_record(record)
        if not ok:
            failed = [k for k, v in detail["gates"].items()
                      if v is False]
            print(f"CHAOS GATES FAILED: {failed}", file=sys.stderr)
        return 0 if ok else 1
    except Exception as e:  # structured failure record, like bench.py
        _emit_record({
            "metric": metric, "value": 0.0,
            "unit": "tokens/sec", "vs_baseline": 0.0, "error": repr(e),
        })
        raise


def _parse(plan: str):
    from distributeddeeplearning_tpu_torch.serving.chaos import parse_chaos_plan

    return parse_chaos_plan(plan)


if __name__ == "__main__":
    sys.exit(main())
