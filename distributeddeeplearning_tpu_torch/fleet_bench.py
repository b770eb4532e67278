"""Multi-replica serving fleet benchmark — 1 vs N replicas on one
seeded multi-tenant load.

The fleet tier's certifiable protocol (BASELINE.md style, one JSON line
on stdout). One seeded multi-tenant request stream
(``serving/loadgen.py`` — tenants cycled round-robin so every tenant
offers the same work mix) is served twice through the fleet router
(``serving/fleet/``): once by a single replica, once by
``SERVE_REPLICAS`` replicas, each replica a warmed SlotEngine + Server
on its own pump thread and event stream. Gates (exit non-zero unless
ALL hold):

* **scaling** — aggregate fleet tokens/sec ≥
  ``SERVE_FLEET_MIN_SCALING`` (1.8) × the single-replica run… on a
  host with at least ``SERVE_REPLICAS`` usable cores. **CPU-honest
  basis** (the decode_audit convention): N pump threads on ONE core
  time-slice — linear replica scaling is *physically unattainable
  there*, so a single-core host derates the gate to
  ``SERVE_FLEET_SINGLE_CORE_MIN`` (0.9; routing/fan-out must cost
  ~nothing) and the record carries ``scaling_basis: "single_core"`` so
  no consumer misreads the ratio as the hardware claim. All other
  gates stay fully enforced either way.
* **flat TTFT** — fleet p99 TTFT ≤ ``SERVE_FLEET_TTFT_MAX_RATIO``
  (1.25) × single-replica p99. TTFT here is the *fleet-level*
  first-token time measured at the client handle via the streaming
  path (submission → first streamed token, queueing + routing +
  prefill included) — a real end-to-end number, not a server-side
  proxy.
* **fairness** — at the moment the contended phase ends (the first
  instant any tenant's backlog empties), every tenant's share of
  delivered tokens is within ``SERVE_FLEET_FAIRNESS_TOL`` (0.15,
  relative) of its weight share — the router's deficit-weighted fair
  queueing holding under a hot-neighbour load.
* **per-request parity** — every request's token stream is bitwise
  identical between the 1-replica and N-replica runs (the serving
  tier's determinism contract surviving routing, placement and
  co-scheduling).
* **closed programs** — every replica in both runs ends with
  ``compile_count == programs_expected`` and zero mid-measure
  recompiles.

Env knobs (defaults): ``SERVE_REPLICAS`` (2), ``SERVE_TENANT_WEIGHTS``
("gold:3,silver:2,bronze:1"), ``SERVE_PLACEMENT`` (affinity),
``SERVE_SLOTS`` (4 per replica), ``SERVE_BUCKETS`` ("8,16"),
``SERVE_REQUESTS`` (48), ``SERVE_MAX_NEW`` (16), ``SERVE_RATE_RPS``
(0 = closed backlog — fairness needs a backlog well past fleet
capacity, or the contended window certifies nothing), ``SERVE_SEED``
(0),
``SERVE_PROFILE`` (mixed), ``SERVE_FLEET_MIN_SCALING`` (1.8),
``SERVE_FLEET_SINGLE_CORE_MIN`` (0.9), ``SERVE_FLEET_TTFT_MAX_RATIO``
(1.25), ``SERVE_FLEET_FAIRNESS_TOL`` (0.15), ``BENCH_MODEL``
(lm_tiny), ``BENCH_VOCAB`` (32000), plus ``OBS_DIR`` (per-replica
``events-p0-s<k>.jsonl`` streams + the ``serve.fleet_pressure`` gauge
land there; ``scripts/obs_watch.py`` renders the per-replica view).

The twin of ``scripts/fleet_bench.py`` in the port: the same record, gates
and defaults; the engines run on ``BENCH_DEVICE`` (``cuda``; ``cpu`` when
asked for, as the tests do), each threaded replica on its own CUDA
stream, with f32 seeded weights (``models.convert.init_params``, seed
0); ``detail.platform`` names the device type.

Usage::

    python -m distributeddeeplearning_tpu_torch.fleet_bench [--events]
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


# The router's pump loop naps between steps (as ``Router.drain`` does):
# replica pumps are Python threads under one GIL, and a router spinning
# without a pause holds it for whole switch intervals while each eager
# op or graph replay of a replica waits for it.
_ROUTER_NAP_S = 0.0005


def _emit_record(record: dict) -> None:
    print(json.dumps(record), flush=True)
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.get_bus()
    bus.point("bench_result", **record)
    bus.flush()


def usable_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def fairness_snapshot(handles_by_tenant) -> dict:
    """Delivered-token share per tenant at this instant."""
    tokens = {
        t: sum(len(fh.new_tokens) for fh in hs)
        for t, hs in handles_by_tenant.items()
    }
    total = sum(tokens.values())
    return {
        t: {"tokens": n, "share": (n / total if total else 0.0)}
        for t, n in tokens.items()
    }


def run_fleet(model, params, reqs, scfg, fcfg, n_replicas, max_len,
              tenants):
    """Build an n-replica fleet, replay the seeded schedule through the
    router (main thread pumps the router; each replica pumps itself),
    and report throughput / TTFT / fairness-at-contention / parity
    streams / per-replica compile ledgers."""
    from distributeddeeplearning_tpu_torch.serving import (
        Replica,
        Request,
        Router,
    )

    router = Router(config=dataclasses.replace(fcfg, replicas=n_replicas))
    obs_dir = os.environ.get("OBS_DIR") or None
    for k in range(n_replicas):
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
    # Warm pass: one request end-to-end per replica (round-robin
    # placement for the warm pass only) so first-dispatch overheads
    # stay out of the measurement.
    warm_router_placement = router.config.placement
    router.config.placement = "rr"
    for i in range(n_replicas):
        router.submit(Request(
            prompt=reqs[0]["prompt"], max_new_tokens=2, temperature=0.0,
        ))
    router.drain(timeout=300)
    router.config.placement = warm_router_placement

    compile_pre = {
        r.rid: r.engine.compile_count for r in router.replicas
    }
    completed_pre = router.stats["completed"]  # the warm pass
    handles = []
    handles_by_tenant = {t: [] for t in tenants}
    fairness = None
    steady_base = None
    pressure_peak = 0.0
    total_slots = sum(r.engine.num_slots for r in router.replicas)

    def pump_once() -> bool:
        nonlocal fairness, steady_base, pressure_peak
        busy = router.step()
        pressure_peak = max(pressure_peak, router.last_pressure)
        if len(handles) != len(reqs):
            return busy
        if fairness is None and steady_base is None:
            # Steady state reached: every slot busy with backlog behind
            # it — delivery shares are pinned by the router's weights
            # from here until the first tenant's backlog empties. The
            # fairness window measures exactly that span, excluding the
            # ramp-up ticks where slots filled in first-cycle order.
            occupied = sum(
                r.server.active_count for r in router.replicas
                if r.server is not None
            )
            if occupied >= total_slots:
                steady_base = fairness_snapshot(handles_by_tenant)
        if fairness is None:
            stats = router.tenant_stats()
            # only the measured tenants — the warm pass's "default"
            # tenant queue is empty by construction
            if any(stats[t]["queued"] == 0 for t in tenants if t in stats):
                # Contended phase over for at least one tenant. No
                # steady-state base (backlog never filled the fleet)
                # means the load never contended: the snapshot is
                # marked unusable and the fairness gate fails, pushing
                # the protocol toward a genuinely contended backlog
                # instead of a vacuous pass.
                snap = fairness_snapshot(handles_by_tenant)
                base = steady_base or {}
                window = {}
                for t in tenants:
                    got = snap[t]["tokens"] - (
                        base[t]["tokens"] if t in base else 0
                    )
                    window[t] = {"tokens": got}
                total = sum(row["tokens"] for row in window.values())
                for t, row in window.items():
                    row["share"] = row["tokens"] / total if total else 0.0
                window["_contended"] = steady_base is not None and total > 0
                fairness = window
        return busy

    t0 = time.perf_counter()
    for r in reqs:
        while time.perf_counter() - t0 < r["arrival_s"]:
            pump_once()
            time.sleep(_ROUTER_NAP_S)
        fh = router.submit(Request(
            prompt=r["prompt"], max_new_tokens=r["max_new"],
            temperature=0.0,
        ), tenant=r["tenant"])
        handles.append(fh)
        handles_by_tenant[r["tenant"]].append(fh)
    while pump_once():
        time.sleep(_ROUTER_NAP_S)
    dt = time.perf_counter() - t0
    if fairness is None:  # trigger never fired (open-loop light load)
        fairness = fairness_snapshot(handles_by_tenant)
        fairness["_contended"] = False

    tokens = sum(len(fh.new_tokens) for fh in handles)
    ttft_ms = [
        fh.ttft_s * 1e3 for fh in handles if fh.ttft_s is not None
    ]
    ledger = [
        {
            "replica": r.rid,
            "compile_count": r.engine.compile_count,
            "programs_expected": r.engine.programs_expected,
            "compiles_during_measure":
                r.engine.compile_count - compile_pre[r.rid],
            "dispatched": r.dispatched,
            "occupancy_mean": round(r.server.occupancy_mean, 3),
        }
        for r in router.replicas
    ]
    run = {
        "replicas": n_replicas,
        "tokens_per_sec": round(tokens / dt, 1),
        "wall_s": round(dt, 2),
        "tokens": tokens,
        "completed": router.stats["completed"] - completed_pre,
        "requeued": router.stats["requeued"],
        "ttft_p50_ms": round(percentile(ttft_ms, 0.5), 2),
        "ttft_p99_ms": round(percentile(ttft_ms, 0.99), 2),
        "pressure_peak": round(pressure_peak, 3),
        "fairness_at_contention": fairness,
        "per_replica": ledger,
    }
    streams = [list(fh.new_tokens) for fh in handles]
    statuses = [fh.finish_reason for fh in handles]
    router.close()
    return run, streams, statuses


def main() -> int:
    if "--events" in sys.argv[1:] or os.environ.get("OBS_DIR"):
        from distributeddeeplearning_tpu_torch import obs

        if not os.environ.get("OBS_DIR"):
            os.environ["OBS_DIR"] = os.path.join(
                "runs", f"fleet-bench-{int(time.time())}"
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
    from distributeddeeplearning_tpu_torch.serving.fleet.router import (
        parse_tenant_weights,
    )

    env = os.environ
    model_name = env.get("BENCH_MODEL", "lm_tiny")
    vocab = int(env.get("BENCH_VOCAB", "32000"))
    n_requests = int(env.get("SERVE_REQUESTS", "48"))
    max_new = int(env.get("SERVE_MAX_NEW", "16"))
    rate_rps = float(env.get("SERVE_RATE_RPS", "0"))
    seed = int(env.get("SERVE_SEED", "0"))
    profile = env.get("SERVE_PROFILE", "mixed")
    weights = parse_tenant_weights(
        env.get("SERVE_TENANT_WEIGHTS", "gold:3,silver:2,bronze:1")
    )
    min_scaling = float(env.get("SERVE_FLEET_MIN_SCALING", "1.8"))
    single_core_min = float(env.get("SERVE_FLEET_SINGLE_CORE_MIN", "0.9"))
    ttft_max_ratio = float(env.get("SERVE_FLEET_TTFT_MAX_RATIO", "1.25"))
    fairness_tol = float(env.get("SERVE_FLEET_FAIRNESS_TOL", "0.15"))

    scfg = ServeConfig.from_env()
    if env.get("SERVE_SLOTS") is None:
        scfg.num_slots = 4  # per REPLICA — the fleet scales by adding pools
    if scfg.buckets is None:
        scfg.buckets = (8, 16)
    fcfg = FleetConfig.from_env()
    fcfg.tenant_weights = weights
    n_replicas = fcfg.replicas

    shapes = profile_shapes(profile, max_new)
    max_len = max(tp + n_new for tp, n_new in shapes)
    tenants = sorted(weights)
    metric = "serve_fleet_scaling_tokens_per_sec"
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
            tenants, n_requests, rate_rps, seed, vocab, shapes
        )

        single, single_streams, single_status = run_fleet(
            model, params, reqs, scfg, fcfg, 1, max_len, tenants
        )
        fleet, fleet_streams, fleet_status = run_fleet(
            model, params, reqs, scfg, fcfg, n_replicas, max_len, tenants
        )

        parity = (
            fleet_streams == single_streams
            and fleet_status == single_status
        )
        scaling = (
            fleet["tokens_per_sec"] / single["tokens_per_sec"]
            if single["tokens_per_sec"] else 0.0
        )
        ttft_ratio = (
            fleet["ttft_p99_ms"] / single["ttft_p99_ms"]
            if single["ttft_p99_ms"] else 0.0
        )
        cores = usable_cores()
        basis = "multi_core" if cores >= n_replicas else "single_core"
        scaling_min = min_scaling if basis == "multi_core" else (
            single_core_min
        )
        weight_total = sum(weights.values())
        fairness_rows = {}
        contended = bool(
            fleet["fairness_at_contention"].get("_contended", True)
        )
        fair_ok = contended  # an uncontended snapshot certifies nothing
        for t, w in weights.items():
            want = w / weight_total
            got = fleet["fairness_at_contention"][t]["share"]
            rel_err = abs(got - want) / want
            within = rel_err <= fairness_tol
            fair_ok = fair_ok and within
            fairness_rows[t] = {
                "weight_share": round(want, 4),
                "token_share": round(got, 4),
                "rel_err": round(rel_err, 4),
                "within_tol": within,
            }
        fairness_rows["_contended"] = contended
        clean = all(
            row["compiles_during_measure"] == 0
            for run in (single, fleet) for row in run["per_replica"]
        )
        closed = all(
            row["compile_count"] == row["programs_expected"]
            for run in (single, fleet) for row in run["per_replica"]
        )
        no_drops = (
            single["completed"] == len(reqs)
            and fleet["completed"] == len(reqs)
        )
        ok = (
            parity and clean and closed and no_drops and fair_ok
            and scaling >= scaling_min
            and (ttft_ratio <= ttft_max_ratio or fleet["ttft_p99_ms"]
                 <= single["ttft_p99_ms"])
        )
        detail = {
            "profile": profile,
            "requests": n_requests,
            "rate_rps": rate_rps,
            "max_len": max_len,
            "buckets": list(scfg.buckets),
            "slots_per_replica": scfg.num_slots,
            "replicas": n_replicas,
            "placement": fcfg.placement,
            "tenant_weights": weights,
            "platform": device.type,
            "cores": cores,
            # CPU-honest scaling semantics (docs/SERVING.md): on a host
            # with fewer cores than replicas the pumps time-slice one
            # core and linear scaling is physically unattainable; the
            # gate derates to "fleet overhead costs ~nothing" and this
            # field says so instead of letting the ratio masquerade as
            # a hardware claim.
            "scaling_basis": basis,
            "scaling_min_applied": scaling_min,
            "scaling_min_multi_core": min_scaling,
            "single": single,
            "fleet": fleet,
            "scaling": round(scaling, 2),
            "ttft_p99_ratio": round(ttft_ratio, 2),
            "ttft_max_ratio": ttft_max_ratio,
            "fairness": fairness_rows,
            "fairness_tol": fairness_tol,
            "parity": bool(parity),
            "no_drops": no_drops,
        }
        record = {
            "metric": metric,
            "value": fleet["tokens_per_sec"],
            "unit": "tokens/sec",
            "vs_baseline": round(scaling, 2),
            "detail": detail,
        }
        _emit_record(record)
        return 0 if ok else 1
    except Exception as e:  # structured failure record, like bench.py
        _emit_record({
            "metric": metric, "value": 0.0,
            "unit": "tokens/sec", "vs_baseline": 0.0, "error": repr(e),
        })
        raise


if __name__ == "__main__":
    sys.exit(main())
