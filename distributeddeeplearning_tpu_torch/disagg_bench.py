"""Disaggregated serving bench — split pools vs colocated, gated.

The disaggregation protocol (BASELINE.md style, one JSON line on
stdout; recertify row ``serve_lm_disagg``). One seeded bimodal backlog
(``SERVE_PROFILE=disagg``: long-prefill and long-decode requests, every
prompt opening with the same hot system prefix — ``loadgen.hot_prompt``)
is served twice at EQUAL replica count:

1. **coloc** — the colocated fleet (every replica prefills + decodes);
2. **disagg** — the same fleet split into prefill and decode pools
   (``SERVE_DISAGG=1``): prefill replicas export each slot's block
   table after the first token (the handoff unit — blocks, not a
   replay), the router seats exports on decode replicas, greedy
   prefixes land in the fleet-wide prefix directory, and one scheduled
   live migration moves a running stream between decode replicas
   mid-decode.

Gates (exit non-zero unless ALL hold):

* **TTFT wins** — disagg p99 TTFT (streaming-measured) strictly below
  coloc p99 at the same replica count: prefill slots recycle per
  prefill instead of being held for a whole decode.
* **decode cadence bounded** — disagg p99 inter-token latency (gaps
  after the handoff seam; the seam is reported separately) <=
  ``BENCH_DISAGG_ITL_FACTOR`` x the coloc p99.
* **bitwise parity** — every request's token stream, in BOTH runs,
  is bitwise identical to sequential ``inference.generate`` — the
  handoff/import/migration seams never change a token.
* **prefill once per fleet** — after the storm, the second tenant
  re-sends a prompt the directory already holds: it must complete
  bitwise with ZERO prefill-program executions anywhere in the fleet
  (adopted from the directory) and bump ``serve.directory_hits``.
* **live migration, zero drops** — the scheduled mid-stream migration
  transplants >= 1 running stream (``stats["migrations"]``), and every
  request still finishes (eos/length) with bitwise parity.
* **closed program sets** — zero mid-measure compiles in both runs;
  every engine ends at exactly ``programs_expected`` (prefill-pool
  engines close over the prefill buckets, decode-pool engines over the
  single decode program).

Env knobs (defaults): ``SERVE_REPLICAS`` (4), ``SERVE_POOL_PREFILL`` /
``SERVE_POOL_DECODE`` (0 = auto half/half split),
``SERVE_DISAGG_DIRECTORY`` (1), ``SERVE_DISAGG_PREFETCH`` (1),
``SERVE_SLOTS`` (4), ``SERVE_PREFILLS_PER_STEP`` (2),
``SERVE_REQUESTS`` (24), ``SERVE_PROFILE`` (disagg), ``SERVE_MAX_NEW``
(16 — mixed profile only), ``SERVE_SEED`` (0),
``SERVE_TENANT_WEIGHTS`` ("alpha:1,beta:1"),
``BENCH_DISAGG_PREFIX_LEN`` (32 — hot shared system-prefix tokens),
``BENCH_DISAGG_ITL_FACTOR`` (1.5), ``BENCH_DISAGG_MIGRATE_TICK`` (6 —
earliest router tick the scheduled migration may fire),
``BENCH_MODEL`` (lm_tiny), ``BENCH_VOCAB`` (32000), plus ``OBS_DIR``
for the per-replica event streams and pool gauges.

The twin of ``scripts/disagg_bench.py`` in the port: the same record, gates
and defaults; the engines run on ``BENCH_DEVICE`` (``cuda``; ``cpu`` when
asked for, as the tests do), each threaded replica on its own CUDA
stream, with f32 seeded weights (``models.convert.init_params``, seed
0); ``detail.platform`` names the device type.

Usage::

    python -m distributeddeeplearning_tpu_torch.disagg_bench [--events]
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import time

from distributeddeeplearning_tpu_torch.serving.loadgen import (
    build_tenant_requests,
    hot_prompt,
    percentile,
    profile_shapes,
)


def _emit_record(record: dict) -> None:
    print(json.dumps(record), flush=True)
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.get_bus()
    bus.point("bench_result", **record)
    bus.flush()


def run_fleet(model, params, reqs, scfg, fcfg, max_len, *,
              migrate_tick=0, probe=None):
    """Serve the backlog through the fleet ``fcfg`` describes. With
    ``migrate_tick`` > 0 (disagg only) the bench schedules one live
    migration off a busy decode replica once that router tick passes
    and another decode replica has room. ``probe`` re-sends one
    directory-resident prompt AFTER the storm and reports the fleet's
    prefill-execution delta (the prefill-once-per-fleet oracle)."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.serving import Replica, Request, Router

    router = Router(config=fcfg)
    obs_dir = os.environ.get("OBS_DIR") or None
    npre, _ = fcfg.pool_split()
    for k in range(fcfg.replicas):
        pool = "mixed"
        if fcfg.disagg:
            pool = "prefill" if k < npre else "decode"
        router.add_replica(
            Replica(k, model, params, scfg, max_len=max_len,
                    device=model.tok_embed.device, obs_dir=obs_dir, pool=pool),
            start=True, threaded=True,
        )
    t0 = time.perf_counter()
    while not all(r.state == "ready" for r in router.replicas):
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("fleet warmup timed out")
        time.sleep(0.01)
    # Warm pass (round-robin over the placeable pool) so first-dispatch
    # overheads — and, disaggregated, the first handoff/import seam —
    # stay out of the measurement. Engines precompile their closed
    # program sets at build; this warms the dispatch path, not code.
    warm_placement = router.config.placement
    router.config.placement = "rr"
    for _ in range(fcfg.replicas):
        router.submit(Request(
            prompt=reqs[0]["prompt"], max_new_tokens=2, temperature=0.0,
        ))
    router.drain(timeout=600)
    router.config.placement = warm_placement
    router._ticks = 0

    engines_pre = {
        r.rid: (id(r.engine), r.engine.compile_count)
        for r in router.replicas
    }
    # Client-side wall clock per committed token: TTFT is the first
    # stamp, the inter-token gaps are the decode cadence the ITL gate
    # compares (the first gap — the handoff seam — is split out).
    token_t = [[] for _ in reqs]
    handles = []
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        def cb(_h, toks, i=i):
            now = time.perf_counter()
            token_t[i].extend([now] * len(toks))
        handles.append((r, router.submit(Request(
            prompt=r["prompt"], max_new_tokens=r["max_new"],
            temperature=0.0, on_token=cb,
        ), tenant=r["tenant"])))
    migrated = 0
    migrate_tries = 0
    while router.step():
        if (
            fcfg.disagg and migrate_tick and not migrated
            and router._ticks >= migrate_tick and migrate_tries < 64
        ):
            migrated += _try_migrate(router)
            migrate_tries += 1
        if time.perf_counter() - t0 > 600:
            raise TimeoutError("storm drain timed out")
        time.sleep(0.005)
    dt = time.perf_counter() - t0

    tokens = sum(len(fh.new_tokens) for _, fh in handles)
    ttft_ms = [
        fh.ttft_s * 1e3 for _, fh in handles if fh.ttft_s is not None
    ]
    seam_ms, itl_ms = [], []
    for ts in token_t:
        gaps = [
            (b - a) * 1e3 for a, b in zip(ts, ts[1:])
        ]
        if gaps:
            seam_ms.append(gaps[0])
            itl_ms.extend(gaps[1:])

    probe_out = None
    if probe is not None:
        pre_execs = {
            r.rid: r.engine.prefill_execs for r in router.replicas
        }
        hits0 = router.stats["directory_hits"]
        pfh = router.submit(Request(
            prompt=probe["prompt"], max_new_tokens=probe["max_new"],
            temperature=0.0,
        ), tenant=probe["tenant"])
        t_p = time.perf_counter()
        while router.step():
            if time.perf_counter() - t_p > 120:
                raise TimeoutError("directory probe timed out")
            time.sleep(0.002)
        probe_out = {
            "tokens": [int(t) for t in pfh.new_tokens],
            "outcome": pfh.finish_reason,
            "prefill_execs_delta": sum(
                r.engine.prefill_execs - pre_execs[r.rid]
                for r in router.replicas
            ),
            "directory_hits_delta":
                router.stats["directory_hits"] - hits0,
        }

    ledger = []
    for r in router.replicas:
        pre = engines_pre.get(r.rid)
        ledger.append({
            "replica": r.rid,
            "pool": r.pool,
            "state": r.state,
            "compile_count": r.engine.compile_count if r.engine else 0,
            "programs_expected":
                r.engine.programs_expected if r.engine else 0,
            "compiles_during_measure": (
                0 if pre is None or pre[0] != id(r.engine)
                else r.engine.compile_count - pre[1]
            ),
            "prefill_execs": r.engine.prefill_execs if r.engine else 0,
        })
    run = {
        "disagg": bool(fcfg.disagg),
        "replicas": fcfg.replicas,
        "pools": dict(zip(("prefill", "decode"), fcfg.pool_split()))
        if fcfg.disagg else {"mixed": fcfg.replicas},
        "tokens_per_sec": round(tokens / dt, 1) if dt else 0.0,
        "wall_s": round(dt, 2),
        "tokens": tokens,
        "ttft_p50_ms": round(percentile(ttft_ms, 0.5), 2),
        "ttft_p99_ms": round(percentile(ttft_ms, 0.99), 2),
        "itl_p50_ms": round(percentile(itl_ms, 0.5), 2),
        "itl_p99_ms": round(percentile(itl_ms, 0.99), 2),
        "seam_p99_ms": round(percentile(seam_ms, 0.99), 2),
        "migrated_streams": migrated,
        "stats": dict(router.stats),
        "per_replica": ledger,
    }
    if router.directory is not None:
        run["directory"] = router.directory.snapshot()
    streams = [
        [int(t) for t in fh.new_tokens] for _, fh in handles
    ]
    outcomes = [fh.finish_reason for _, fh in handles]
    router.close()
    return run, streams, outcomes, probe_out


def _try_migrate(router) -> int:
    """One scheduled-migration attempt: pick a decode replica with a
    live imported stream while a sibling decode replica has room, and
    transplant one stream. Returns streams moved (0 when the moment
    isn't right yet — the bench retries next tick)."""
    decode = [r for r in router.replicas if r.pool == "decode"]
    for src in decode:
        with router._lock:
            live = any(
                fh.replica_id == src.rid and fh._sub is not None
                and not fh.done.is_set()
                for fh in router._inflight
            )
        if not live:
            continue
        room = any(
            d.rid != src.rid and d.placeable and d.free_slot_count() > 0
            for d in decode
        )
        if not room:
            continue
        try:
            return router.migrate(src.rid)
        except TimeoutError:
            return 0
    return 0


def main() -> int:
    if "--events" in sys.argv[1:] or os.environ.get("OBS_DIR"):
        from distributeddeeplearning_tpu_torch import obs

        if not os.environ.get("OBS_DIR"):
            os.environ["OBS_DIR"] = os.path.join(
                "runs", f"disagg-bench-{int(time.time())}"
            )
        obs.configure_from_env()
    if os.environ.get("COMPILATION_CACHE_DIR"):
        from distributeddeeplearning_tpu_torch.training.warmup import (
            enable_persistent_cache,
        )

        enable_persistent_cache(os.environ["COMPILATION_CACHE_DIR"])

    import torch
    import numpy as np

    from distributeddeeplearning_tpu_torch.inference import generate
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import FleetConfig, ServeConfig
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device
    from distributeddeeplearning_tpu_torch.serving.fleet.router import (
        parse_tenant_weights,
    )

    env = os.environ
    model_name = env.get("BENCH_MODEL", "lm_tiny")
    vocab = int(env.get("BENCH_VOCAB", "32000"))
    n_requests = int(env.get("SERVE_REQUESTS", "24"))
    max_new = int(env.get("SERVE_MAX_NEW", "16"))
    seed = int(env.get("SERVE_SEED", "0"))
    profile = env.get("SERVE_PROFILE", "disagg")
    prefix_len = int(env.get("BENCH_DISAGG_PREFIX_LEN", "32"))
    itl_factor = float(env.get("BENCH_DISAGG_ITL_FACTOR", "1.5"))
    migrate_tick = int(env.get("BENCH_DISAGG_MIGRATE_TICK", "6"))
    weights = parse_tenant_weights(
        env.get("SERVE_TENANT_WEIGHTS", "alpha:1,beta:1")
    )
    tenants = sorted(weights)

    scfg = ServeConfig.from_env()
    if scfg.kv_layout != "paged":
        scfg.kv_layout = "paged"  # the block table is the handoff unit
    if env.get("SERVE_SLOTS") is None:
        scfg.num_slots = 4
    if env.get("SERVE_PREFILLS_PER_STEP") is None:
        # A prefill-pool replica's whole job is prefills; two per tick
        # keeps the split fleet's admission rate from bottlenecking on
        # the pump cadence (the colocated run gets the same setting —
        # its TTFT is slot-bound, not admission-bound).
        scfg.prefills_per_step = 2
    fcfg = FleetConfig.from_env()
    if env.get("SERVE_REPLICAS") is None:
        fcfg.replicas = 4
    fcfg.tenant_weights = weights
    fcfg = dataclasses.replace(fcfg, chaos_plan="", brownout_stages="")
    fcfg_coloc = dataclasses.replace(fcfg, disagg=False)
    fcfg_disagg = dataclasses.replace(fcfg, disagg=True)
    fcfg_disagg.validate()

    shapes = profile_shapes(profile, max_new)
    prefix = hot_prompt(vocab, prefix_len, seed=seed + 1)
    plens = sorted({tp + prefix_len for tp, _ in shapes})
    max_len = max(
        tp + prefix_len + n_new for tp, n_new in shapes
    )
    if scfg.buckets is None:
        bmax = plens[-1]
        bshort = max(
            [p for p in plens if p <= bmax // 2] or [bmax]
        )
        scfg.buckets = (bshort, bmax) if bshort < bmax else (bmax,)
    metric = "serve_lm_disagg_tokens_per_sec"
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
            tenants, n_requests, 0.0, seed, vocab, shapes,
            shared_prefix=prefix,
        )
        # The prefill-once probe: tenant B re-sends the exact prompt
        # tenant A's longest prefill published to the directory.
        donor_i = max(
            (i for i, r in enumerate(reqs) if r["tenant"] == tenants[0]),
            key=lambda i: len(reqs[i]["prompt"]),
        )
        donor = reqs[donor_i]
        probe = {
            "prompt": donor["prompt"], "max_new": donor["max_new"],
            "tenant": tenants[-1],
        }

        # Sequential oracle — greedy ``inference.generate`` per request
        # (rng-free at temperature 0): the bitwise reference both fleet
        # geometries must reproduce through every seam.
        ref_model = copy.deepcopy(model)
        ref_model.load_state_dict(params)
        ref_model.eval()
        oracle = []
        for r in reqs:
            out = generate(
                ref_model, np.asarray(r["prompt"])[None, :],
                max_new_tokens=r["max_new"], temperature=0.0,
            ).cpu().numpy()
            oracle.append(
                [int(t) for t in out[0, len(r["prompt"]):]]
            )
        probe_oracle = oracle[donor_i]

        coloc, coloc_streams, coloc_outcomes, _ = run_fleet(
            model, params, reqs, scfg, fcfg_coloc, max_len,
        )
        disagg, dis_streams, dis_outcomes, probe_out = run_fleet(
            model, params, reqs, scfg, fcfg_disagg, max_len,
            migrate_tick=migrate_tick, probe=probe,
        )

        parity_coloc = coloc_streams == oracle
        parity_disagg = dis_streams == oracle
        completed_ok = all(
            o in ("eos", "length")
            for o in coloc_outcomes + dis_outcomes
        )
        ttft_ok = disagg["ttft_p99_ms"] < coloc["ttft_p99_ms"]
        itl_ok = (
            disagg["itl_p99_ms"] <= coloc["itl_p99_ms"] * itl_factor
        )
        prefill_once = (
            probe_out is not None
            and probe_out["prefill_execs_delta"] == 0
            and probe_out["directory_hits_delta"] >= 1
            and probe_out["tokens"] == probe_oracle
            and probe_out["outcome"] in ("eos", "length")
        )
        migration_ok = (
            disagg["migrated_streams"] >= 1
            and disagg["stats"]["migrations"] >= 1
        )
        handoffs_ok = disagg["stats"]["handoffs"] >= 1
        closed = all(
            row["compile_count"] == row["programs_expected"]
            for run in (coloc, disagg) for row in run["per_replica"]
        )
        clean = all(
            row["compiles_during_measure"] == 0
            for run in (coloc, disagg) for row in run["per_replica"]
        )
        ok = (
            parity_coloc and parity_disagg and completed_ok and ttft_ok
            and itl_ok and prefill_once and migration_ok and handoffs_ok
            and closed and clean
        )
        detail = {
            "profile": profile,
            "requests": n_requests,
            "replicas": fcfg.replicas,
            "slots_per_replica": scfg.num_slots,
            "buckets": list(scfg.buckets),
            "prefix_len": prefix_len,
            "platform": device.type,
            "pool_split": "prefill:{},decode:{}".format(
                *fcfg_disagg.pool_split()
            ),
            "disagg": disagg,
            "coloc": coloc,
            "ttft_p99_speedup": round(
                coloc["ttft_p99_ms"] / disagg["ttft_p99_ms"], 2
            ) if disagg["ttft_p99_ms"] else 0.0,
            "itl_factor_max": itl_factor,
            "probe": probe_out,
            "gates": {
                "parity_coloc": parity_coloc,
                "parity_disagg": parity_disagg,
                "completed_all": completed_ok,
                "ttft_p99_wins": ttft_ok,
                "itl_p99_bounded": itl_ok,
                "prefill_once_per_fleet": prefill_once,
                "migration_zero_drop": migration_ok,
                "handoffs_flowed": handoffs_ok,
                "programs_closed": closed,
                "zero_midmeasure_recompiles": clean,
            },
        }
        record = {
            "metric": metric,
            "value": disagg["tokens_per_sec"],
            "unit": "tokens/sec",
            "vs_baseline": round(
                disagg["tokens_per_sec"] / coloc["tokens_per_sec"], 2
            ) if coloc["tokens_per_sec"] else 0.0,
            "detail": detail,
        }
        _emit_record(record)
        if not ok:
            failed = [k for k, v in detail["gates"].items()
                      if v is False]
            print(f"DISAGG GATES FAILED: {failed}", file=sys.stderr)
        return 0 if ok else 1
    except Exception as e:  # structured failure record, like bench.py
        _emit_record({
            "metric": metric, "value": 0.0,
            "unit": "tokens/sec", "vs_baseline": 0.0, "error": repr(e),
        })
        raise


if __name__ == "__main__":
    sys.exit(main())
