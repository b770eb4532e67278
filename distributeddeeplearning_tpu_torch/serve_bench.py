"""Continuous-batching serving benchmark of the port: Poisson load vs
sequential, dense vs paged KV pool at a fixed byte budget; one JSON line.

    python -m distributeddeeplearning_tpu_torch.serve_bench [--events]

The twin of the JAX package's ``scripts/serve_bench.py``, with its
protocols, env knobs (and their defaults), metric names, record keys and
gates. A seeded Poisson arrival stream of mixed-length requests
(``serving/loadgen.py``) is served by up to three configurations:

* **sequential baseline**: one request at a time through
  ``inference.generate`` (each distinct shape warmed first);
* **continuous batching** on the selected KV layout
  (``SERVE_KV_LAYOUT=dense|paged``): the same requests submitted to
  ``serving.Server`` on their arrival schedule, drained to completion;
* **compare** (``SERVE_KV_LAYOUT=compare``): dense AND paged engines at
  the same pool-byte budget (``SERVE_POOL_SLOT_BUDGET`` dense rows; the
  paged pool gets those bytes as blocks but serves ``SERVE_SLOTS``
  decode rows). Exits non-zero unless paged reaches ≥2× dense peak
  concurrency (or ≥1.5× tokens/s) with bitwise per-request parity and
  no capture during the measured drain on both engines;
* **quantization compare** (``SERVE_KV_DTYPE`` / ``SERVE_WEIGHT_DTYPE``
  int8 or fp8): the native engine at ``SERVE_POOL_SLOT_BUDGET`` dense
  slots vs the quantized engine holding the same KV-pool bytes, greedy
  load; gated on the teacher-forced greedy match rate
  (``SERVE_QUANT_MATCH_MIN``, 0.95), quantized tokens/s ≥ native, and
  closed program sets with no capture during the measure;
* **speculative compare** (``SERVE_SPEC_K > 0``): plain greedy engine vs
  the speculative one (``SERVE_SPEC_DRAFT`` int8 self-draft or n-gram),
  gated on bitwise greedy parity, tokens/s ≥ ``SERVE_SPEC_MIN_SPEEDUP``
  (1.4) × the baseline, and closed program sets.

"Zero mid-measure recompiles" reads here as "no capture after
``warmup``": every engine captures its closed program set as CUDA graphs
at ``warmup`` (``serving/engine.py``), and ``compile_count`` must not
move across the measured drain (``compiles_during_measure`` 0) and must
equal ``programs_expected``.

Env knobs (defaults in parentheses): ``SERVE_SLOTS`` (8),
``SERVE_BUCKETS`` ("8,16"; longtail default "8,16,32,64,96"),
``SERVE_REQUESTS`` (32), ``SERVE_MAX_NEW`` (16), ``SERVE_RATE_RPS`` (200;
0 = all at t=0), ``SERVE_SEED`` (0), ``SERVE_PROFILE`` (mixed | longtail
| disagg), ``SERVE_KV_LAYOUT`` (dense | paged | compare),
``SERVE_BLOCK_SIZE`` (16), ``SERVE_NUM_BLOCKS`` (0), ``SERVE_POOL_SLOT_BUDGET``
(4), ``SERVE_KV_DTYPE`` / ``SERVE_WEIGHT_DTYPE`` (bf16),
``SERVE_DECODE_KERNEL`` (xla; ``fused`` = the hand-written decode
kernel, ``detail.decode_kernel``), ``SERVE_QUANT_MATCH_MIN`` (0.95),
``SERVE_SPEC_K`` (0), ``SERVE_SPEC_DRAFT`` (int8 | ngram),
``SERVE_SPEC_NGRAM_N`` (3), ``SERVE_SPEC_MIN_SPEEDUP`` (1.4),
``BENCH_MODEL`` (lm_tiny), ``BENCH_VOCAB`` (32000), ``OBS_DIR`` /
``--events``, ``COMPILATION_CACHE_DIR`` (the kernel-library cache). With
``SLO_SPEC`` and ``OBS_DIR`` set the bench runs under the live plane
(rollups and burn rates published to ``<OBS_DIR>/rollup.json``), and
``SERVE_ADMISSION_POLICY=adaptive`` lets the scheduler derate admission
while a latency objective burns.

As the JAX script does, the models are f32 with seeded random weights
(``models.convert.init_params``, seed 0). The device is ``BENCH_DEVICE``
(``cuda``, the port's bench knob): without CUDA the harness prints the
error record and exits non-zero; ``BENCH_DEVICE=cpu`` asks for the CPU
(the tests do), where nothing is captured. ``detail.platform`` names the
device type (``"cuda"`` on the card).
"""

from __future__ import annotations

import json
import os
import sys
import time

# The load mixes, seeded Poisson load and per-shape warmup live in
# serving/loadgen.py; the names are re-exported as the protocol surface.
from distributeddeeplearning_tpu_torch.serving.loadgen import (  # noqa: F401
    MIXED_PROMPT_LENS,
    PROFILES,
    build_requests,
    percentile as _percentile,
    warm_shapes,
)


def _emit_record(record: dict) -> None:
    """The output contract: the JSON line on stdout plus the same record
    as a ``bench_result`` point on the event bus."""
    print(json.dumps(record), flush=True)
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.get_bus()
    bus.point("bench_result", **record)
    bus.flush()


def run_sequential(model, params, reqs, temperature, top_k):
    """One-at-a-time baseline through ``inference.generate``; each
    distinct (prompt_len, max_new) shape is warmed first. ``model``
    holds its weights (``params`` keeps the JAX signature). Returns
    (tokens/sec, per-request outputs, distinct shapes)."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.inference import generate

    n_shapes = warm_shapes(model, params, reqs, temperature, top_k)
    outs = []
    t0 = time.perf_counter()
    for r in reqs:
        out = generate(model, r["prompt"][None], max_new_tokens=r["max_new"],
                       temperature=temperature, top_k=top_k, rng=r["seed"])
        outs.append(out.cpu().numpy()[0])  # the readback ends the request's work
    dt = time.perf_counter() - t0
    tokens = sum(r["max_new"] for r in reqs)
    return tokens / dt, outs, n_shapes


def run_continuous(server, reqs, temperature, top_k):
    """Replay the Poisson schedule against the serving loop: submit each
    request at its arrival offset, pumping the scheduler while waiting;
    drain. Returns (tokens/sec makespan throughput, handles, wall s)."""
    from distributeddeeplearning_tpu_torch.serving import Request

    handles = []
    t0 = time.perf_counter()
    for r in reqs:
        while time.perf_counter() - t0 < r["arrival_s"]:
            server.step()  # keep decoding while the next arrival is due
        handles.append(server.submit(Request(
            prompt=r["prompt"], max_new_tokens=r["max_new"],
            temperature=temperature, top_k=top_k, rng=r["seed"],
        )))
    server.drain()
    dt = time.perf_counter() - t0
    tokens = sum(len(h.new_tokens) for h in handles)
    return tokens / dt, handles, dt


def serve_one_engine(model, params, reqs, seq_outs, *, engine_kwargs,
                     queue_depth, prefills_per_step, temperature, top_k,
                     admission_policy=None):
    """Build and warm one engine (its closed program set captured),
    replay the request schedule through it, and report throughput,
    concurrency, latency percentiles, parity against the sequential
    outputs (None skips the check) and the capture ledger. ``model`` is
    a fresh model the engine takes over (``SlotEngine`` owns and casts
    it). Returns ``(record, per-request new-token streams, engine)``."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.serving import Server, SlotEngine

    engine = SlotEngine(model, params, **engine_kwargs)
    engine.warmup()
    server = Server(
        engine, queue_depth=max(queue_depth, len(reqs)),
        prefills_per_step=prefills_per_step,
        admission_policy=admission_policy,
    )
    # Warm pass: one request end to end, so first-dispatch overheads stay
    # out of the measurement.
    run_continuous(server, reqs[:1], temperature, top_k)
    compile_count_pre = engine.compile_count
    server.stats["peak_active"] = 0

    tps, handles, wall_s = run_continuous(server, reqs, temperature, top_k)

    parity = None if seq_outs is None else all(
        np.array_equal(h.tokens, seq_outs[i][: len(h.tokens)])
        for i, h in enumerate(handles)
    )
    ttft_ms = [h.ttft_s * 1e3 for h in handles if h.ttft_s is not None]
    qwait_ms = [h.queue_wait_s * 1e3 for h in handles if h.queue_wait_s is not None]
    out = {
        "kv_layout": engine.kv_layout,
        "tokens_per_sec": round(tps, 1),
        "parity": None if parity is None else bool(parity),
        "slots": engine.num_slots,
        "peak_concurrent": server.stats["peak_active"],
        "ttft_p50_ms": round(_percentile(ttft_ms, 0.5), 2),
        "ttft_p99_ms": round(_percentile(ttft_ms, 0.99), 2),
        "queue_wait_p50_ms": round(_percentile(qwait_ms, 0.5), 2),
        "queue_wait_p99_ms": round(_percentile(qwait_ms, 0.99), 2),
        "slot_occupancy_mean": round(server.occupancy_mean, 3),
        "decode_steps": server.stats["decode_steps"],
        "compile_count": engine.compile_count,
        "programs_expected": engine.programs_expected,
        "compiles_during_measure": engine.compile_count - compile_count_pre,
        "compile_sec": round(engine.compile_sec, 3),
        "graph_pool_bytes": engine.graph_pool_bytes,
        "wall_s": round(wall_s, 2),
    }
    if engine.allocator is not None:
        snap = engine.allocator.snapshot()
        out["pool"] = {
            "block_size": engine.block_size,
            "capacity_blocks": snap["capacity"],
            "prefix_hit_blocks": snap["prefix_hit_blocks"],
            "evicted": snap["evicted"],
            # utilization at peak demand: how much of the byte budget
            # held live KV when the pool was busiest
            "peak_live_blocks": snap["peak_live"],
            "peak_utilization": round(
                snap["peak_live"] / snap["capacity"], 3
            ) if snap["capacity"] else 0.0,
        }
    return out, [list(h.new_tokens) for h in handles], engine


def kv_slot_bytes(model, max_len: int, kv_dtype: str) -> int:
    """Per-slot KV bytes of a dense row at ``max_len``: codes PLUS f32
    scales when quantized (K and V, every layer and head)."""
    from distributeddeeplearning_tpu_torch.ops import quant

    store = quant.kv_store_dtype(kv_dtype)
    row = model.head_dim * (store or model.dtype).itemsize + (4 if store else 0)
    return 2 * len(model.blocks) * model.num_heads * row * max_len


def teacher_forced_match(engine, reqs, ref_streams):
    """The quantization quality oracle: per-step greedy agreement with
    the reference context forced (``SlotEngine.force_token``). Each
    reference stream replays through the quantized engine; at every step
    the engine answers "given this exact native history, which token
    would I emit?" and agreement is counted."""
    from distributeddeeplearning_tpu_torch.serving import ReqSpec

    total = matched = 0
    i = 0
    active = {}  # slot -> (stream, next position to compare)
    while i < len(reqs) or active:
        for slot in engine.free_slots:
            if i >= len(reqs):
                break
            r, stream = reqs[i], ref_streams[i]
            i += 1
            first, _ = engine.prefill(slot, ReqSpec(
                prompt=r["prompt"], max_new_tokens=len(stream), temperature=0.0,
            ))
            total += 1
            matched += int(first == stream[0])
            if len(stream) == 1:
                engine.release(slot)
            else:
                engine.force_token(slot, int(stream[0]))
                active[slot] = (stream, 1)
        if not active:
            continue
        for slot, tok, _eos in engine.decode_step():
            if slot not in active:
                continue
            stream, c = active[slot]
            total += 1
            matched += int(tok == stream[c])
            c += 1
            if c >= len(stream):
                engine.release(slot)
                del active[slot]
            else:
                engine.force_token(slot, int(stream[c - 1]))
                active[slot] = (stream, c)
    return matched / max(total, 1)


def positional_match(ref_streams, q_streams):
    """Free-running positional agreement (reported, not gated)."""
    tot = hit = 0
    for a, b in zip(ref_streams, q_streams):
        tot += max(len(a), len(b))
        hit += sum(x == y for x, y in zip(a, b))
    return hit / max(tot, 1)


def weight_logit_err(make_model, params, reqs, ref_streams, n_seq: int = 2):
    """Per-step logit error of the weight quantization alone: a
    teacher-forced full forward over reference sequences with exact vs
    int8-quantized weights (max over positions of the max-abs logit
    delta)."""
    import numpy as np
    import torch

    exact, quantized = make_model(), make_model()
    exact.load_state_dict(params)
    quantized.load_state_dict(params)
    quantized.quantize_weights_("int8")
    device = exact.tok_embed.device
    err = 0.0
    with torch.no_grad():
        for r, s in list(zip(reqs, ref_streams))[:n_seq]:
            toks = np.concatenate([r["prompt"], np.asarray(s, np.int32)])
            toks = torch.as_tensor(toks[None], dtype=torch.long, device=device)
            delta = (exact(toks).float() - quantized(toks).float()).abs().max()
            err = max(err, float(delta))
    return err


def run_quant_compare(make_model, params, reqs, cfg, metric, *, budget_slots,
                      max_len, profile, rate_rps, match_min, device):
    """The quantized-decode certification: native engine at
    ``budget_slots`` dense slots vs the quantized engine holding the
    SAME KV-pool bytes (more slots), same seeded greedy load. Gates:
    teacher-forced greedy match rate ≥ ``match_min``, quantized tokens/s
    ≥ native, no capture during the measure and closed program sets on
    both engines (the quality replay reuses the warmed quantized engine,
    so it proves the oracle captures nothing either)."""
    common = dict(
        queue_depth=cfg.queue_depth, prefills_per_step=cfg.prefills_per_step,
        temperature=0.0, top_k=None, admission_policy=cfg.build_admission_policy(),
    )
    ref_run, ref_streams, ref_engine = serve_one_engine(
        make_model(), params, reqs, None,
        engine_kwargs=dict(num_slots=budget_slots, max_len=max_len, buckets=cfg.buckets,
                           decode_kernel=cfg.decode_kernel, device=device),
        **common,
    )
    probe = make_model()
    native_b = kv_slot_bytes(probe, max_len, "bf16")
    quant_b = kv_slot_bytes(probe, max_len, cfg.kv_dtype)
    slots_q = max(budget_slots, int(budget_slots * native_b // quant_b))
    q_run, q_streams, q_engine = serve_one_engine(
        probe, params, reqs, None,
        engine_kwargs=dict(num_slots=slots_q, max_len=max_len, buckets=cfg.buckets,
                           kv_dtype=cfg.kv_dtype, weight_dtype=cfg.weight_dtype,
                           decode_kernel=cfg.decode_kernel, device=device),
        **common,
    )
    compile_pre = q_engine.compile_count
    match = teacher_forced_match(q_engine, reqs, ref_streams)
    free_match = positional_match(ref_streams, q_streams)
    logit_err = (weight_logit_err(make_model, params, reqs, ref_streams)
                 if cfg.weight_dtype != "bf16" else None)
    # Label the quantized side by its actual tier (the kv tier names the
    # engine when both are set).
    qlabel = cfg.kv_dtype if cfg.kv_dtype != "bf16" else cfg.weight_dtype
    tps_ratio = (q_run["tokens_per_sec"] / ref_run["tokens_per_sec"]
                 if ref_run["tokens_per_sec"] else 0.0)
    capacity_ratio = (q_run["peak_concurrent"] / ref_run["peak_concurrent"]
                      if ref_run["peak_concurrent"] else 0.0)
    detail = {
        "profile": profile,
        "requests": len(reqs),
        "buckets": list(cfg.buckets),
        "rate_rps": rate_rps,
        "max_len": max_len,
        "platform": device.type,
        "kv_dtype": cfg.kv_dtype,
        "weight_dtype": cfg.weight_dtype,
        "decode_kernel": cfg.decode_kernel,
        "pool_budget_slots": budget_slots,
        "kv_slot_bytes": {"bf16": int(native_b), qlabel: int(quant_b)},
        "kv_bytes_per_token": {
            "bf16": ref_engine.byte_accounting()["kv_bytes_per_token"],
            qlabel: q_engine.byte_accounting()["kv_bytes_per_token"],
        },
        "param_bytes": {
            "bf16": ref_engine.byte_accounting()["param_bytes"],
            qlabel: q_engine.byte_accounting()["param_bytes"],
        },
        "bf16": ref_run,
        qlabel: q_run,
        "tps_ratio": round(tps_ratio, 2),
        "capacity_ratio": round(capacity_ratio, 2),
        # Teacher-forced per-step agreement (gated) vs free-running
        # positional agreement (reported).
        "match_rate": round(match, 4),
        "match_rate_min": match_min,
        "match_rate_freerun": round(free_match, 4),
        "weight_logit_err_max": None if logit_err is None else round(logit_err, 5),
    }
    clean = (ref_run["compiles_during_measure"] == 0
             and q_run["compiles_during_measure"] == 0
             and q_engine.compile_count == compile_pre)
    closed = all(r["compile_count"] == r["programs_expected"] for r in (ref_run, q_run))
    ok = clean and closed and match >= match_min and tps_ratio >= 1.0
    _emit_record({
        "metric": metric,
        # headline: quantized throughput at the shared byte budget
        "value": q_run["tokens_per_sec"],
        "unit": "tokens/sec",
        "vs_baseline": round(tps_ratio, 2),
        "detail": detail,
    })
    return 0 if ok else 1


def run_spec_compare(make_model, params, reqs, cfg, metric, *, max_len, profile,
                     rate_rps, min_speedup, device):
    """The speculative-decode certification (``SERVE_SPEC_K > 0``): plain
    greedy engine vs the speculative engine (same slots, load and pool
    geometry). Gates: bitwise greedy parity, speculative tokens/s ≥
    ``min_speedup`` × the baseline, no capture during the measure and
    program sets closed at their static counts on both engines."""
    import numpy as np

    common = dict(
        queue_depth=cfg.queue_depth, prefills_per_step=cfg.prefills_per_step,
        temperature=0.0, top_k=None, admission_policy=cfg.build_admission_policy(),
    )
    base_kwargs = dict(num_slots=cfg.num_slots, max_len=max_len, buckets=cfg.buckets,
                       decode_kernel=cfg.decode_kernel, device=device)
    ref_run, ref_streams, _ = serve_one_engine(
        make_model(), params, reqs, None, engine_kwargs=base_kwargs, **common)
    spec_kwargs = dict(base_kwargs, spec_k=cfg.spec_k, spec_draft=cfg.spec_draft,
                       spec_ngram_n=cfg.spec_ngram_n)
    spec_run, spec_streams, spec_engine = serve_one_engine(
        make_model(), params, reqs, None, engine_kwargs=spec_kwargs, **common)
    parity = spec_streams == ref_streams  # bitwise, token for token
    st = spec_engine.spec_stats
    rates = st["accept_rates"]
    speedup = (spec_run["tokens_per_sec"] / ref_run["tokens_per_sec"]
               if ref_run["tokens_per_sec"] else 0.0)
    detail = {
        "profile": profile,
        "requests": len(reqs),
        "buckets": list(cfg.buckets),
        "rate_rps": rate_rps,
        "max_len": max_len,
        "platform": device.type,
        "spec_k": cfg.spec_k,
        "spec_draft": cfg.spec_draft,
        "decode_kernel": cfg.decode_kernel,
        "greedy": ref_run,
        "spec": spec_run,
        "speedup": round(speedup, 2),
        "min_speedup": min_speedup,
        "parity": bool(parity),
        "accept_rate_mean": round(float(np.mean(rates)), 4) if rates else None,
        "accept_rate_p50": round(_percentile(sorted(rates), 0.5), 4) if rates else None,
        "tokens_per_verify": round(st["tokens_committed"] / max(st["verify_ticks"], 1), 2),
        "draft_ms_total": round(st["draft_s"] * 1e3, 1),
        "verify_ms_total": round(st["verify_s"] * 1e3, 1),
        "draft_bytes": {k: v for k, v in spec_engine.byte_accounting().items()
                        if k.startswith("draft_")} or None,
    }
    clean = (ref_run["compiles_during_measure"] == 0
             and spec_run["compiles_during_measure"] == 0)
    closed = all(r["compile_count"] == r["programs_expected"] for r in (ref_run, spec_run))
    ok = clean and closed and parity and speedup >= min_speedup
    _emit_record({
        "metric": metric,
        # headline: speculative throughput on the same greedy load
        "value": spec_run["tokens_per_sec"],
        "unit": "tokens/sec",
        "vs_baseline": round(speedup, 2),
        "detail": detail,
    })
    return 0 if ok else 1


def start_live_plane(obs_dir):
    """Run the live telemetry plane (tail -> rollup -> SLO ->
    rollup.json) in a background thread for the duration of the bench:
    what an adaptive admission policy reads. Returns ``(stop_event,
    thread)``, or ``(None, None)`` when ``SLO_SPEC`` is unset."""
    import threading

    from distributeddeeplearning_tpu_torch.obs.rollup import LivePlane
    from distributeddeeplearning_tpu_torch.obs.slo import SloEngine

    slo = SloEngine.from_env()
    if slo is None:
        return None, None
    plane = LivePlane(obs_dir, slo_engine=slo)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            plane.poll(now=time.time())
            stop.wait(0.2)
        plane.poll(now=time.time())

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return stop, t


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--events" in argv or os.environ.get("OBS_DIR"):
        from distributeddeeplearning_tpu_torch import obs

        if not os.environ.get("OBS_DIR"):
            os.environ["OBS_DIR"] = os.path.join("runs", f"serve-bench-{int(time.time())}")
        obs.configure_from_env()
    # Live plane: with SLO_SPEC set the bench runs under its own
    # telemetry, and SERVE_ADMISSION_POLICY=adaptive closes the loop.
    plane_stop = plane_thread = None
    if os.environ.get("OBS_DIR") and os.environ.get("SLO_SPEC"):
        plane_stop, plane_thread = start_live_plane(os.environ["OBS_DIR"])
    if os.environ.get("COMPILATION_CACHE_DIR"):
        from distributeddeeplearning_tpu_torch.training.warmup import enable_persistent_cache

        enable_persistent_cache(os.environ["COMPILATION_CACHE_DIR"])

    import torch

    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import ServeConfig
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device

    env = os.environ
    model_name = env.get("BENCH_MODEL", "lm_tiny")
    # A realistic LM vocab by default: the output projection over the
    # full vocab is the term continuous batching amortises across slots.
    vocab = int(env.get("BENCH_VOCAB", "32000"))
    n_requests = int(env.get("SERVE_REQUESTS", "32"))
    max_new = int(env.get("SERVE_MAX_NEW", "16"))
    rate_rps = float(env.get("SERVE_RATE_RPS", "200"))
    seed = int(env.get("SERVE_SEED", "0"))
    profile = env.get("SERVE_PROFILE", "mixed")
    layout = env.get("SERVE_KV_LAYOUT", "dense")
    budget_slots = int(env.get("SERVE_POOL_SLOT_BUDGET", "4"))
    if profile not in PROFILES:
        raise SystemExit(f"unknown SERVE_PROFILE {profile!r}")
    if layout not in ("dense", "paged", "compare"):
        raise SystemExit(f"unknown SERVE_KV_LAYOUT {layout!r}")
    shapes = PROFILES[profile] or [(tp, max_new) for tp in MIXED_PROMPT_LENS]
    cfg = ServeConfig.from_env()
    if cfg.buckets is None:
        cfg.buckets = (8, 16) if profile == "mixed" else (8, 16, 32, 64, 96)
    max_len = max(tp + n_new for tp, n_new in shapes)
    # Quantization compare: its own mode, greedy load, engine against
    # engine at a fixed KV-pool byte budget.
    quant = cfg.kv_dtype != "bf16" or cfg.weight_dtype != "bf16"
    if quant and layout != "dense":
        raise SystemExit(
            "the quantization compare runs on the dense layout — unset "
            "SERVE_KV_LAYOUT or the quantized (int8/fp8) dtypes"
        )
    spec = cfg.spec_k > 0
    if spec and (quant or layout != "dense"):
        raise SystemExit(
            "the speculative compare runs on the dense native-dtype "
            "engines — unset SERVE_KV_LAYOUT / the quantized dtypes or "
            "SERVE_SPEC_K"
        )
    match_min = float(env.get("SERVE_QUANT_MATCH_MIN", "0.95"))
    min_speedup = float(env.get("SERVE_SPEC_MIN_SPEEDUP", "1.4"))
    temperature, top_k = (0.0, None) if quant else (0.8, 40)
    metric = (
        "serve_spec_vs_greedy_tokens_per_sec" if spec
        else "serve_int8_vs_bf16_tokens_per_sec" if quant
        else "serve_paged_vs_dense_capacity" if layout == "compare"
        else "serve_continuous_tokens_per_sec"
    )
    if spec:
        # The verify window writes spec_k lookahead positions past a
        # request's last token; both engines get the same headroom.
        max_len += cfg.spec_k
    try:
        device = resolve_device(env.get("BENCH_DEVICE", "cuda"))
        if not model_name.startswith("lm_"):
            raise SystemExit(f"BENCH_MODEL must be an lm_* model, got {model_name!r}")
        params = convert.init_params(model_name[3:], vocab,
                                     torch.Generator(device=device).manual_seed(0), max_len)

        def make_model():
            return get_model(model_name, num_classes=vocab, max_seq_len=max_len,
                             dtype=torch.float32, device=device)

        reqs = build_requests(n_requests, rate_rps, seed, vocab, shapes)
        if spec:
            return run_spec_compare(
                make_model, params, reqs, cfg, metric, max_len=max_len, profile=profile,
                rate_rps=rate_rps, min_speedup=min_speedup, device=device)
        if quant:
            return run_quant_compare(
                make_model, params, reqs, cfg, metric, budget_slots=budget_slots,
                max_len=max_len, profile=profile, rate_rps=rate_rps, match_min=match_min,
                device=device)

        seq_model = make_model()
        seq_model.load_state_dict(params)
        seq_model.eval()
        seq_tps, seq_outs, seq_shapes = run_sequential(
            seq_model, params, reqs, temperature, top_k)
        del seq_model

        budget_tokens = budget_slots * max_len
        common = dict(
            queue_depth=cfg.queue_depth, prefills_per_step=cfg.prefills_per_step,
            temperature=temperature, top_k=top_k,
        )
        runs = {}
        if layout in ("dense", "compare"):
            runs["dense"], _, _ = serve_one_engine(
                make_model(), params, reqs, seq_outs,
                engine_kwargs=dict(
                    num_slots=budget_slots if layout == "compare" else cfg.num_slots,
                    max_len=max_len, buckets=cfg.buckets,
                    decode_kernel=cfg.decode_kernel, device=device,
                ),
                admission_policy=cfg.build_admission_policy(), **common,
            )
        if layout in ("paged", "compare"):
            runs["paged"], _, _ = serve_one_engine(
                make_model(), params, reqs, seq_outs,
                engine_kwargs=dict(
                    num_slots=cfg.num_slots, max_len=max_len, buckets=cfg.buckets,
                    decode_kernel=cfg.decode_kernel, kv_layout="paged",
                    block_size=cfg.block_size,
                    num_blocks=cfg.num_blocks or budget_tokens // cfg.block_size + 1,
                    prefix_cache=cfg.prefix_cache, device=device,
                ),
                admission_policy=cfg.build_admission_policy(), **common,
            )

        detail = {
            "profile": profile,
            "requests": n_requests,
            "buckets": list(cfg.buckets),
            "rate_rps": rate_rps,
            "max_len": max_len,
            "sequential_tokens_per_sec": round(seq_tps, 1),
            "sequential_compiled_shapes": seq_shapes,
            "platform": device.type,
            "decode_kernel": cfg.decode_kernel,
        }
        parity = all(r["parity"] for r in runs.values())
        clean = all(r["compiles_during_measure"] == 0 for r in runs.values())
        closed = all(r["compile_count"] == r["programs_expected"] for r in runs.values())
        if layout == "compare":
            dense, paged = runs["dense"], runs["paged"]
            capacity_ratio = (paged["peak_concurrent"] / dense["peak_concurrent"]
                              if dense["peak_concurrent"] else 0.0)
            tps_ratio = (paged["tokens_per_sec"] / dense["tokens_per_sec"]
                         if dense["tokens_per_sec"] else 0.0)
            detail.update({
                "pool_budget_tokens": budget_tokens,
                "dense": dense,
                "paged": paged,
                "capacity_ratio": round(capacity_ratio, 2),
                "tps_ratio": round(tps_ratio, 2),
                "parity": parity,
            })
            record = {
                "metric": metric,
                # headline: paged throughput at the shared byte budget
                "value": paged["tokens_per_sec"],
                "unit": "tokens/sec",
                "vs_baseline": round(tps_ratio, 2),
            }
            ok = parity and clean and closed and (capacity_ratio >= 2.0 or tps_ratio >= 1.5)
        else:
            run = runs[layout]
            detail.update(run)
            detail["speedup_vs_sequential"] = (
                round(run["tokens_per_sec"] / seq_tps, 2) if seq_tps else 0.0)
            record = {
                "metric": metric,
                "value": run["tokens_per_sec"],
                "unit": "tokens/sec",
                "vs_baseline": detail["speedup_vs_sequential"],
            }
            ok = parity and clean and closed
        record["detail"] = detail
        _emit_record(record)
        return 0 if ok else 1
    except Exception as e:  # structured failure record, like bench.py
        _emit_record({"metric": metric, "value": 0.0, "unit": "tokens/sec",
                      "vs_baseline": 0.0, "error": repr(e)})
        raise
    finally:
        if plane_stop is not None:
            plane_stop.set()
            plane_thread.join(timeout=10)


if __name__ == "__main__":
    sys.exit(main())
