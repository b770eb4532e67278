#!/usr/bin/env python3
"""Where the speculative tier's tick goes on the card: the int8
self-draft member, the verify member and a plain decode tick, each
replayed under ``torch.profiler`` and timed with CUDA events.

The engines are built as the serve harness's speculative compare builds
them (``serve_bench.run_spec_compare``): ``BENCH_MODEL`` (``lm_base``),
f32 seeded weights (``models.convert.init_params``, seed 0), the dense
layout, ``SERVE_DECODE_KERNEL=fused``, ``SERVE_SPEC_K=4`` with the int8
self-draft, 8 slots, the ``mixed`` profile's prompts and its ``max_len``
(16 + 16 + 4). Eight greedy requests fill the slots; after a few ticks
each member is replayed ``--reps`` times:

* ``draft_ms`` / ``verify_ms`` / ``decode_ms``: one replay, host wall
  closed by a synchronize (median);
* ``*_device_ms``: device time a replay, summed over the profiler's
  kernels, with the top kernels by device time.

``--dtype bf16`` builds the engines in bf16 instead. Then the harness's
speculative compare itself runs as a subprocess and its record is
printed (``--no-harness`` skips it).

    python3 scripts/spec_draft_profile.py [--dtype f32|bf16] [--reps 20]

Needs one NVIDIA GPU. Prints the card's name and power limit, then one
JSON line per member and the harness's record.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return out.stdout.strip()


def profile_member(fn, reps):
    """Median host wall of one call closed by a synchronize, and the
    device time a call with its top kernels, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    return {
        "ms": statistics.median(walls),
        "device_ms": device if device > 0 else "not measured",
        "ops": sum(e.count for e in kernels) / reps,
        "top_kernels_ms": {e.key[:90]: e.device_time_total / 1e3 / reps for e in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-harness", action="store_true")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine
    from distributeddeeplearning_tpu_torch.serving.loadgen import MIXED_PROMPT_LENS

    card = card_line()
    print(card, flush=True)
    model_name = os.environ.get("BENCH_MODEL", "lm_base")
    vocab, k = 32000, 4
    max_len = max(MIXED_PROMPT_LENS) + 16 + k
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    params = convert.init_params(model_name[3:], vocab,
                                 torch.Generator(device="cuda").manual_seed(0), max_len)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, size=t).astype(np.int32) for t in MIXED_PROMPT_LENS]
    for label, kw in (("spec_int8", dict(spec_k=k, spec_draft="int8")), ("plain", {})):
        model = get_model(model_name, num_classes=vocab, max_seq_len=max_len, dtype=dtype,
                          device="cuda")
        engine = SlotEngine(model, params, num_slots=8, max_len=max_len, buckets=(8, 16),
                            decode_kernel="fused", **kw)
        engine.warmup()
        server = Server(engine)
        for p in prompts:
            server.submit(Request(prompt=p, max_new_tokens=16))
        for _ in range(3):
            server.step()
        torch.cuda.synchronize()
        s = engine.num_slots
        out = {"what": label, "dtype": args.dtype, "model": model_name,
               "active": len(engine.active_slots), "max_len": max_len, "card": card}
        if label == "spec_int8":
            catchup = np.stack([engine._prev_tokens, engine._tokens], axis=1)
            start = np.maximum(engine._positions - 1, 0)
            out["draft"] = profile_member(
                lambda: engine._run("spec_draft", catchup=catchup, start=start)[0].cpu(),
                args.reps)
            tokens = np.zeros((s, k + 1), np.int64)
            tokens[:, 0] = engine._tokens
            keys = np.zeros((s, k + 1, 2), np.uint32)
            out["verify"] = profile_member(
                lambda: engine._run("spec_verify", greedy=True, tokens=tokens,
                                    **engine._routing(), **engine._sampling(keys))[0].cpu(),
                args.reps)
        else:
            keys = np.zeros((s, 2), np.uint32)
            out["decode"] = profile_member(
                lambda: engine._run("decode", greedy=True, tokens=engine._tokens[:, None],
                                    eos=engine._eos, **engine._routing(),
                                    **engine._sampling(keys))[0].cpu(),
                args.reps)
        server.drain()
        print("spec_profile " + json.dumps(out), flush=True)
        del server, engine, model
        torch.cuda.empty_cache()
    if not args.no_harness:
        env = dict(os.environ, BENCH_MODEL=model_name, SERVE_DECODE_KERNEL="fused",
                   SERVE_SPEC_K=str(k), SERVE_SPEC_DRAFT="int8")
        proc = subprocess.run(
            [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve_bench"],
            env=env, capture_output=True, text=True, cwd=ROOT, timeout=900)
        rec = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"metric"')]
        print("spec_harness " + json.dumps({"rc": proc.returncode,
                                             "record": json.loads(rec[-1]) if rec else None,
                                             "card": card}), flush=True)
        if not rec:
            print(proc.stderr[-3000:], file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
