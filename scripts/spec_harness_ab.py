#!/usr/bin/env python3
"""The serve harness's speculative compare, run several times in each of
several checkouts of the port, alternated, on one card.

Each run is ``python -m distributeddeeplearning_tpu_torch.serve_bench``
from a checkout's root with the environment the smoke's ``fleetspec``
part gives it: ``SERVE_SPEC_K=4``, the int8 self-draft, ``lm_base``
(f32 seeded weights), ``SERVE_DECODE_KERNEL=fused``, the harness's other
defaults (the ``mixed`` profile, 32 requests, 8 slots, one prefill a
tick). Round ``r`` visits the checkouts in the order given, or reversed
when ``r`` is odd (A B C, C B A, ...), so a drift of the host or the
card falls on every checkout alike.

    python3 scripts/spec_harness_ab.py [--runs 3] LABEL=DIR [LABEL=DIR ...]

With no ``LABEL=DIR`` the repo's own checkout runs alone. Needs one
NVIDIA GPU. Prints the card's name and power limit, one ``spec_ab`` JSON
line a run (exit code, speedup, both arms' tokens/s, ticks, wall and
slot occupancy, the draft's and the verify's host ms a tick), then one
``spec_ab_summary`` line with each checkout's speedups.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_ENV = {"SERVE_SPEC_K": "4", "SERVE_SPEC_DRAFT": "int8", "BENCH_MODEL": "lm_base",
            "SERVE_DECODE_KERNEL": "fused"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True)
    return out.stdout.strip()


def run_once(label: str, tree: str, timeout: float) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve_bench"],
        env=dict(os.environ, **SPEC_ENV), capture_output=True, text=True,
        timeout=timeout, cwd=tree)
    records = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"metric"')]
    if not records:
        raise SystemExit(f"{label}: serve_bench printed no record (rc {proc.returncode})\n"
                         f"{proc.stderr[-3000:]}")
    d = json.loads(records[-1])["detail"]
    g, s = d["greedy"], d["spec"]
    ticks = max(s["decode_steps"], 1)
    return {"tree": label, "rc": proc.returncode, "speedup": d["speedup"],
            "parity": d["parity"], "accept_rate_mean": d["accept_rate_mean"],
            "greedy_tokens_per_sec": g["tokens_per_sec"],
            "spec_tokens_per_sec": s["tokens_per_sec"],
            "greedy_ticks": g["decode_steps"], "spec_ticks": s["decode_steps"],
            "greedy_wall_s": g["wall_s"], "spec_wall_s": s["wall_s"],
            "greedy_occupancy": g["slot_occupancy_mean"],
            "spec_occupancy": s["slot_occupancy_mean"],
            "draft_ms_per_tick": d["draft_ms_total"] / ticks,
            "verify_ms_per_tick": d["verify_ms_total"] / ticks}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="LABEL=DIR checkouts of the repo")
    ap.add_argument("--runs", type=int, default=3, help="runs a checkout")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run")
    args = ap.parse_args()
    trees = [t.split("=", 1) for t in args.trees] or [["change", ROOT]]
    card = card_line()
    print(card, flush=True)
    speedups = {label: [] for label, _ in trees}
    for r in range(args.runs):
        for label, tree in (trees if r % 2 == 0 else trees[::-1]):
            line = dict(run_once(label, os.path.abspath(tree), args.timeout), round=r,
                        card=card)
            speedups[label].append(line["speedup"])
            print("spec_ab " + json.dumps(line), flush=True)
    print("spec_ab_summary " + json.dumps({
        label: {"speedups": v, "median": statistics.median(v), "min": min(v), "max": max(v)}
        for label, v in speedups.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
