#!/usr/bin/env python3
"""Where the fleet's tenant shares come from: ``chip_smoke.py``'s
one-against-two fleet (``lm_base`` bf16, paged, fused, captured, 8 slots
a replica, tenants gold:3, silver:2, bronze:1 on the seeded backlog) run
``--runs`` times through ``fleet_bench.run_fleet``, with the router's
dispatches, the token deliveries, the fairness window's edges and the
placements that found no admitting replica recorded.

    python3 scripts/fleet_fairness_trace.py --runs 3 [--requests 96] [--dump FILE]
    python3 scripts/fleet_fairness_trace.py --analyze FILE

Each run prints a ``fairness_trace`` JSON line: each tenant's delivered
tokens over the window and their share's relative error to the weight
share (what the smoke holds to 0.15), the deficit round robin's
dispatched-cost share over the same window, the requests in flight at
each edge with the tokens they still owed, and the placements that found
no replica. ``--device cpu`` runs ``lm_tiny`` at short shapes.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_SHAPES = ((24, 16), (16, 24), (28, 16), (20, 32))


def summarize(events, weights):
    """One run's ``fairness_trace`` fields from its recorded events:
    ``("d", t, id, tenant, cost, replica)`` a dispatch, ``("t", t, id,
    tenant, n)`` a delivery, ``("s", t)`` a window edge, ``("b", t, id,
    tenant)`` a placement that found no replica."""
    start, end = [e[1] for e in events if e[0] == "s"][:2]
    dispatched = {e[2]: e for e in events if e[0] == "d"}
    arrivals = collections.defaultdict(list)
    for e in events:
        if e[0] == "t":
            arrivals[e[2]].append((e[1], e[4]))

    def delivered(fid, t):
        return sum(n for at, n in arrivals[fid] if at <= t)

    tokens, cost = collections.Counter(), collections.Counter()
    owed = {"start": collections.Counter(), "end": collections.Counter()}
    for fid, (_, at, _, tenant, n, _) in dispatched.items():
        tokens[tenant] += delivered(fid, end) - delivered(fid, start)
        if start < at <= end:
            cost[tenant] += n
        for edge, t in (("start", start), ("end", end)):
            if at <= t and delivered(fid, t) < n:
                owed[edge][tenant] += n - delivered(fid, t)
    total_w, total_tok, total_cost = sum(weights.values()), sum(tokens.values()), sum(cost.values())
    return {
        "window_s": end - start,
        "tokens": {t: tokens[t] for t in weights},
        "rel_err": {t: abs(tokens[t] / total_tok - w / total_w) / (w / total_w)
                    for t, w in weights.items()},
        "dispatched_cost_share": {t: cost[t] / total_cost for t in weights},
        "owed_at_start": {t: owed["start"][t] for t in weights},
        "owed_at_end": {t: owed["end"][t] for t in weights},
        "no_replica_placements": sum(1 for e in events if e[0] == "b" and start <= e[1] <= end),
    }


def trace(runs, requests, device):
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch import fleet_bench
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving.fleet import router as fleet_router

    Router, FleetHandle = fleet_router.Router, fleet_router.FleetHandle
    if device == "cpu":
        shapes, variant, vocab, max_len = CPU_SHAPES, "tiny", 256, 64
    else:
        shapes, variant, vocab, max_len = cs.FLEET_SHAPES, "base", cs.VOCAB, cs.FLEET_MAX_LEN
    events, t0 = [], time.perf_counter()
    dispatch_to, ingest, place = Router._dispatch_to, FleetHandle._ingest, Router._place
    snapshot = fleet_bench.fairness_snapshot

    def record_dispatch(self, replica, fh):
        events.append(("d", time.perf_counter() - t0, fh.id, fh.tenant,
                       fh.request.max_new_tokens, replica.rid))
        return dispatch_to(self, replica, fh)

    def record_ingest(self, toks):
        events.append(("t", time.perf_counter() - t0, self.id, self.tenant, len(toks)))
        return ingest(self, toks)

    def record_edge(handles):
        events.append(("s", time.perf_counter() - t0))
        return snapshot(handles)

    def record_place(self, fh):
        replica = place(self, fh)
        if replica is None:
            events.append(("b", time.perf_counter() - t0, fh.id, fh.tenant))
        return replica

    Router._dispatch_to, FleetHandle._ingest, Router._place = (
        record_dispatch, record_ingest, record_place)
    fleet_bench.fairness_snapshot = record_edge
    params = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(0),
                                 max_len)
    model = get_model(f"lm_{variant}", num_classes=vocab, max_seq_len=max_len, device=device)
    scfg, fcfg = cs._fleet_configs(8)
    if device == "cpu":
        scfg.buckets = (max_len,)
    card = cs.device_line() if device != "cpu" else "cpu"
    reqs, tenants = cs._fleet_requests(requests, vocab, shapes)
    out = []
    for i in range(runs):
        events.clear()
        fleet_bench.run_fleet(model, params, reqs, scfg, fcfg, 2, max_len, tenants)
        out.append(list(events))
        line = dict(summarize(events, fcfg.tenant_weights), run=i, requests=requests, card=card)
        print("fairness_trace " + json.dumps(line), flush=True)
    return out, fcfg.tenant_weights


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dump", help="write every run's events to this JSON file")
    ap.add_argument("--analyze", help="summarize a dump instead of running")
    args = ap.parse_args()
    if args.analyze:
        with open(args.analyze) as fh:
            dump = json.load(fh)
        for i, events in enumerate(dump["runs"]):
            line = dict(summarize(events, dump["weights"]), run=i)
            print("fairness_trace " + json.dumps(line), flush=True)
        return 0
    runs, weights = trace(args.runs, args.requests, args.device)
    if args.dump:
        with open(args.dump, "w") as fh:
            json.dump({"weights": weights, "runs": runs}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
