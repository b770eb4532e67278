#!/usr/bin/env python3
"""A captured data-parallel step across processes: ``fit`` with
``AOT_WARMUP=1`` against ``fit`` without, in one world of ``--procs``
processes formed by ``parallel.distributed.maybe_initialize`` from the
``DDL_*`` variables (NCCL, one card a process; ``--cpu``: gloo on the
CPU, where nothing is captured).

    python3 scripts/captured_dp_check.py --procs 4            # four cards
    python3 scripts/captured_dp_check.py --procs 2 --cpu      # rehearsal

Each rank trains fused ResNet-50 (``--image-size`` px, ``--batch``
images a rank, ``--steps`` steps; ResNet-18 unfused under ``--cpu``)
from the seeded init twice, eager then graphed, and prints one
``rank`` JSON line: whether its graphed parameters and running
statistics equal its eager ones bit for bit, the graphs captured and
the steps that ran eager (a correctness check: no times). The parent
checks that every rank is equal, captured a graph on the card and
holds the same parameters as rank 0, then prints a ``captured_dp`` line
and exits 0, or non-zero naming what failed.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> None:
    sys.path.insert(0, ROOT)
    import torch

    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import make_dataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
    from distributeddeeplearning_tpu_torch.training import loop

    distributed.maybe_initialize()
    device = distributed.default_device()
    on_card = device.type == "cuda"
    finals, out = {}, {"rank": collectives.rank(), "world": collectives.size()}
    for aot in (False, True):
        cfg = TrainConfig(model="resnet50" if on_card else "resnet18",
                          image_size=args.image_size, batch_size_per_device=args.batch,
                          num_classes=10, fake_data_length=args.steps * args.batch * args.procs,
                          epochs=1, log_every_steps=1, aot_warmup=aot,
                          compute_dtype="bfloat16" if on_card else "float32")
        model = get_model(cfg.model, **cfg.model_kwargs(), fused=on_card, device=device)
        res = loop.fit(model, cfg, make_dataset(cfg), device=device, add_default_logger=False)
        finals[aot] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        out["graphed" if aot else "eager"] = {
            "graphs_captured": res.perf.get("graphs_captured"),
            "eager_steps": res.perf.get("eager_steps"), "history": res.history}
    out["bitwise_equal"] = all(torch.equal(finals[False][k], finals[True][k])
                               for k in finals[False])
    # The ranks' parameters after the graphed run against rank 0's: the
    # replicas stay equal.
    flat = torch.cat([v.float().reshape(-1) for v in finals[True].values()])
    ref = flat.clone()
    torch.distributed.broadcast(ref, 0)
    out["replicas_equal"] = bool(torch.equal(ref, flat))
    if on_card:
        out["card"] = torch.cuda.get_device_name(device)
    print("rank " + json.dumps(out), flush=True)
    distributed.shutdown()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    base.update(DDL_COORDINATOR=f"127.0.0.1:{port}", DDL_NUM_PROCESSES=str(args.procs),
                PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    if args.cpu:
        base["DDL_PLATFORM"] = "cpu"
    argv = [sys.executable, os.path.abspath(__file__), "--worker", "--procs", str(args.procs),
            "--image-size", str(args.image_size), "--batch", str(args.batch),
            "--steps", str(args.steps)]
    procs = [subprocess.Popen(argv, env=dict(base, DDL_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(args.procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            p.kill()
    ranks, failed = [], []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = [x for x in out.splitlines() if x.startswith("rank {")]
        if p.returncode != 0 or not lines:
            failed.append(f"rank {r} exited {p.returncode}: {out[-3000:]}")
            continue
        rec = json.loads(lines[-1][len("rank "):])
        ranks.append(rec)
        graphs = rec["graphed"]["graphs_captured"]
        if not (rec["bitwise_equal"] and rec["replicas_equal"]
                and rec["graphed"]["eager_steps"] == 0 and graphs == (0 if args.cpu else 1)):
            failed.append(f"rank {r}: {rec}")
    print("captured_dp " + json.dumps({"procs": args.procs, "cpu": args.cpu, "ranks": ranks,
                                       "failed": len(failed)}), flush=True)
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
