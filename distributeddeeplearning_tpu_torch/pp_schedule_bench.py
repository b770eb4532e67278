"""GPipe against 1F1B: step time and peak memory a rank (the port's twin
of the JAX package's ``scripts/pp_schedule_bench.py``).

    python -m distributeddeeplearning_tpu_torch.pp_schedule_bench [stages] [microbatches]
        [--data N] [--device cuda|cpu] [--steps K]

It starts ``stages × data`` processes as a world from ``DDL_*``
(``parallel/distributed.py``: on the card NCCL with a card a rank, or
gloo with ranks sharing the cards; ``--device cpu``: gloo on the CPU),
each training its stage of ``lm_tiny`` (f32, vocab 256, T 128, two
layers a stage) under both schedules with ``M`` microbatches of
``microbatches × data`` rows, and prints from rank 0, a line a
schedule, the step time (host clock over ``--steps`` steps after one
warm-up, each ending in a synchronize) and every rank's peak memory:
``torch.cuda.max_memory_allocated`` on the card, where JAX's script
reads XLA's ``memory_analysis`` temp size ("not measured" on the CPU).
GPipe keeps every microbatch's stage graph until the backward; 1F1B
keeps at most ``2S`` stage inputs and recomputes each stage forward.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

VOCAB, T, LAYERS_PER_STAGE = 256, 128, 2


def run(schedule: str, stages: int, microbatches: int, data: int, device, steps: int) -> dict:
    """One rank's timing of ``schedule`` (every rank calls it)."""
    import numpy as np
    import torch

    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.parallel import collectives
    from distributeddeeplearning_tpu_torch.training import create_optimizer, engines

    cfg = TrainConfig(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=microbatches,
                      weight_decay=0.0, compute_dtype="float32", engine="pp",
                      mesh_axes=("data", "pipe"), mesh_shape=(data, stages),
                      pp_microbatches=microbatches, pp_schedule=schedule, base_lr=0.01)
    model = get_model("lm_tiny", num_classes=VOCAB, dtype=torch.float32, max_seq_len=T,
                      n_layers=stages * LAYERS_PER_STAGE, device=device)
    tx, _ = create_optimizer(cfg, 100, world_size=1)
    eng = engines.build_engine(model, cfg, tx, device=device)
    rows = np.random.RandomState(0).randint(0, VOCAB, size=(microbatches * data, T + 1))
    index, count = eng.batch_shard()
    n = rows.shape[0] // count
    local = torch.as_tensor(rows[index * n:(index + 1) * n].astype(np.int32)).to(device)
    batch = (local[:, :-1].contiguous(), local[:, 1:].contiguous())
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    state, m = eng.train_step(eng.state, batch)  # warm-up
    float(m["loss"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    collectives.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = eng.train_step(state, batch)
    loss = float(m["loss"])
    sync()
    dt = (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated() / 2**20 if cuda else None
    del eng, state
    if cuda:
        torch.cuda.empty_cache()
    return {"schedule": schedule, "rank": collectives.rank(), "step_ms": dt * 1e3,
            "peak_mib": peak, "loss": loss}


def child(args) -> None:
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.parallel import collectives, distributed

    distributed.maybe_initialize()
    device = distributed.default_device()
    for schedule in ("gpipe", "1f1b"):
        got = run(schedule, args.stages, args.microbatches, args.data, device, args.steps)
        every = [None] * collectives.size()
        dist.all_gather_object(every, got)
        if collectives.is_master():
            peaks = [e["peak_mib"] for e in every]
            peak = ("not measured" if peaks[0] is None
                    else " ".join(f"{p:.1f}" for p in peaks) + " MiB")
            print(f"{schedule:6s} S={args.stages} M={args.microbatches}: "
                  f"step={got['step_ms']:8.1f} ms  peak={peak}  loss={got['loss']:.4f}",
                  flush=True)
            print("ppsched " + json.dumps({"schedule": schedule, "stages": args.stages,
                                           "microbatches": args.microbatches,
                                           "data": args.data, "device": str(device),
                                           "ranks": every}), flush=True)
    distributed.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stages", nargs="?", type=int, default=2)
    ap.add_argument("microbatches", nargs="?", type=int, default=8)
    ap.add_argument("--data", type=int, default=1, help="data-parallel width")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    n = args.stages * args.data
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, DDL_COORDINATOR=f"127.0.0.1:{port}", DDL_NUM_PROCESSES=str(n),
                   DDL_PROCESS_ID=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   DDL_PLATFORM="cpu" if args.device == "cpu" else "gpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "distributeddeeplearning_tpu_torch.pp_schedule_bench",
             str(args.stages), str(args.microbatches), "--data", str(args.data),
             "--device", args.device, "--steps", str(args.steps), "--child"], env=env))
    codes = [p.wait() for p in procs]
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
