#!/usr/bin/env python3
"""The elastic drill across cards: ``python -m
distributeddeeplearning_tpu_torch.launch --elastic`` shrinks a world to
its surviving capacity and grows it back with the math held, checked
against uninterrupted worlds.

    python3 scripts/elastic_dp_check.py --procs 4          # four cards
    python3 scripts/elastic_dp_check.py --procs 2 --cpu    # gloo rehearsal

Every world trains ``lm_base`` (``--cpu``: ``lm_tiny``) with
``attn_impl="pallas"`` (the flash kernels on the card), T ``--seq``,
bf16 (f32 on the CPU), ``--batch`` sequences a rank on the global token
stream (``DATA_TOPOLOGY=global``), 2 epochs of ``--steps`` steps, every
rank a child of the port's launcher (``DDL_*``: NCCL, one card a
process; ``--cpu``: gloo):

1. ``full``: ``--procs`` ranks, uninterrupted;
2. ``halved``: ``--procs``/2 ranks with ``BATCHSIZE`` x2,
   ``ACCUM_STEPS=2`` and ``LR_WORLD_SIZE=--procs``, uninterrupted: the
   same math in another reduction order. Its gap to ``full`` (the norm
   of the parameters' difference over the norm of ``full``'s update)
   sets the limit: twice that gap;
3. ``elastic``: ``launch --elastic -n --procs --max-restarts 1
   --min-world-size --procs/2 --grow-check-every-s 1`` with step
   checkpoints every 4 steps and
   ``FAULT_PLAN="shrink:step=4,ranks=--procs/2;restore_capacity:step=8"``:
   the top half of the ranks SIGKILL themselves after step 4 (leaving
   ``fault_shrink`` flight dumps), the supervisor relaunches --procs/2
   ranks with ``BATCHSIZE`` x2, ``ACCUM_STEPS`` x2 and ``LR_WORLD_SIZE``
   pinned, which resume at step 4; after step 8 they announce full
   capacity and wait (a shrunken rank blocks at the restore step until
   the supervisor's grow poller stops the world, with a deadline), and
   the full world resumes at step 8 and finishes.

Checks: the attempts' world sizes ``[P, P/2, P]`` and exit reasons; the
casualties' ``fault_shrink`` dumps (and whether the survivors, blocked
in a collective when the launcher ended them, left any);
``elastic.world_resized`` and ``elastic.reshard_ms`` in the merged
events; the flash kernels launched 12 times a pass (``ACCUM_STEPS``
passes a step) in every attempt; and the elastic run's final parameters
within twice ``halved``'s gap of ``full``'s. Prints an ``elastic_ref``
line, an ``elastic`` line and, last, ``elastic_dp`` with ``ok``; exits
non-zero naming what failed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHRINK_STEP, RESTORE_STEP, CKPT_EVERY = 4, 8, 4


def child() -> None:
    """One rank: ``fit`` on the settings the launcher and the parent
    export. Prints an ``elasticstep`` line at each step end (the step,
    the world, the flash launches since the last one); rank 0 saves the
    state dict it starts from (``ELASTIC_CHECK_INIT``, once) and the
    final one (``ELASTIC_CHECK_OUT``)."""
    sys.path.insert(0, ROOT)
    print("elasticchild stage=start", flush=True)
    import torch

    from distributeddeeplearning_tpu_torch import faults
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.ops import flash
    from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
    from distributeddeeplearning_tpu_torch.training import loop
    from distributeddeeplearning_tpu_torch.training.callbacks import Callback

    distributed.maybe_initialize()
    device = distributed.default_device()
    rank, world = collectives.rank(), collectives.size()
    full_world = int(os.environ.get("DDL_WORLD_FULL", "0")) or world
    restore_steps = {f.step for f in faults.parse_fault_plan(os.environ.get("FAULT_PLAN", ""))
                     if f.kind == "restore_capacity"}
    cfg = TrainConfig.from_env(log_every_steps=1)
    seq = int(os.environ["SEQ_LEN"])
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=seq,
                                 vocab_size=cfg.num_classes, seed=cfg.seed, process_index=rank,
                                 process_count=world, topology=cfg.data_topology)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=seq, device=device)
    print(f"elasticchild stage=model rank={rank} world={world}", flush=True)

    class Steps(Callback):
        def __init__(self):
            self.last = dict(flash.launches_by_op)

        def on_train_begin(self, logs=None):
            init = os.environ.get("ELASTIC_CHECK_INIT")
            if init and rank == 0 and not os.path.exists(init):
                torch.save({k: v.detach().cpu()
                            for k, v in logs["state"].model.state_dict().items()}, init)

        def on_step_end(self, step, logs=None):
            now = dict(flash.launches_by_op)
            delta = {k: now[k] - self.last[k] for k in now}
            self.last = now
            n = int(logs["state"].step)
            print("elasticstep " + json.dumps({"step": n, "rank": rank, "world": world,
                                               "accum_steps": cfg.accum_steps, "flash": delta}),
                  flush=True)
            if n in restore_steps and world < full_world:
                # Capacity is back: wait for the supervisor's resize stop
                # (SIGTERM) instead of racing its grow poller.
                print(f"elasticchild blocked step={n}", flush=True)
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    time.sleep(0.05)
                sys.exit(3)

    res = loop.fit(model, cfg, data, device=device, callbacks=[Steps()],
                   add_default_logger=False)
    print("elasticdone " + json.dumps({"rank": rank, "world": world, "history": res.history}),
          flush=True)
    out = os.environ.get("ELASTIC_CHECK_OUT")
    if out and rank == 0:
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, out)
    distributed.shutdown()


def _launch(args, tmp, name, procs, env, flags=()):
    """One launcher run of this script's child; returns (rc, output)."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    argv = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.launch", "-n", str(procs),
            "--timeout", str(args.timeout), "--hang-timeout", str(args.hang_timeout),
            "--obs-dir", os.path.join(d, "obs"), *flags, os.path.abspath(__file__), "--child"]
    cenv = dict(env, ELASTIC_CHECK_OUT=os.path.join(d, "final.pt"),
                ELASTIC_CHECK_INIT=os.path.join(tmp, "init.pt"))
    t0 = time.perf_counter()
    lines = []
    # Streamed, each line tagged with the run's name: a cut-off run
    # still shows how far it got.
    with subprocess.Popen(argv, cwd=ROOT, env=cenv, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True) as proc:
        for ln in proc.stdout:
            lines.append(ln)
            print(f"{name} {ln}", end="", flush=True)
    print(f"elastic_run {name} rc={proc.returncode} wall_s={time.perf_counter() - t0:.1f}",
          flush=True)
    return proc.returncode, "".join(lines)


def _records(path):
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(x) for x in fh if x.strip()]


def _gap(got, ref, init):
    """||got - ref|| over ||ref - init||, float tensors of the state."""
    import torch

    num = den = 0.0
    for k, r in ref.items():
        if not r.is_floating_point():
            continue
        num += (got[k].double() - r.double()).pow(2).sum().item()
        den += (r.double() - init[k].double()).pow(2).sum().item()
    equal = all(torch.equal(got[k], r) for k, r in ref.items())
    return (num / den) ** 0.5, equal


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=None, help="sequences a rank (8; --cpu 2)")
    ap.add_argument("--seq", type=int, default=None, help="T (1024; --cpu 64)")
    ap.add_argument("--steps", type=int, default=6, help="steps an epoch (2 epochs)")
    ap.add_argument("--timeout", type=float, default=240, help="seconds an attempt")
    ap.add_argument("--hang-timeout", type=float, default=120,
                    help="the launcher's watchdog: seconds without output")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child()
        return 0
    if args.procs % 2 or args.procs < 2:
        ap.error("--procs must be even")
    sys.path.insert(0, ROOT)
    import torch

    from distributeddeeplearning_tpu_torch.ops import _build

    half = args.procs // 2
    batch = args.batch or (2 if args.cpu else 8)
    seq = args.seq or (64 if args.cpu else 1024)
    model = "lm_tiny" if args.cpu else "lm_base"
    vocab = 256 if args.cpu else 32_000
    tmp = tempfile.mkdtemp(prefix="ddl-elastic-")
    cache = os.path.join(tmp, "kernel-cache")
    if not args.cpu:
        # One build for every rank of every world: they load it.
        _build.set_cache_dir(cache)
        _build.build("flash")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DDL_", "OBS_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2", FAKE="True", MODEL=model,
               NUM_CLASSES=str(vocab), SEQ_LEN=str(seq), ATTN_IMPL="pallas",
               DATA_TOPOLOGY="global", EPOCHS="2", BATCHSIZE=str(batch), ACCUM_STEPS="1",
               FAKE_DATA_LENGTH=str(args.steps * batch * args.procs),
               COMPILATION_CACHE_DIR=cache)
    if args.cpu:
        env.update(DDL_PLATFORM="cpu", COMPUTE_DTYPE="float32")
    card = "cpu" if args.cpu else _card()
    failed = []
    try:
        rc_full, out_full = _launch(args, tmp, "full", args.procs, env)
        rc_half, out_half = _launch(args, tmp, "halved", half, dict(
            env, BATCHSIZE=str(2 * batch), ACCUM_STEPS="2", LR_WORLD_SIZE=str(args.procs)))
        plan = f"shrink:step={SHRINK_STEP},ranks={half};restore_capacity:step={RESTORE_STEP}"
        rc_el, out_el = _launch(args, tmp, "elastic", args.procs, dict(
            env, MODEL_DIR=os.path.join(tmp, "ckpt"), CHECKPOINT_EVERY_STEPS=str(CKPT_EVERY),
            CHECKPOINT_ASYNC="0", FAULT_PLAN=plan), flags=(
            "--elastic", "--max-restarts", "1", "--restart-backoff", "0.1",
            "--min-world-size", str(half), "--grow-check-every-s", "1"))
        for name, rc in (("full", rc_full), ("halved", rc_half), ("elastic", rc_el)):
            if rc != 0:
                failed.append(f"{name} exited {rc}")
        finals = {n: torch.load(os.path.join(tmp, n, "final.pt"), weights_only=True)
                  for n in ("full", "halved", "elastic")
                  if os.path.exists(os.path.join(tmp, n, "final.pt"))}
        init = torch.load(os.path.join(tmp, "init.pt"), weights_only=True)
        ref = {}
        if "full" in finals and "halved" in finals:
            gap, equal = _gap(finals["halved"], finals["full"], init)
            ref = {"gap": gap, "bits_equal": equal, "limit": 2 * gap}
        print("elastic_ref " + json.dumps(dict(ref, procs=args.procs, half=half, model=model,
                                               seq=seq, batch=batch, card=card)), flush=True)

        obs = os.path.join(tmp, "elastic", "obs")
        sup = _records(os.path.join(obs, "events-supervisor.jsonl"))
        merged = _records(os.path.join(obs, "events.jsonl"))
        starts = [r["labels"]["world_size"] for r in sup if r.get("name") == "attempt_start"]
        exits = [(r["labels"]["rc"], r["labels"]["reason"]) for r in sup
                 if r.get("name") == "attempt_exit"]
        flights = {}
        for f in sorted(os.listdir(obs)):
            if f.startswith("flight-"):
                with open(os.path.join(obs, f)) as fh:
                    flights[f] = json.loads(fh.readline()).get("reason")
        resized = [r["labels"] for r in merged if r.get("name") == "elastic.world_resized"]
        reshard_ms = [r.get("value") for r in merged if r.get("name") == "elastic.reshard_ms"]
        # Per attempt (split at each rank 0 start): the flash launches a
        # pass (a step's over its ACCUM_STEPS) and the steps rank 0 ran.
        attempts = []
        for ln in out_el.splitlines():
            body = ln.split("] ", 1)[-1]
            if ln.startswith("[0] ") and body.startswith("elasticchild stage=start"):
                attempts.append({"steps": [], "per_pass": set()})
            elif body.startswith("elasticstep ") and attempts:
                rec = json.loads(body[len("elasticstep "):])
                attempts[-1]["per_pass"] |= {v / rec["accum_steps"] for v in rec["flash"].values()}
                if rec["rank"] == 0:
                    attempts[-1]["steps"].append(rec["step"])
        line = {
            "fault_plan": plan, "rc": rc_el, "world_sizes": starts,
            "attempt_exits": exits, "flight": flights,
            "casualties_dumped": sorted(f for f, r in flights.items() if r == "fault_shrink"),
            "survivors_dumped": sorted(f for f, r in flights.items() if r != "fault_shrink"),
            "world_resized": resized, "reshard_ms": reshard_ms,
            "steps_by_attempt": [a["steps"] for a in attempts],
            "flash_per_pass_by_attempt": [sorted(a["per_pass"]) for a in attempts],
            "card": card,
        }
        if "elastic" in finals and "full" in finals:
            gap, equal = _gap(finals["elastic"], finals["full"], init)
            line.update(gap_to_full=gap, bits_equal_full=equal, limit=ref.get("limit"))
            if not ref or gap > ref["limit"]:
                failed.append(f"elastic final {gap} from full, limit {ref.get('limit')}")
        else:
            failed.append(f"final states missing: {sorted(finals)}")
        print("elastic " + json.dumps(line), flush=True)
        want_pass = [0.0] if args.cpu else [12.0]
        casualties = [f"flight-p{r}.jsonl" for r in range(half, args.procs)]
        if starts != [args.procs, half, args.procs]:
            failed.append(f"world sizes {starts}")
        if [r for r, _ in exits] != [-9, 95, 0]:
            failed.append(f"attempt exits {exits}")
        if any(flights.get(f) != "fault_shrink" for f in casualties):
            failed.append(f"casualties' dumps {flights}")
        child_resized = [(r["from_world"], r["to_world"]) for r in resized if "step" in r]
        if child_resized[:1] != [(args.procs, half)] or (half, args.procs) not in child_resized:
            failed.append(f"restores' world_resized {resized}")
        if not reshard_ms:
            failed.append("no elastic.reshard_ms")
        if [a["per_pass"] and sorted(a["per_pass"]) for a in attempts] != [want_pass] * 3:
            failed.append(f"flash launches a pass {line['flash_per_pass_by_attempt']}")
        if [a["steps"][:1] for a in attempts] != [[1], [SHRINK_STEP + 1], [RESTORE_STEP + 1]]:
            failed.append(f"steps by attempt {line['steps_by_attempt']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("elastic_dp " + json.dumps({"ok": not failed, "procs": args.procs, "cpu": args.cpu,
                                      "failed": failed}), flush=True)
    for f in failed:
        print(f, file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
