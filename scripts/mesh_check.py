#!/usr/bin/env python3
"""The mesh engines across cards: tensor parallel × data, pipeline
parallel × data and expert parallel × data on a 2 × 2 mesh, in one
world of ``--procs`` processes
formed by ``parallel.distributed.maybe_initialize`` from the ``DDL_*``
variables (NCCL, one card a process; with fewer cards than processes
the ranks share them under gloo).

    python3 scripts/mesh_check.py --procs 4

It builds the kernels, then runs ``chip_smoke.py``'s mesh phase
(``chip_smoke.mesh_phase``) over these meshes: ``pjit`` ``tp`` on
``(data 2, model 2)`` and ``pp`` on ``(data 2, pipe 2)`` with GPipe and
1F1B (M = 4), ``lm_base`` at T 1024 and a global batch of 8, and
``pjit`` on ``(data 2, expert 2)`` with ``lm_moe_base`` (6 of its 12
layers routed over 8 experts, 4 a rank). Each
rank's f32 first step at 2 layers is held to one rank's step on the same
global batch and weights (loss within 1e-5 relative, parameters within
1e-4 of the largest value); each rank's flash launches a bf16 step at
full depth are counted against the table (12 a layer's pass under tp, 24
under GPipe, 48 forwards under 1F1B), GPipe and 1F1B must agree, and
under EP the parameters the layout does not split must be bitwise equal
across the expert ranks after the timed steps. It
prints chip_smoke's ``mesh`` lines and a ``mesh_check`` JSON line with
the card (``nvidia-smi --query-gpu=name,power.limit``), and exits 0, or
non-zero naming what failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH4 = (
    dict(name="pjit_tp_x_data", engine="pjit", param_sharding="tp", axes=["data", "model"],
         shape=[2, 2], model="lm"),
    dict(name="pp_gpipe_x_data", engine="pp", pp_schedule="gpipe", axes=["data", "pipe"],
         shape=[2, 2], model="lm"),
    dict(name="pp_1f1b_x_data", engine="pp", pp_schedule="1f1b", axes=["data", "pipe"],
         shape=[2, 2], model="lm"),
    dict(name="pjit_ep_x_data", engine="pjit", param_sharding="tp", axes=["data", "expert"],
         shape=[2, 2], model="lm", moe=True),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("CUDA is not available; this check runs on NVIDIA GPUs", file=sys.stderr)
        return 2
    card = chip_smoke.device_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    for name in ("flash", "fused_block", "flash_packed", "fused_grads"):
        _build.build(name)
    launches = chip_smoke.mesh_phase(card, scenarios=MESH4, nprocs=args.procs)
    print("mesh_check " + json.dumps({
        "procs": args.procs, "cards": torch.cuda.device_count(), "launches": launches,
        "seconds": time.perf_counter() - t0, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
