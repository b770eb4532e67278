#!/usr/bin/env python3
"""What each part of the packed-QKV attention kernels costs on the card.

Builds ``distributeddeeplearning_tpu_torch/csrc/flash_packed.cu`` as the
package does and again with ``-DPACKED_ABLATE=`` 1 (no score products),
2 (no products with A in registers), 4 (no softmax or elementwise work)
and 7 (none of them: loads, barriers, statistics and stores alone), into
the package's gitignored build directory, and times the forward and the
backward of each build at one case of ``chip_smoke.FP_CASES`` with
``chip_smoke.time_ms`` (CUDA events, cold L2, median of 25). Ablated
builds compute wrong values: only their times mean anything. A part's
cost is the full build's time less the build without it; parts overlap,
so the costs need not add up. A profile of the full build splits the
backward into its two kernels.

    python3 scripts/packed_attention_ablation.py [--case vit_b16]

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import _build  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import flash_packed as fp  # noqa: E402

BUILDS = {0: "full", 1: "no score products", 2: "no register-A products",
          4: "no softmax or elementwise", 7: "loads, barriers and stores only"}


def build(mask: int) -> ctypes.CDLL:
    """The library of ``flash_packed.cu`` built with PACKED_ABLATE=mask
    (0: the package's own build)."""
    if mask == 0:
        return fp.bind(ctypes.CDLL(str(_build.build("flash_packed"))))
    path = _build.library_path("flash_packed")
    path = path.with_name(path.stem + f"-ablate{mask}.so")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, f"-DPACKED_ABLATE={mask}",
                              "-o", str(path), str(_build.CSRC / "flash_packed.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build with PACKED_ABLATE={mask} failed:\n{res.stdout[-2000:]}")
    return fp.bind(ctypes.CDLL(str(path)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", default="vit_b16", choices=[c[0] for c in cs.FP_CASES])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("packed_attention_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))

    _, b, t, h, d, causal = next(c for c in cs.FP_CASES if c[0] == args.case)
    g = torch.Generator(device="cuda").manual_seed(1357)
    qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g).to(torch.bfloat16)
    do = torch.randn(b, t, h * d, device="cuda", generator=g).to(torch.bfloat16)
    out = torch.empty_like(do)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(3, b * h, fp.stats_rows(t), device="cuda")
    scale = d ** -0.5

    def call(lib, backward):
        stream = torch.cuda.current_stream().cuda_stream
        if backward:
            rc = lib.fused_qkv_bwd(qkv.data_ptr(), out.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                                   stats.data_ptr(), b, t, h, d, int(causal), scale, stream)
        else:
            rc = lib.fused_qkv_fwd(qkv.data_ptr(), out.data_ptr(), b, t, h, d, int(causal), scale,
                                   0, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    call(libs[0], False)  # the backward reads a real o
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    ms = {}
    for mask, name in BUILDS.items():
        ms[name] = {op: cs.time_ms(lambda: call(libs[mask], op == "bwd"), flush)
                    for op in ("fwd", "bwd")}
    call(libs[0], False)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call(libs[0], True)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        name = re.search(r"packed_\w+", e.key)
        if name:
            total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            kernels[name.group(0)] = total / e.count / 1e3

    full = ms["full"]
    print(json.dumps({
        "card": card, "case": args.case,
        "shape": {"B": b, "T": t, "H": h, "d": d, "causal": causal},
        "ms": ms,
        "part_ms": {name: {op: full[op] - ms[name][op] for op in full}
                    for name in list(BUILDS.values())[1:]},
        "backward_kernel_ms": kernels,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
