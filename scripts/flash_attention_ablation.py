#!/usr/bin/env python3
"""What each part of the flash-attention kernels costs on the card.

Builds ``distributeddeeplearning_tpu_torch/csrc/flash.cu`` as the package
does and again with ``-DFLASH_ABLATE=`` 1 (no score products), 2 (no
products whose A operand is the score accumulator), 4 (no softmax or
elementwise work) and 7 (none of them: loads, barriers and stores alone),
with ``-DFLASH_STAGED_DS=1`` (the backward's alternative: bf16(p) and
bf16(ds) staged in shared memory, every gradient product read from there)
and with ``-DFLASH_ONE_BLOCK_PER_TILE=1`` (one block per work item instead
of the persistent grid), into the package's gitignored build directory.
It times the forward, dq and dk/dv kernels of each build at one case of
``chip_smoke.FLASH_CASES`` with ``chip_smoke.time_ms`` (CUDA events, cold
L2, median of 25). Ablated builds compute wrong values: only their times
mean anything. A part's cost is the full build's time less the build
without it; parts overlap, so the costs need not add up. The two
alternative builds compute the same function: their largest difference
from the package build is printed beside their times.

    python3 scripts/flash_attention_ablation.py [--case lm_base_train]

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import _build  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import flash as fl  # noqa: E402

BUILDS = {
    "full": (),
    "no score products": ("-DFLASH_ABLATE=1",),
    "no register-A products": ("-DFLASH_ABLATE=2",),
    "no softmax or elementwise": ("-DFLASH_ABLATE=4",),
    "loads, barriers and stores only": ("-DFLASH_ABLATE=7",),
    "staged p and ds": ("-DFLASH_STAGED_DS=1",),
    "one block per tile": ("-DFLASH_ONE_BLOCK_PER_TILE=1",),
}
ALTERNATIVES = ("staged p and ds", "one block per tile")
OPS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def build(name: str) -> ctypes.CDLL:
    """The library of ``flash.cu`` built with the flags of BUILDS[name]."""
    flags = BUILDS[name]
    if not flags:
        return fl.bind(ctypes.CDLL(str(_build.build("flash"))))
    path = _build.library_path("flash")
    tag = "-".join(f.split("=")[0].lstrip("-D").lower() + f.split("=")[1] for f in flags)
    path = path.with_name(path.stem + f"-{tag}.so")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
                              str(_build.CSRC / "flash.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build with {flags} failed:\n{res.stdout[-2000:]}")
    return fl.bind(ctypes.CDLL(str(path)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", default="lm_base_train", choices=[c[0] for c in cs.FLASH_CASES])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))

    _, b, h, tq, tk, d, causal, q_mul = next(c for c in cs.FLASH_CASES if c[0] == args.case)
    g = torch.Generator(device="cuda").manual_seed(2468)
    bf = torch.bfloat16
    q = (torch.randn(b, tq, h, d, device="cuda", generator=g) * q_mul).to(bf)
    k = torch.randn(b, tk, h, d, device="cuda", generator=g).to(bf)
    v = torch.randn(b, tk, h, d, device="cuda", generator=g).to(bf)
    do = torch.randn(b, tq, h, d, device="cuda", generator=g).to(bf)
    scale = d ** -0.5
    out, lse = fl.flash_forward(q, k, v, causal, scale)  # the backward reads a real O and LSE
    delta = fl.flash_delta(out, do)
    o2, lse2 = torch.empty_like(out), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = {"flash_fwd": fl._strides(q, k, v, o2), "flash_bwd_dq": fl._strides(q, k, v, do, dq),
               "flash_bwd_dkv": fl._strides(q, k, v, do, dk, dv)}

    def call(lib, op):
        stream = torch.cuda.current_stream().cuda_stream
        st = strides[op]
        if op == "flash_fwd":
            rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(),
                               lse2.data_ptr(), st, b, h, tq, tk, d, int(causal), scale, 0, stream)
        elif op == "flash_bwd_dq":
            rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), st, b, h, tq,
                                  tk, d, int(causal), scale, stream)
        else:
            rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                   st, b, h, tq, tk, d, int(causal), scale, stream)
        if rc != 0:
            raise RuntimeError(f"{op} launch failed: CUDA error {rc}")

    def outputs(lib):
        for op in OPS:
            call(lib, op)
        torch.cuda.synchronize()
        return [x.clone() for x in (o2, lse2, dq, dk, dv)]

    reference = outputs(libs["full"])
    differs = {}
    for name in ALTERNATIVES:
        got = outputs(libs[name])
        differs[name] = max((a.float() - r.float()).abs().max().item()
                            for a, r in zip(got, reference))

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    ms = {name: {op: cs.time_ms(lambda: call(libs[name], op), flush) for op in OPS}
          for name in BUILDS}
    full = ms["full"]
    print(json.dumps({
        "card": card, "case": args.case,
        "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "d": d, "causal": causal, "q_mul": q_mul},
        "ms": ms,
        "part_ms": {name: {op: full[op] - ms[name][op] for op in OPS}
                    for name in BUILDS if name != "full" and name not in ALTERNATIVES},
        "alternative_max_abs_diff": differs,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
