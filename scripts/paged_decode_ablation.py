#!/usr/bin/env python3
"""What each part of the decode-attention kernel costs on the card, and
how its ring depth moves it.

Builds ``distributeddeeplearning_tpu_torch/csrc/paged_decode.cu`` as the
package does (a ring of 4 stages), with ``-DPD_STAGES=`` 2, 3 and 6, and
with ``-DPD_ABLATE=`` 1 (no products or softmax), 2 (no copies) and 3
(neither), into the package's gitignored build directory, and times each
build at ``chip_smoke``'s ``paged_decode_full`` case (B 8, t 1, H 12, d
64, a paged pool of 2048 positions per row through a shuffled table), in
bf16 and on int8 codes, with ``chip_smoke.time_ms`` (CUDA events, cold
L2, median of 25). Each build runs under the split plan of its own ring
depth (``ops/paged_decode.plan_for`` asks the loaded library). Ablated
builds compute wrong values: only their times mean anything. A part's
cost is the full build's time less the build without it; parts overlap,
so the costs need not add up.

    python3 scripts/paged_decode_ablation.py

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import _build  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import paged_decode as pd  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import quant  # noqa: E402

BUILDS = {"full": (), "2 stages": ("-DPD_STAGES=2",), "3 stages": ("-DPD_STAGES=3",),
          "6 stages": ("-DPD_STAGES=6",), "no products or softmax": ("-DPD_ABLATE=1",),
          "no copies": ("-DPD_ABLATE=2",),
          "launch, barriers, merge and stores only": ("-DPD_ABLATE=3",)}


def build(name: str) -> ctypes.CDLL:
    """The library of ``paged_decode.cu`` built with BUILDS[name]'s flags
    (none: the package's own build)."""
    flags = BUILDS[name]
    if not flags:
        return ctypes.CDLL(str(_build.build("paged_decode")))
    path = _build.library_path("paged_decode")
    tag = "".join(f.split("PD_")[1].replace("=", "").lower() for f in flags)
    path = path.with_name(path.stem + f"-{tag}.so")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
                              str(_build.CSRC / "paged_decode.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build with {flags} failed:\n{res.stdout[-2000:]}")
    return ctypes.CDLL(str(path))


def full_case(g, rng):
    """``paged_decode_full``'s operands: 8 rows at position 2047 over a
    shuffled pool of 16-position blocks."""
    b, h, d, length, bs = 8, 12, 64, 2048, 16
    mb = length // bs
    nb = b * mb + 1
    k = torch.randn(nb, bs, h, d, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(nb, bs, h, d, device="cuda", generator=g).to(torch.bfloat16)
    table = torch.from_numpy(rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32))
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(torch.bfloat16)
    pos = torch.full((b, 1), length - 1, dtype=torch.int32, device="cuda")
    return q, k, v, pos, dict(block_table=table.cuda(), block_size=bs)


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_decode_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))
    g = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v, pos, kw = full_case(g, np.random.RandomState(4321))
    (kq, ks), (vq, vs) = quant.quantize_kv(k, "int8"), quant.quantize_kv(v, "int8")
    stores = {"bf16": (k, v, {}), "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    times, plans = {}, {}
    for name, lib in libs.items():
        _build._loaded["paged_decode"] = lib
        for store, (kk, vv, sc) in stores.items():
            def call():
                return pd.fused_decode_attention(q, kk, vv, pos, **kw, **sc)
            times[f"{name}/{store}"] = cs.time_ms(call, flush) * 1e3
            plan = pd.plan_for(q, kk, kw["block_table"], kw["block_size"], bool(sc))
            plans[f"{name}/{store}"] = {key: plan[key] for key in
                                        ("stages", "groups", "splits", "blocks")}
    _build._loaded.pop("paged_decode")
    print(json.dumps({"case": "paged_decode_full", "us": times, "plans": plans, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
