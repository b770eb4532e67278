#!/usr/bin/env python3
"""The dW+db kernel's wgmma path with its build constants changed, at
ViT-B/16's five Dense shapes.

Builds ``distributeddeeplearning_tpu_torch/csrc/fused_grads.cu`` as the
package does, and with one switch each, into the package's gitignored
build directory: ``-DFG_STAGES=`` 2 and 3 (the ring's stages; the
package's build holds as many as 192 KB take: 4 of a 128 x 256 tile, 6
of 128 x 128), ``-DFG_ONE_SPLIT=1`` (one split a tile: no merge, fewer
blocks) and ``-DFG_TILE_K=`` 128 and 256 (the dW tile's columns forced;
``ops/fused_grads.dw_db_plan`` reads both back and plans around them).
Times ``ops/fused_grads.matmul_dw_db_cuda`` of each build
at each of the first five ``chip_smoke.FG_CASES`` (ViT-B/16 at batch 64:
qkv, proj, fc1, fc2 in bf16, and the f32 head, which no switch touches),
beside the two library yardsticks of ``chip_smoke.fg_case``, with
``chip_smoke.time_ms`` (CUDA events, cold L2, median of 25). Each
build's output is held to the package's build bit for bit, or within
``chip_smoke.fg_limit`` where the sums run in another order. Then, with
the package's build, every tile (128 x 128, 128 x 256) and split count
of at most 16 that gives a distinct plan, in place of ``dw_db_plan``'s
choice (the plan function swapped in this process only): the data the
plan's cost model is fitted to.

    python3 scripts/fused_grads_ablation.py

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, then one JSON line per shape.
"""

from __future__ import annotations

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
from distributeddeeplearning_tpu_torch.ops import fused_grads as fg  # noqa: E402

BUILDS = {"package": (), "stages2": ("-DFG_STAGES=2",), "stages3": ("-DFG_STAGES=3",),
          "one_split": ("-DFG_ONE_SPLIT=1",), "tile_k128": ("-DFG_TILE_K=128",),
          "tile_k256": ("-DFG_TILE_K=256",)}


def build(name: str) -> ctypes.CDLL:
    """The library of ``fused_grads.cu`` built with BUILDS[name]'s flags
    (none: the package's own build)."""
    flags = BUILDS[name]
    if not flags:
        return ctypes.CDLL(str(_build.build("fused_grads")))
    path = _build.library_path("fused_grads")
    path = path.with_name(path.stem + f"-{name}.so")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
                              str(_build.CSRC / "fused_grads.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build with {flags} failed:\n{res.stdout[-2000:]}")
    return ctypes.CDLL(str(path))


def split_sweep(x, gr, flush) -> dict:
    """``matmul_dw_db_cuda`` of the package's build under each tile and
    split count (``"tile_k x splits"``: µs), ``dw_db_plan`` swapped for
    one that returns it."""
    (n, k), m = x.shape, gr.shape[1]
    chunks, planner, out = -(-n // 64), fg.dw_db_plan, {}
    try:
        for tile_k in (128, 256):
            seen = set()
            for want in range(1, 17):
                cps = -(-chunks // want)
                splits = -(-chunks // cps)
                if splits in seen:
                    continue
                seen.add(splits)
                plan = dict(planner(n, k, m, 132, tile_k=tile_k, one_split=True),
                            splits=splits, chunks_per_split=cps,
                            merge="last_block" if splits > 1 else "none")
                plan["blocks"] = plan["tiles"] * splits
                fg.dw_db_plan = lambda *a, _p=plan, **kw: _p
                out[f"{tile_k}x{splits}"] = cs.time_ms(lambda: fg.matmul_dw_db_cuda(x, gr),
                                                       flush) * 1e3
    finally:
        fg.dw_db_plan = planner
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_grads_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(31)
    for name, n, k, m, dtype in cs.FG_CASES[:5]:
        x = torch.randn(n, k, device="cuda", generator=g).to(dtype)
        gr = torch.randn(n, m, device="cuda", generator=g).to(dtype)
        ref_dw, ref_db = fg.matmul_dw_db_plain(x, gr)
        xa, ga = x.float().abs(), gr.float().abs()
        lim_dw, lim_db = cs.fg_limit(ga.t() @ xa, n), cs.fg_limit(ga.sum(0), n)
        del xa, ga
        us, err, plans, base = {}, {}, {}, None
        for build_name, lib in libs.items():
            _build._loaded["fused_grads"] = lib
            dw, db = fg.matmul_dw_db_cuda(x, gr)
            if base is None:
                base = (dw, db)
            plans[build_name] = fg.plan_for(x, gr)
            err[build_name] = ("equal" if torch.equal(dw, base[0]) and torch.equal(db, base[1])
                               else max(cs._ratio(dw, ref_dw, lim_dw)[1],
                                        cs._ratio(db, ref_db, lim_db)[1]))
            us[build_name] = cs.time_ms(lambda: fg.matmul_dw_db_cuda(x, gr), flush) * 1e3
        _build._loaded.pop("fused_grads")
        if dtype == torch.bfloat16:
            us["library_f32"] = cs.time_ms(lambda: (
                torch.mm(gr.t(), x, out_dtype=torch.float32),
                gr.sum(0, dtype=torch.float32)), flush) * 1e3
        us["library"] = cs.time_ms(lambda: (torch.matmul(gr.t(), x), gr.float().sum(0)),
                                   flush) * 1e3
        print(json.dumps({"case": name, "us": us, "vs_package_build": err, "plans": plans,
                          "card": card}), flush=True)
        if dtype == torch.bfloat16:
            print(json.dumps({"case": name, "split_sweep_us": split_sweep(x, gr, flush),
                              "card": card}), flush=True)
        del x, gr, ref_dw, ref_db, lim_dw, lim_db, base
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
