#!/usr/bin/env python3
"""The fused-bottleneck kernel with its build switches changed, at the
twelve shapes of the ResNet-50 forward, beside the library yardsticks
and, given another checkout, that checkout's kernel.

Builds ``distributeddeeplearning_tpu_torch/csrc/fused_block.cu`` as the
package does, and with one switch each, into the package's gitignored
build directory: ``-DFB_STAGES=`` 2 and 3 (the ring's depth; the
package's build takes the deepest of at most 6 that fits),
``-DFB_PANEL=`` 128 and 64 (the widest column panel the plan may take),
``-DFB_INPLACE=1`` (the prologue applied to the stage in shared memory,
then the shared-memory product, in place of the register-A product) and
``-DFB_ONE_LEVEL_MERGE=1`` (the last block of a panel sums every block's
row of the statistics, in place of two levels of merge groups). Each
build's plan comes from its own library (``ops/fused_block.plan_for``).
Times ``ops/fused_block``'s two ops with each build at each of
``chip_smoke.FB_MODEL_SHAPES`` with ``chip_smoke.time_ms`` (CUDA events,
cold L2, median of 25), beside the library yardstick (the prologue, one
``torch.matmul`` and the column sums) and a bare ``torch.matmul`` of
the same operands. Each build's y is held to the package build's bit
for bit, and its statistics to ``chip_smoke.fb_stats_limit`` at its
plan's depth. With ``--parent DIR``, DIR's ``fused_block.cu`` (the
mma.sync kernel, whose C entry takes two ``[ceil(M / 128), N]`` f32
buffers of row-tile partials and launches a second kernel to sum them)
is built too and timed at each shape before and after the package's
build, in the same process.

    python3 scripts/fused_block_ablation.py [--parent DIR] [--builds package,inplace,...]

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, one JSON line per shape, then the launch-weighted sums of a
forward for each build.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import _build  # noqa: E402
from distributeddeeplearning_tpu_torch.ops import fused_block as fb  # noqa: E402

BUILDS = {"package": (), "stages2": ("-DFB_STAGES=2",), "stages3": ("-DFB_STAGES=3",),
          "stages4": ("-DFB_STAGES=4",),
          "panel128": ("-DFB_PANEL=128",), "panel64": ("-DFB_PANEL=64",),
          "inplace": ("-DFB_INPLACE=1",), "one_level_merge": ("-DFB_ONE_LEVEL_MERGE=1",)}


def _nvcc(source: Path, out: Path, flags) -> Path:
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
                              str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build of {source} with {flags} failed:\n{res.stdout[-2000:]}")
    return out


def build(name: str) -> ctypes.CDLL:
    """The library of ``fused_block.cu`` built with BUILDS[name]'s flags
    (none: the package's own build)."""
    if not BUILDS[name]:
        return ctypes.CDLL(str(_build.build("fused_block")))
    path = _build.library_path("fused_block")
    return ctypes.CDLL(str(_nvcc(_build.CSRC / "fused_block.cu",
                                 path.with_name(path.stem + f"-{name}.so"), BUILDS[name])))


def build_parent(root: Path) -> ctypes.CDLL:
    """The other checkout's ``fused_block.cu``, with its own C entry's
    argument types."""
    source = root / "distributeddeeplearning_tpu_torch" / "csrc" / "fused_block.cu"
    tag = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = ctypes.CDLL(str(_nvcc(source, _build.BUILD_DIR / f"libfused_block-other-{tag}.so",
                                ("-I", str(source.parent)))))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_block_matmul_stats.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.fused_block_matmul_stats.restype = i
    lib.fused_block_row_tile.argtypes = []
    lib.fused_block_row_tile.restype = i
    return lib


def use(lib: ctypes.CDLL) -> None:
    """Route ``ops/fused_block`` to ``lib`` (its plans cached anew)."""
    _build._loaded["fused_block"] = lib
    fb._card_plans.clear()


def parent_call(lib, a, w, affine):
    """The other checkout's kernel on (a, w, affine), as its wrapper
    called it: ``(y, Σy, Σy²)``."""
    m, k = a.shape
    n = w.shape[0]
    tiles = -(-m // lib.fused_block_row_tile())
    y = torch.empty(m, n, dtype=a.dtype, device=a.device)
    part = torch.empty(2, tiles, n, dtype=torch.float32, device=a.device)
    stats = torch.empty(2, n, dtype=torch.float32, device=a.device)
    rc = lib.fused_block_matmul_stats(
        a.data_ptr(), w.data_ptr(), affine[0].data_ptr() if affine else None,
        affine[1].data_ptr() if affine else None, y.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), m, k, n, int(bool(affine)),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the other checkout's kernel failed: CUDA error {rc}")
    return y, stats[0], stats[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="another checkout whose kernel to time")
    ap.add_argument("--builds", default=",".join(BUILDS),
                    help="comma-separated subset of %s" % ",".join(BUILDS))
    args = ap.parse_args()
    names = args.builds.split(",")
    if not set(names) <= set(BUILDS) or "package" not in names:
        ap.error(f"--builds must include package and name only {sorted(BUILDS)}")
    if not torch.cuda.is_available():
        print("fused_block_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(names) + 1) as pool:
        builds = {n: pool.submit(build, n) for n in names}
        other = pool.submit(build_parent, args.parent) if args.parent else None
        libs = {n: f.result() for n, f in builds.items()}
        other = other.result() if other else None
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2718)
    totals = {}
    for op, m, k, n, per_forward in cs.FB_MODEL_SHAPES:
        a = torch.randn(m, k, device="cuda", generator=g)
        w = (torch.randn(n, k, device="cuda", generator=g) * (2.0 / n) ** 0.5).to(torch.bfloat16)
        bn = op == "bn_relu_matmul_stats"
        if bn:
            a = a * (torch.rand(k, device="cuda", generator=g) + 0.5) + 0.3
            af = a.to(torch.bfloat16).float()
            mean, var = af.mean(0), af.var(0, unbiased=False)
            scale = 1.0 + 0.1 * torch.randn(k, device="cuda", generator=g)
            bias = 0.1 * torch.randn(k, device="cuda", generator=g)
            affine = fb._affine_rows(mean, var, scale, bias, 1e-5)
            z = torch.relu(af * affine[0] + affine[1]).to(torch.bfloat16)
            del af
        a = a.to(torch.bfloat16)
        if not bn:
            affine, z = None, a

        def run(_bn=bn, _a=a, _w=w, _affine=affine):
            if _bn:
                return fb.bn_relu_matmul_stats(_a, mean, var, scale, bias, _w)
            return fb.matmul_stats(_a, _w)

        def library(_a=a, _w=w, _affine=affine):
            x = _a if _affine is None else torch.relu(_a.float() * _affine[0]
                                                      + _affine[1]).to(_a.dtype)
            yl = torch.matmul(x, _w.t())
            yf = yl.float()
            return yl, yf.sum(0), (yf * yf).sum(0)

        line = {"op": op, "shape": {"M": m, "K": k, "N": n}, "launches": per_forward,
                "us": {}, "plan": {}, "y_equal_bits": {}, "stats_err_over_limit": {}}
        use(libs["package"])
        y_ref = run()[0]
        order = list(names) + (["package"] if other is not None else [])
        if other is not None:
            line["other_us"] = [cs.time_ms(lambda: parent_call(other, a, w, affine), flush) * 1e3]
        for name in order:
            use(libs[name])
            y, s, ss = run()
            plan = fb.plan_for(a, w, bn)
            line["plan"][name] = {key: plan[key] for key in ("panel", "stages", "grid", "group")}
            line["y_equal_bits"][name] = bool(torch.equal(y, y_ref))
            ratio = cs._fb_stats_ratio(s, ss, y, plan["stat_depth"])
            line["stats_err_over_limit"][name] = ratio
            if not line["y_equal_bits"][name] or ratio > 1.0:
                raise AssertionError(f"{name} at {op} {m}x{k}x{n}: y differs from the package "
                                     f"build's or the statistics exceed their limit {ratio:.2f}x")
            line["us"].setdefault(name, []).append(cs.time_ms(run, flush) * 1e3)
        if other is not None:
            y, s, ss = parent_call(other, a, w, affine)
            line["other_matches_y_limit"] = bool(
                ((y.float() - fb.matmul_stats_plain(z.float(), w.float())[0]).abs()
                 <= cs.fb_y_limit(fb.matmul_stats_plain(z.float(), w.float())[0])).all())
            line["other_us"].append(cs.time_ms(lambda: parent_call(other, a, w, affine), flush) * 1e3)
        use(libs["package"])
        line["library_us"] = cs.time_ms(library, flush) * 1e3
        line["gemm_us"] = cs.time_ms(lambda: torch.matmul(z, w.t()), flush) * 1e3
        nbytes = 2 * m * k + 2 * k * n + 2 * m * n + 8 * n + (16 * k if bn else 0)
        line["bound_us"] = max(nbytes / cs.H100_BYTES_PER_S, 2.0 * m * k * n / cs.H100_BF16_FLOP_S) * 1e6
        print("shape " + json.dumps(line), flush=True)
        for key, t in list(line["us"].items()) + [("other", line.get("other_us", [0.0])),
                                                  ("library", [line["library_us"]]),
                                                  ("gemm", [line["gemm_us"]]),
                                                  ("bound", [line["bound_us"]])]:
            totals[key] = totals.get(key, 0.0) + per_forward * min(t)
        del a, w, z, y, y_ref, s, ss
        torch.cuda.empty_cache()
    if other is None:
        totals.pop("other")
    print("sums " + json.dumps({"us_per_forward": totals, "launches": sum(
        s[4] for s in cs.FB_MODEL_SHAPES), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
