#!/usr/bin/env python3
"""The depthwise TMA kernels side by side at EfficientNet-B4's stride-1
layers: the stencil's and the wgrad's build constants.

Builds ``distributeddeeplearning_tpu_torch/csrc/depthwise.cu`` as the
package does, and with one switch each, into the package's gitignored
build directory. The stencil's (the plan picks the vector kernel at
k = 3 on rows wider than 12, the lane kernel else):
``-DDW_TMA_KERNEL=`` 1 (the vector kernel: 16-byte channel vectors,
taps in shared memory) and 2 (the lane kernel: a channel a lane, taps in
registers) forced, and ``-DDW_RING_EXTRA=`` 1 and 4 (the ring holding one
and four rows beyond k). The wgrad's (``csrc/depthwise_plan.h``; each
build reports its plan through ``ops/depthwise.wgrad_plan_for``):
``-DDW_WGRAD_RING_EXTRA=`` 1 and 4 (the ring's slots beyond
k; the plan's own is 2, fewer where two blocks an SM would not fit) and
``-DDW_WGRAD_VEC=`` 1 and 2 (a thread's channels at every k; the plan's
own is 4, 2, 1 at k = 3, 5, 7). Times the forward (the dgrad is the same
kernel with the taps reversed) and the wgrad of each build at each of
``chip_smoke.B4_DW_LAYERS`` (batch 64, bf16) through
``ops/depthwise.stencil_cuda`` and ``wgrad_cuda``, and cuDNN's grouped
conv and wgrad, with ``chip_smoke.time_ms`` (CUDA events, cold L2, median
of 25). Each build's output is held to the package's build bit for bit,
or within ``chip_smoke.dw_limit`` (the forward) or ``dw_wgrad_limit`` at
the build's plan (the wgrad) where the sums run in another order. Then
each layer at batch 8 in f32: the wgrad of the package build and of
the wgrad's builds on the TMA path, and the package build's staged-tile
wgrad, each forced through ``ops/depthwise.wgrad_path`` (swapped in this
process only), beside cuDNN's: the data behind ``wgrad_path``'s rule.

    python3 scripts/depthwise_ablation.py

Needs one NVIDIA H100 and ``nvcc``. Prints the card's name and power
limit, then one JSON line per layer.
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
from distributeddeeplearning_tpu_torch.ops import depthwise as dwm  # noqa: E402

BUILDS = {"tma": (), "tma_vector": ("-DDW_TMA_KERNEL=1",), "tma_lane": ("-DDW_TMA_KERNEL=2",),
          "tma_ring_k+1": ("-DDW_RING_EXTRA=1",), "tma_ring_k+4": ("-DDW_RING_EXTRA=4",),
          "wgrad_ring_k+1": ("-DDW_WGRAD_RING_EXTRA=1",),
          "wgrad_ring_k+4": ("-DDW_WGRAD_RING_EXTRA=4",),
          "wgrad_vec1": ("-DDW_WGRAD_VEC=1",), "wgrad_vec2": ("-DDW_WGRAD_VEC=2",)}


def build(name: str) -> ctypes.CDLL:
    """The library of ``depthwise.cu`` built with BUILDS[name]'s flags
    (none: the package's own build)."""
    flags = BUILDS[name]
    if not flags:
        return ctypes.CDLL(str(_build.build("depthwise")))
    path = _build.library_path("depthwise")
    tag = "".join(f.split("DW_")[1].replace("=", "").lower() for f in flags)
    path = path.with_name(path.stem + f"-{tag}.so")
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
                              str(_build.CSRC / "depthwise.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"build with {flags} failed:\n{res.stdout[-2000:]}")
    return ctypes.CDLL(str(path))


def main() -> int:
    if not torch.cuda.is_available():
        print("depthwise_ablation: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = cs.device_line()
    print(card, flush=True)
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(97)
    for c, h, k, _ in cs.B4_DW_LAYERS:
        x, dy = (torch.randn(64, c, h, h, device="cuda", generator=g).to(torch.bfloat16)
                 .contiguous(memory_format=torch.channels_last) for _ in range(2))
        taps = (torch.randn(k * k, c, device="cuda", generator=g) / k).to(torch.bfloat16).float()
        weight = taps.t().reshape(c, 1, k, k).to(torch.bfloat16)
        ref = dwm.stencil_plain(x.float(), taps)
        lim = cs.dw_limit(ref, dwm.stencil_plain(x.float().abs(), taps.abs()), k * k,
                          torch.bfloat16)
        wref = dwm.wgrad_plain(x.double(), dy.double(), k)
        wterms = dwm.wgrad_plain(x.double().abs(), dy.double().abs(), k)
        us, err, base, wbase, plans = {}, {}, None, None, {}
        with torch.no_grad():
            for name, lib in libs.items():
                _build._loaded["depthwise"] = lib
                out, wout = dwm.stencil_cuda(x, taps), dwm.wgrad_cuda(x, dy, k)
                if base is None:
                    base, wbase = out, wout
                plans[name] = dwm.wgrad_plan_for(x, dy, k)
                wlim = cs.dw_wgrad_limit(wterms, cs.dw_wgrad_depth(plans[name], 64, h, h))
                err[name] = {
                    "conv": "equal" if torch.equal(out, base) else cs._ratio(out, ref, lim)[1],
                    "wgrad": "equal" if torch.equal(wout, wbase) else
                    ((wout.double() - wref).abs() / wlim.clamp(min=1e-300)).max().item()}
                us[name] = {
                    "conv": cs.time_ms(lambda: dwm.stencil_cuda(x, taps), flush) * 1e3,
                    "wgrad": cs.time_ms(lambda: dwm.wgrad_cuda(x, dy, k), flush) * 1e3}
            us["cudnn"] = {
                "conv": cs.time_ms(lambda: torch.nn.functional.conv2d(
                    x, weight, padding=k // 2, groups=c), flush) * 1e3,
                "wgrad": cs.time_ms(lambda: cs.cudnn_dw_backward(
                    dy, x, weight, [False, True, False]), flush) * 1e3}
        _build._loaded.pop("depthwise")
        print(json.dumps({"layer": f"b4_{c}x{h}_k{k}", "us": us, "vs_package_build": err,
                          "wgrad_plans": plans, "card": card}), flush=True)
        del x, dy, ref, base, wbase, lim, wref, wterms
        torch.cuda.empty_cache()
    wgrad_paths_f32(libs, flush, g, card)
    return 0


def wgrad_paths_f32(libs, flush, g, card, batch: int = 8) -> None:
    """B4's layers at ``batch`` in f32: the TMA wgrad of the package
    build (``tma``) and of each wgrad build, and the package build's
    staged-tile wgrad (``tile``), each held to the plain version in f64
    within ``dw_wgrad_limit`` at its plan; µs, one JSON line a layer."""
    choose = dwm.wgrad_path
    runs = [(name, "tma") for name in libs if name == "tma" or name.startswith("wgrad_")]
    runs.append(("tma", "tile"))
    try:
        for c, h, k, _ in cs.B4_DW_LAYERS:
            x, dy = (torch.randn(batch, c, h, h, device="cuda", generator=g)
                     .contiguous(memory_format=torch.channels_last) for _ in range(2))
            wref = dwm.wgrad_plain(x.double(), dy.double(), k)
            wterms = dwm.wgrad_plain(x.double().abs(), dy.double().abs(), k)
            us, err = {}, {}
            for name, path in runs:
                key = name if path == "tma" else path
                _build._loaded["depthwise"] = libs[name]
                dwm.wgrad_path = lambda *a, _p=path, **kw: _p
                wout = dwm.wgrad_cuda(x, dy, k)
                wlim = cs.dw_wgrad_limit(wterms, cs.dw_wgrad_depth(dwm.wgrad_plan_for(x, dy, k),
                                                                   batch, h, h))
                err[key] = ((wout.double() - wref).abs() / wlim.clamp(min=1e-300)).max().item()
                us[key] = cs.time_ms(lambda: dwm.wgrad_cuda(x, dy, k), flush) * 1e3
            weight = torch.zeros(c, 1, k, k, device="cuda")
            us["cudnn"] = cs.time_ms(lambda: cs.cudnn_dw_backward(
                dy, x, weight, [False, True, False]), flush) * 1e3
            print(json.dumps({"layer": f"b4_{c}x{h}_k{k}_f32_b{batch}", "wgrad_us": us,
                              "err_over_limit": err, "card": card}), flush=True)
            del x, dy, wref, wterms
            torch.cuda.empty_cache()
    finally:
        dwm.wgrad_path = choose
        _build._loaded.pop("depthwise", None)


if __name__ == "__main__":
    sys.exit(main())
