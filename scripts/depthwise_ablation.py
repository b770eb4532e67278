#!/usr/bin/env python3
"""The depthwise stencil's TMA kernels side by side at EfficientNet-B4's
stride-1 layers.

Builds ``distributeddeeplearning_tpu_torch/csrc/depthwise.cu`` as the
package does (the plan picks the vector kernel at k = 3 on rows wider
than 12, the lane kernel else), with ``-DDW_TMA_KERNEL=`` 1 (the vector
kernel: 16-byte channel vectors, taps in shared memory) and 2 (the lane
kernel: a channel a lane, taps in registers) forced, and with
``-DDW_RING_EXTRA=`` 1 and 4 (the ring holding one and four rows beyond
k), into the package's gitignored build directory. Times the forward of
each build at each of ``chip_smoke.B4_DW_LAYERS`` (batch 64, bf16; the
dgrad is the same kernel with the taps reversed) through
``ops/depthwise.stencil_cuda``, and cuDNN's grouped conv, with
``chip_smoke.time_ms`` (CUDA events, cold L2, median of 25). Each
build's output is held to the package's build bit for bit, or within
``chip_smoke.dw_limit`` where the sums run in another order.

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
          "tma_ring_k+1": ("-DDW_RING_EXTRA=1",), "tma_ring_k+4": ("-DDW_RING_EXTRA=4",)}


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
        x = torch.randn(64, c, h, h, device="cuda", generator=g).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        taps = (torch.randn(k * k, c, device="cuda", generator=g) / k).to(torch.bfloat16).float()
        weight = taps.t().reshape(c, 1, k, k).to(torch.bfloat16)
        ref = dwm.stencil_plain(x.float(), taps)
        lim = cs.dw_limit(ref, dwm.stencil_plain(x.float().abs(), taps.abs()), k * k,
                          torch.bfloat16)
        us, err, base = {}, {}, None
        with torch.no_grad():
            for name, lib in libs.items():
                _build._loaded["depthwise"] = lib
                out = dwm.stencil_cuda(x, taps)
                if base is None:
                    base = out
                err[name] = "equal" if torch.equal(out, base) else cs._ratio(out, ref, lim)[1]
                us[name] = cs.time_ms(lambda: dwm.stencil_cuda(x, taps), flush) * 1e3
            us["cudnn"] = cs.time_ms(lambda: torch.nn.functional.conv2d(
                x, weight, padding=k // 2, groups=c), flush) * 1e3
        _build._loaded.pop("depthwise")
        print(json.dumps({"layer": f"b4_{c}x{h}_k{k}", "us": us, "vs_package_build": err,
                          "card": card}), flush=True)
        del x, ref, base, lim
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
