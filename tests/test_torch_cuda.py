"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): each
decides inside the test whether a card is present and skips without
one. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch for CUDA:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` configures JAX).

* both fused-block kernels against their plain version, at a ragged M,
  with the limits ``chip_smoke.py`` derives (``fb_y_limit``,
  ``fb_stats_limit``);
* one fused and one unfused bf16 ResNet-50 step at full width from the
  same weights and batch (``chip_smoke.fused_vs_unfused_step``).
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from distributeddeeplearning_tpu_torch.ops import fused_block as fb  # noqa: E402


@pytest.mark.cuda
def test_cuda_fused_block_kernels_match_plain():
    """On the card: both kernels against the plain version (f32 product
    of the same bf16 inputs), at a ragged M, with chip_smoke's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    import chip_smoke

    g = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = 3_213, 256, 128
    a = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device="cuda", generator=g) * 0.1).to(torch.bfloat16)
    mean, var = a.float().mean(0), a.float().var(0, unbiased=False)
    scale = 1.0 + 0.1 * torch.randn(k, device="cuda", generator=g)
    bias = 0.1 * torch.randn(k, device="cuda", generator=g)
    before = fb.launches
    for prologue in (False, True):
        if prologue:
            y, s, ss = fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w)
            inv = torch.rsqrt(var + 1e-5) * scale
            z = torch.relu(a.float() * inv + (bias - mean * inv)).to(torch.bfloat16)
        else:
            y, s, ss = fb.matmul_stats(a, w)
            z = a
        ref = fb.matmul_stats_plain(z.float(), w.float())[0]
        torch.cuda.synchronize()
        assert ((y.float() - ref).abs() <= chip_smoke.fb_y_limit(ref)).all()
        y64 = y.double()
        assert ((s.double() - y64.sum(0)).abs()
                <= chip_smoke.fb_stats_limit(y64.abs().sum(0), m)).all()
        assert ((ss.double() - (y64 * y64).sum(0)).abs()
                <= chip_smoke.fb_stats_limit((y64 * y64).sum(0), m)).all()
    assert fb.launches == before + 2


@pytest.mark.cuda
def test_cuda_fused_step_agrees_with_unfused_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused path runs CUDA kernels for sm_90a")
    import chip_smoke

    out = chip_smoke.fused_vs_unfused_step()  # full width, as its limits are derived
    assert out["within_limits"], out
