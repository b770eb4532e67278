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
  same weights and batch (``chip_smoke.fused_vs_unfused_step``);
* the three flash-attention kernels against their plain versions at
  ``chip_smoke``'s ``cross_ragged`` and ``lm_base_train`` cases, with
  its limits (``flash_limit``, ``flash_lse_limit``) and the launch
  counters, and once through autograd on views of a packed qkv.
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cross_ragged", "lm_base_train"])
def test_cuda_flash_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl

    _, b, h, tq, tk, d, causal, _ = next(c for c in cs.FLASH_CASES if c[0] == case)
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)

    q, k, v, do = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d), randn(b, tq, h, d)
    sc = d ** -0.5
    before = dict(fl.launches_by_op)
    out, lse = fl.flash_forward(q, k, v, causal, sc)
    delta = fl.flash_delta(out, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    torch.cuda.synchronize()
    assert {op: fl.launches_by_op[op] - before[op] for op in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_o, ref_lse = fl.flash_forward_plain(qf, kf, vf, causal, sc)
    ref_dq = fl.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    ref_dk, ref_dv = fl.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    t_o, t_dq, t_dk, t_dv = cs.flash_terms(q, k, v, out, do, lse, delta, causal, sc)
    assert ((lse - ref_lse).abs() <= cs.flash_lse_limit(q, k, ref_lse, sc)).all()
    for got, ref, terms in ((out, ref_o, t_o), (dq, ref_dq, t_dq), (dk, ref_dk, t_dk),
                            (dv, ref_dv, t_dv)):
        assert ((got.float() - ref.float()).abs() <= cs.flash_limit(ref, terms)).all()


@pytest.mark.cuda
def test_cuda_flash_autograd_on_packed_qkv_views():
    """The LM's call: q, k, v as views of a packed [B, T, 3, H, d]
    projection, through autograd: one launch of each kernel, and the
    gradients of the same call on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    from distributeddeeplearning_tpu_torch.ops import flash as fl

    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 300, 3, 4, 64, device="cuda", generator=g).to(torch.bfloat16)
    do = torch.randn(2, 300, 4, 64, device="cuda", generator=g).to(torch.bfloat16)
    packed = qkv.clone().requires_grad_()
    before = dict(fl.launches_by_op)
    out = fl.flash_attention(*packed.unbind(2), causal=True)
    (grad,) = torch.autograd.grad(out, packed, do)
    assert {op: fl.launches_by_op[op] - before[op] for op in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    parts = [x.contiguous().requires_grad_() for x in qkv.unbind(2)]
    ref = fl.flash_attention(*parts, causal=True)
    grads = torch.autograd.grad(ref, parts, do)
    assert torch.equal(out, ref)
    assert torch.equal(grad, torch.stack(grads, dim=2))
