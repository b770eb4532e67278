"""Tests of the port that need an NVIDIA GPU (marker ``cuda``): each
decides inside the test whether a card is present and skips without
one. The file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch for CUDA:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's ``conftest.py`` configures JAX).

* both fused-block kernels against their plain version, at a ragged M,
  with the limits ``chip_smoke.py`` derives (``fb_y_limit``, and
  ``fb_stats_limit`` at the plan's ``stat_depth``); a sweep over M ∈ {1,
  127, 129, 3,213, 200,704} × K ∈ {32, 64, 96, 2,048} × N ∈ {64, 192,
  2,048}, both ops (the prologue's shift positive, so that rows past M
  would not be zero), each call repeated bit for bit
  (``test_cuda_fused_block_sweep``);
* one fused and one unfused bf16 ResNet-50 step at full width from the
  same weights and batch (``chip_smoke.fused_vs_unfused_step``);
* the three flash-attention kernels against their plain versions at
  ``chip_smoke``'s ``cross_ragged`` and ``lm_base_train`` cases and at
  T ∈ {64, 65, 127, 128, 129, 1024, 2048} × d ∈ {32, 64, 96, 128}, causal
  and not, and four cross-attention lengths, with its limits
  (``flash_limit``, ``flash_lse_limit``), the backward run twice with
  equal bits, packed-qkv views read without a copy and one launch
  counted per call; and once through autograd on views of a packed qkv;
* both packed-QKV attention kernels against their plain versions at
  ``chip_smoke``'s ``ragged_causal`` and ``d128`` cases, at T ∈ {64, 65,
  197, 256, 257, 512} × d ∈ {32, 64, 128} and three ragged causal shapes
  (``chip_smoke.fp_check``: the flash limits, the backward's statistics
  scratch against its plain version, the backward run twice with equal
  bits; one launch counted per call, though the backward is two
  kernels), once through autograd, and ``attn_impl="auto"`` taking the
  kernel on the card;
* the dW+db kernel (bf16 at a ragged N, f32 at ViT's head) against its
  plain version, and once through ``bias_dense``'s backward; a sweep
  over N ∈ {1, 63, 64, 1000, 12,608} × (K, M) aligned (the wgmma path,
  one and several splits) and ragged (mma.sync), bf16 and f32, within
  chip_smoke's ``fg_limit``, each launch repeated bit for bit;
* the decode-attention kernel on int8 and fp8 caches (dense, paged with
  a trash block of large finite codes) against its plain version, with
  chip_smoke's ``bf16_tolerance``, and a scales-of-1 control that must
  miss it; a sweep over t ∈ {1, 5, 16, 17}, L ∈ {48, 2048}, d ∈ {32, 64,
  96, 128}, bf16 / f32 / int8 / fp8 stores, dense and paged (rows live to 1,
  16, 17 and L positions; kv_len below L with NaN past it; kv_len 0 and
  all-negative query positions, which give zeros), each call one launch
  and repeated bit for bit; and the dropped-split control;
* the depthwise stencil (forward, dgrad) and wgrad kernels against
  their plain version and cuDNN at chip_smoke's ragged, f32, k = 9 and
  one B4 case with its limits, and once through ``depthwise_conv2d``'s
  autograd (one launch of each; unsupported shapes raise); the TMA
  stencil at C ∈ {8, 24, 48, 960} × W ∈ {12, 190, 255, 257} × k ∈ {3,
  5, 7}, bf16 and f32, forward and dgrad, with a bitwise repeat; and the
  TMA wgrad over the same sweep against the plain version in f64 within
  ``dw_wgrad_limit`` at its plan's depth, with a bitwise repeat;
* quantized serving (int8 and fp8 KV and weights, paged, fused kernel)
  of a small f32 LM on the card: the kernel captured under its storage
  dtype and replayed once per layer per forward, and the greedy streams
  of the plain masked path;
* the engine's program set captured as CUDA graphs (paged and dense,
  fused and plain, int8, speculative with the int8 self-draft and with
  n-grams) against the same members run uncaptured, bit for bit, with
  no capture after ``warmup``;
* ``lm_moe_tiny`` with ``pallas`` attention and REMAT, one bf16 step
  against its eager ``xla`` twin (``chip_smoke.moe_remat_vs_xla_step``),
  and a captured REMAT + dropout step replayed against an eager step
  with stored activations, bit for bit.
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
        depth = fb.plan_for(a, w, prologue)["stat_depth"]
        assert chip_smoke._fb_stats_ratio(s, ss, y, depth) <= 1.0
    assert fb.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matmul_stats", "bn_relu_matmul_stats"])
@pytest.mark.parametrize("m", [1, 127, 129, 3_213, 200_704])
def test_cuda_fused_block_sweep(op, m):
    """Each op at M rows against the plain version over K ∈ {32, 64, 96,
    2,048} (K past a multiple of the 64-column box zero-filled) and N ∈
    {64, 192, 2,048} (panels of 64 and 256 columns): y within
    ``fb_y_limit``, the statistics within ``fb_stats_limit`` at the
    plan's depth, a second call equal bit for bit, one launch a call. The
    prologue's shift is positive, so relu(shift) of the zero rows TMA
    brings past M is not zero: they must stay out of y and the sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    import chip_smoke

    g = torch.Generator(device="cuda").manual_seed(m)
    for k in (32, 64, 96, 2048):
        a = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        mean = torch.zeros(k, device="cuda")
        var = torch.ones(k, device="cuda")
        scale = 1.0 + 0.1 * torch.randn(k, device="cuda", generator=g)
        bias = 0.5 + 0.1 * torch.rand(k, device="cuda", generator=g)  # relu(shift) > 0
        for n in (64, 192, 2048):
            w = (torch.randn(n, k, device="cuda", generator=g) * k ** -0.5).to(torch.bfloat16)
            before = fb.launches
            if op == "matmul_stats":
                outs = [fb.matmul_stats(a, w) for _ in range(2)]
                z = a
            else:
                outs = [fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w) for _ in range(2)]
                inv = torch.rsqrt(var + 1e-5) * scale
                z = torch.relu(a.float() * inv + (bias - mean * inv)).to(torch.bfloat16)
            torch.cuda.synchronize()
            assert fb.launches == before + 2
            (y, s, ss), (y2, s2, ss2) = outs
            assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2), (k, n)
            ref = fb.matmul_stats_plain(z.float(), w.float())[0]
            assert ((y.float() - ref).abs() <= chip_smoke.fb_y_limit(ref)).all(), (k, n)
            depth = fb.plan_for(a, w, op != "matmul_stats")["stat_depth"]
            assert chip_smoke._fb_stats_ratio(s, ss, y, depth) <= 1.0, (k, n)
            del outs, y, y2, ref


@pytest.mark.cuda
def test_cuda_fused_step_agrees_with_unfused_step():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused path runs CUDA kernels for sm_90a")
    import chip_smoke

    out = chip_smoke.fused_vs_unfused_step()  # full width, as its limits are derived
    assert out["within_limits"], out


def _flash_check(b, h, tq, tk, d, causal, seed=0):
    """The three flash kernels against their plain versions with
    chip_smoke's limits (``flash_limit``, ``flash_lse_limit``): the
    backward runs twice and must repeat bit for bit, each call counts one
    launch, and where Tq == Tk q, k and v are the LM's views of a packed
    [B, T, 3, H, d] projection, read in place (no copy)."""
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)

    if tq == tk:
        q, k, v = randn(b, tq, 3, h, d).unbind(2)
        assert all(fl._rows(x) is x for x in (q, k, v))
    else:
        q, k, v = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d)
    do = randn(b, tq, h, d)
    sc = d ** -0.5
    before = dict(fl.launches_by_op)
    out, lse = fl.flash_forward(q, k, v, causal, sc)
    delta = fl.flash_delta(out, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    dq2 = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk2, dv2 = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    torch.cuda.synchronize()
    assert {op: fl.launches_by_op[op] - before[op] for op in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_o, ref_lse = fl.flash_forward_plain(qf, kf, vf, causal, sc)
    ref_dq = fl.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    ref_dk, ref_dv = fl.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    t_o, t_dq, t_dk, t_dv = cs.flash_terms(q, k, v, out, do, lse, delta, causal, sc)
    assert ((lse - ref_lse).abs() <= cs.flash_lse_limit(q, k, ref_lse, sc)).all()
    for what, got, ref, terms in (("O", out, ref_o, t_o), ("dQ", dq, ref_dq, t_dq),
                                  ("dK", dk, ref_dk, t_dk), ("dV", dv, ref_dv, t_dv)):
        assert ((got.float() - ref.float()).abs() <= cs.flash_limit(ref, terms)).all(), what


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cross_ragged", "lm_base_train"])
def test_cuda_flash_kernels_match_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs

    _, b, h, tq, tk, d, causal, _ = next(c for c in cs.FLASH_CASES if c[0] == case)
    _flash_check(b, h, tq, tk, d, causal)


# (Tq, Tk, d, causal): every T of the kernels' tile edges and the LM's
# lengths, each head dim, causal and not; then cross-attention lengths.
FLASH_SHAPES = ([(t, t, d, c) for t in (64, 65, 127, 128, 129, 1024, 2048)
                 for d in (32, 64, 96, 128) for c in (False, True)]
                + [(100, 300, 64, False), (300, 100, 32, False), (65, 1024, 128, False),
                   (1024, 129, 96, False)])


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,d,causal", FLASH_SHAPES,
                         ids=[f"q{tq}-k{tk}-d{d}" + ("-causal" if c else "")
                              for tq, tk, d, c in FLASH_SHAPES])
def test_cuda_flash_shapes_match_plain(tq, tk, d, causal):
    """The three kernels at every shape of FLASH_SHAPES (B 2, H 2; B 1 past
    T 1000), on packed-qkv views where Tq == Tk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    _flash_check(1 if max(tq, tk) > 1000 else 2, 2, tq, tk, d, causal, seed=tq + d)


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_causal", "d128"])
def test_cuda_packed_attention_kernels_match_plain(case):
    """Both packed-attention kernels against their plain versions at
    chip_smoke's cases, with its limits, and one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the packed attention kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

    flush = torch.empty(1024, device="cuda")
    before = dict(fp.launches_by_op)
    case_line = cs.fp_case(fp, fl, *next(c for c in cs.FP_CASES if c[0] == case), flush,
                           torch.Generator(device="cuda").manual_seed(0))
    assert max(case_line["err_over_limit"].values()) <= 1.0
    # the case's own checks (the backward twice), then the timed launches
    # (3 warm-up + 25 each)
    assert {op: fp.launches_by_op[op] - before[op] for op in before} == {
        "fused_qkv_fwd": 1 + 28, "fused_qkv_bwd": 2 + 28}


PACKED_SHAPES = ([(t, d, False) for t in (64, 65, 197, 256, 257, 512) for d in (32, 64, 128)]
                 + [(100, 64, True), (197, 32, True), (257, 128, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,causal", PACKED_SHAPES,
                         ids=[f"t{t}-d{d}" + ("-causal" if c else "") for t, d, c in PACKED_SHAPES])
def test_cuda_packed_attention_shapes_match_plain(t, d, causal):
    """Both kernels (the forward; the backward's dq and dk/dv kernels and
    their statistics scratch) against their plain versions with
    chip_smoke's limits at B = 2, H = 2; the backward repeats bit for bit
    and each call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the packed attention kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

    before = dict(fp.launches_by_op)
    errs, _, (qkv, do, out) = cs.fp_check(fp, fl, f"t{t}_d{d}", 2, t, 2, d, causal,
                                          torch.Generator(device="cuda").manual_seed(t + d))
    assert max(ratio for _, ratio in errs.values()) <= 1.0
    assert {op: fp.launches_by_op[op] - before[op] for op in before} == {
        "fused_qkv_fwd": 1, "fused_qkv_bwd": 2}
    first = fp.fused_qkv_backward(qkv, out, do, 2, causal, d ** -0.5)
    assert torch.equal(first, fp.fused_qkv_backward(qkv, out, do, 2, causal, d ** -0.5))


@pytest.mark.cuda
def test_cuda_packed_attention_autograd_and_auto():
    """ViT's call: ``fused_qkv_attention`` through autograd launches each
    kernel once and equals the two launchers; ``attn_impl="auto"`` on
    the card takes the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the packed attention kernels are CUDA C++ for sm_90a")
    from distributeddeeplearning_tpu_torch.models.vit import Attention
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 197, 3 * 4 * 64, device="cuda", generator=g).to(torch.bfloat16)
    do = torch.randn(2, 197, 4 * 64, device="cuda", generator=g).to(torch.bfloat16)
    x = qkv.clone().requires_grad_()
    before = dict(fp.launches_by_op)
    out = fp.fused_qkv_attention(x, 4)
    (grad,) = torch.autograd.grad(out, x, do)
    assert {op: fp.launches_by_op[op] - before[op] for op in before} == {
        "fused_qkv_fwd": 1, "fused_qkv_bwd": 1}
    ref = fp.fused_qkv_forward(qkv, 4, False, 64 ** -0.5)
    assert torch.equal(out, ref)
    assert torch.equal(grad, fp.fused_qkv_backward(qkv, ref, do, 4, False, 64 ** -0.5))
    attn = Attention(256, 4, torch.bfloat16, device="cuda", attn_impl="auto")
    for p in attn.parameters():
        torch.nn.init.normal_(p, std=0.05)
    before = fp.launches_by_op["fused_qkv_fwd"]
    with torch.no_grad():
        attn(torch.randn(2, 197, 256, device="cuda", generator=g).to(torch.bfloat16))
    assert fp.launches_by_op["fused_qkv_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_n", "vit_b16_head_f32"])
def test_cuda_dw_db_kernel_matches_plain(case):
    """``matmul_dw_db`` (bf16 at a ragged N; f32 at ViT's head) against
    its plain version with chip_smoke's limit, and through
    ``bias_dense``'s backward: one launch, dW and db as the launcher's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dW+db kernel is CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import fused_grads as fg

    _, n, k, m, dtype = next(c for c in cs.FG_CASES if c[0] == case)
    line = cs.fg_case(fg, case, n, k, m, dtype, torch.empty(1024, device="cuda"),
                      torch.Generator(device="cuda").manual_seed(0))
    assert max(line["err_over_limit"].values()) <= 1.0
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(n, k, device="cuda", generator=g).requires_grad_()
    w = torch.randn(m, k, device="cuda", generator=g).requires_grad_()
    b = torch.randn(m, device="cuda", generator=g).requires_grad_()
    gy = torch.randn(n, m, device="cuda", generator=g)
    before = fg.launches
    y = fg.bias_dense(x, w, b, dtype)
    _, dw, db = torch.autograd.grad(y, (x, w, b), gy.to(y.dtype))
    assert fg.launches == before + 1
    want_dw, want_db = fg.matmul_dw_db_cuda(x.detach().to(dtype), gy.to(dtype))
    assert torch.equal(dw, want_dw) and torch.equal(db, want_db)


# (K, M) of the dW+db sweep: ViT-B/16's qkv and fc2 widths, a narrow
# aligned pair (the wgmma path: tile edges masked), an odd count of M
# tiles, and two ragged pairs (mma.sync: element loads, tiles
# part-filled).
DW_DB_SWEEP_KM = ((768, 2304), (3072, 768), (264, 136), (256, 384), (250, 390), (12, 20))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [1, 63, 64, 1000, 12_608])
def test_cuda_dw_db_kernel_sweep(n, dtype):
    """``matmul_dw_db`` against its plain version (f32 on the same
    inputs) within chip_smoke's ``fg_limit``, at one N and every (K, M)
    of the sweep; each launch repeated bit for bit; bf16 aligned shapes
    on the wgmma path, ragged ones on mma.sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the dW+db kernel is CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import fused_grads as fg

    g = torch.Generator(device="cuda").manual_seed(n)
    for k, m in DW_DB_SWEEP_KM:
        x = torch.randn(n, k, device="cuda", generator=g).to(dtype)
        gr = torch.randn(n, m, device="cuda", generator=g).to(dtype)
        plan = fg.plan_for(x, gr)
        want = "f32" if dtype == torch.float32 else (
            "wgmma" if k % 8 == 0 and m % 8 == 0 else "mma_sync")
        what = f"n{n} k{k} m{m} {dtype} {plan}"
        assert plan["path"] == want, what
        dw, db = fg.matmul_dw_db_cuda(x, gr)
        dw2, db2 = fg.matmul_dw_db_cuda(x, gr)
        torch.cuda.synchronize()
        assert torch.equal(dw, dw2) and torch.equal(db, db2), what
        ref_dw, ref_db = fg.matmul_dw_db_plain(x, gr)
        xa, ga = x.float().abs(), gr.float().abs()
        assert cs._ratio(dw, ref_dw, cs.fg_limit(ga.t() @ xa, n))[1] <= 1.0, what
        assert cs._ratio(db, ref_db, cs.fg_limit(ga.sum(0), n))[1] <= 1.0, what


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_quantized_decode_kernel_matches_plain(kind, paged):
    """The kernel on int8 / fp8 codes with f32 scales against its plain
    version in f32 on the same codes (a 5-wide verify window, ragged
    positions), within chip_smoke's bf16 tolerance; the same codes with
    scales of 1 must miss it (the scales are read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel is CUDA C++ for sm_90a")
    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    from distributeddeeplearning_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(3)
    b, h, d, length, bs = 4, 8, 64, 96, 16
    q = torch.randn(b, 5, h, d, device="cuda", generator=g).to(torch.bfloat16)
    pos = (torch.tensor([0, 17, 50, 91], device="cuda")[:, None]
           + torch.arange(5, device="cuda")).int()
    if paged:
        rows = (b * length // bs + 1, bs)
        table = torch.arange(1, rows[0], device="cuda", dtype=torch.int32).view(b, -1)
        table = table.flip(1).contiguous()  # shuffled: logical j -> a late block
        table[0, 2:] = 0  # row 0 owns 2 blocks: its tail reads the trash block
        kw = dict(block_table=table, block_size=bs)
    else:
        rows, kw = (b, length), {}
    kx = torch.randn(*rows, h, d, device="cuda", generator=g)
    vx = torch.randn(*rows, h, d, device="cuda", generator=g)
    (k, ks), (v, vs) = quant.quantize_kv(kx, kind), quant.quantize_kv(vx, kind)
    if paged:
        for c, sc in ((k, ks), (v, vs)):
            c[0] = 127 if kind == "int8" else 448  # finite garbage
            sc[0] = 1e2
    before = dict(pd.launches_by_store)
    out = pd.fused_decode_attention(q, k, v, pos, k_scale=ks, v_scale=vs, **kw)
    ref = pd.fused_decode_attention_plain(q.float(), k, v, pos, k_scale=ks, v_scale=vs, **kw)
    ones = torch.ones_like(ks)
    wrong = pd.fused_decode_attention(q, k, v, pos, k_scale=ones, v_scale=ones, **kw)
    torch.cuda.synchronize()
    assert pd.launches_by_store[kind] == before[kind] + 2
    tol = chip_smoke.bf16_tolerance(ref)
    assert torch.isfinite(out.float()).all()
    assert ((out.float() - ref).abs() <= tol).all()
    assert ((wrong.float() - ref).abs() / tol).max().item() > 10


def _decode_inputs(store, paged, d, length, t, g, kv_len=None):
    """Four cache rows whose live lengths are 1, 16, 17 and L (each row's
    window of t query positions ends there; earlier rows of the window
    sit at 0), H = 768 / d heads, and the cache in ``store``: dense, or a
    pool of 16-position blocks through a shuffled table whose unowned
    entries point at trash block 0, which holds large finite garbage.
    Quantized stores hold ops/quant.quantize_kv's codes and scales. With
    ``kv_len`` below L, every position past it holds NaN (scales, when
    quantized): the kernel must read none of them."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.ops import quant

    dev, h, bs = "cuda", 768 // d, 16
    compute = torch.float32 if store == "f32" else torch.bfloat16
    lives = np.array([1, 16, 17, length])
    pos = np.maximum(lives[:, None] - t + np.arange(t), 0).astype(np.int32)
    rng = np.random.RandomState(length + t + d)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(compute)

    if paged:
        mb = length // bs
        nb = 4 * mb + 1
        k, v = randn(nb, bs, h, d), randn(nb, bs, h, d)
        k[0], v[0] = 1e4, -1e4
        perm = rng.permutation(np.arange(1, nb))
        table = np.zeros((4, mb), np.int32)
        for r in range(4):
            n = -(-int(lives[r]) // bs)
            table[r, :n] = perm[r * mb:r * mb + n]
        table = torch.from_numpy(table).to(dev)
        kw = dict(block_table=table, block_size=bs)
    else:
        k, v = randn(4, length, h, d), randn(4, length, h, d)
        kw = {}
    scales = {}
    if store in ("int8", "fp8"):
        (k, ks), (v, vs) = quant.quantize_kv(k, store), quant.quantize_kv(v, store)
        if paged:
            for c, sc in ((k, ks), (v, vs)):
                c[0] = 127 if store == "int8" else 448
                sc[0] = 1e2
        scales = dict(k_scale=ks, v_scale=vs)
    if kv_len is not None:
        kw["kv_len"] = kv_len
        owned = table.cpu().numpy() if paged else None
        for x in (scales.values() if scales else (k, v)):
            if not paged:
                x[:, kv_len:] = float("nan")
                continue
            for r in range(4):  # owned blocks only: the trash block stays finite
                for p in range(kv_len, length):
                    if owned[r, p // bs]:
                        x[owned[r, p // bs], p % bs] = float("nan")
    q = randn(4, t, h, d)
    return q, k, v, torch.from_numpy(pos).to(dev), dict(kw, **scales)


DECODE_STORES = ("bf16", "f32", "int8", "fp8")


@pytest.mark.cuda
@pytest.mark.parametrize("store", DECODE_STORES)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_cuda_decode_kernel_sweep(store, paged, d):
    """The decode kernel against its plain version (f32, on the same
    inputs and codes) within chip_smoke's bf16_tolerance, at t in {1, 5,
    16, 17} and L in {48, 2048}, rows live to 1, 16, 17 and L positions,
    once with kv_len = 37 and NaN past it, and, at L 2048 (many splits),
    with nothing live: kv_len = 0 (every position NaN), and a row whose
    query positions are all negative. Each call counts one launch and
    repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel is CUDA C++ for sm_90a")
    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import paged_decode as pd

    g = torch.Generator(device="cuda").manual_seed(d)
    shapes = [(length, t, None, False) for length in (48, 2048) for t in (1, 5, 16, 17)]
    empty = [(48, 5, 37, False), (2048, 1, 0, False), (2048, 17, 0, False), (2048, 5, None, True)]
    for length, t, kv_len, negative in shapes + empty:
        q, k, v, pos, kw = _decode_inputs(store, paged, d, length, t, g, kv_len)
        if negative:
            pos[0] = -1
        before = pd.launches
        out = pd.fused_decode_attention(q, k, v, pos, **kw)
        again = pd.fused_decode_attention(q, k, v, pos, **kw)
        if store in ("int8", "fp8"):
            ref = pd.fused_decode_attention_plain(q.float(), k, v, pos, **kw)
        else:
            ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), pos, **kw)
        torch.cuda.synchronize()
        what = (f"{store} {'paged' if paged else 'dense'} d{d} L{length} t{t} kv_len {kv_len}"
                f"{' row 0 at -1' if negative else ''}")
        assert pd.launches == before + 2, what
        assert torch.equal(out, again), what
        assert torch.isfinite(out.float()).all(), what
        if kv_len == 0 or negative:  # nothing live: zeros, as the plain version gives
            n_empty = len(out) if kv_len == 0 else 1
            assert not out[:n_empty].float().any() and not ref[:n_empty].any(), what
            out, ref = out[n_empty:], ref[n_empty:]
        if len(out):
            ratio = ((out.float() - ref).abs() / chip_smoke.bf16_tolerance(ref)).max().item()
            assert ratio <= 1.0, (what, ratio)


@pytest.mark.cuda
def test_cuda_decode_drop_last_split_control():
    """The wrong variant that drops each tile's last live split misses
    the tolerance by far at lm_base's decode shape (16 splits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel is CUDA C++ for sm_90a")
    import chip_smoke
    from distributeddeeplearning_tpu_torch.ops import paged_decode as pd

    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, pos, kw = _decode_inputs("bf16", True, 64, 2048, 1, g)
    ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), pos, **kw)
    bad = pd.fused_decode_attention(q, k, v, pos, drop_last_split=True, **kw)
    ratio = ((bad.float() - ref).abs() / chip_smoke.bf16_tolerance(ref)).max().item()
    assert ratio > 10


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_cuda_quantized_served_streams(kind):
    """A small f32 LM served on the card with int8 / fp8 KV and weights,
    paged: through the fused kernel (once per layer per forward, counted
    under the storage dtype) it emits the plain masked path's greedy
    streams, and its pools hold the storage dtype (no fall-back)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel is CUDA C++ for sm_90a")
    import numpy as np

    from distributeddeeplearning_tpu_torch.models import convert
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine

    vocab, max_len = 256, 128
    params = convert.init_params("tiny", vocab, torch.Generator().manual_seed(0), max_len)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, size=n).astype(np.int32) for n in (5, 40, 17, 64)]
    streams, counts = {}, {}
    for kernel in ("xla", "fused"):
        model = TransformerLM("tiny", vocab_size=vocab, max_seq_len=max_len,
                              dtype=torch.float32, device="cuda")
        engine = SlotEngine(model, params, num_slots=3, kv_layout="paged", block_size=16,
                            kv_dtype=kind, weight_dtype=kind, decode_kernel=kernel,
                            device="cuda")
        captured = pd.launches_by_store[kind]
        engine.warmup()  # the captures launch the kernel under the storage dtype
        captured = pd.launches_by_store[kind] - captured
        server = Server(engine)
        before = pd.launches
        handles = [server.submit(Request(prompt=p, max_new_tokens=12)) for p in prompts]
        server.drain()
        assert pd.launches == before  # every launch came from a graph's replay
        counts[kernel] = (captured, engine.replayed_launches(),
                          len(model.blocks) * (engine.prefill_execs + engine.decode_steps))
        streams[kernel] = [h.new_tokens for h in handles]
        assert engine._stores[0][0].dtype == (torch.int8 if kind == "int8"
                                              else torch.float8_e4m3fn)
    assert counts["xla"][:2] == (0, 0)
    assert counts["fused"][0] > 0 and counts["fused"][1] == counts["fused"][2] > 0
    assert streams["fused"] == streams["xla"]


GRAPH_CONFIGS = {
    "paged_fused": dict(kv_layout="paged", block_size=16, decode_kernel="fused"),
    "dense_xla": dict(),
    "dense_fused": dict(decode_kernel="fused"),
    "int8_paged_fused": dict(kv_layout="paged", block_size=16, decode_kernel="fused",
                             kv_dtype="int8", weight_dtype="int8"),
    "spec_int8": dict(kv_layout="paged", block_size=16, decode_kernel="fused", spec_k=4,
                      spec_draft="int8"),
    "spec_ngram": dict(kv_layout="paged", block_size=16, decode_kernel="fused", spec_k=4,
                       spec_draft="ngram"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(GRAPH_CONFIGS))
def test_cuda_graphed_engine_matches_uncaptured(config):
    """The engine's closed program set captured as CUDA graphs serves a
    mix of greedy, top-k and nucleus requests (one with an eos) with the
    streams of the same members run uncaptured
    (``ProgramSpec.uncaptured``), bit for bit; every variant of every
    member is captured; ``compile_count`` is ``programs_expected`` after warmup and
    stays there through the mix and a second warmup; the decode kernel's
    launches all come from replays, once per layer per forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the decode kernel")
    import numpy as np

    from distributeddeeplearning_tpu_torch.models import convert
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine

    vocab, max_len = 256, 128
    params = convert.init_params("tiny", vocab, torch.Generator().manual_seed(0), max_len)
    rng = np.random.RandomState(1)
    reqs = []
    for i, n in enumerate((5, 40, 17, 64, 9, 30)):
        kw = [dict(), dict(temperature=0.8, top_k=20), dict(temperature=1.1, top_p=0.9),
              dict(eos_token=7)][i % 4]
        reqs.append(Request(prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                            max_new_tokens=12, rng=i, **kw))
    streams = {}
    for graphed in (True, False):
        model = TransformerLM("tiny", vocab_size=vocab, max_seq_len=max_len,
                              device="cuda")
        engine = SlotEngine(model, params, num_slots=3, buckets=(16, 32, 64, 128),
                            device="cuda", **GRAPH_CONFIGS[config])
        if not graphed:
            engine.programs.update({ps.name: ps.uncaptured() for ps in engine.program_specs()})
        engine.warmup()
        want = engine.programs_expected if graphed else 0
        assert engine.compile_count == want
        server = Server(engine)
        launches = pd.launches
        handles = [server.submit(r) for r in reqs]
        server.drain()
        engine.warmup()
        assert engine.compile_count == want  # no capture after warmup
        streams[graphed] = [h.new_tokens for h in handles]
        if graphed:
            assert pd.launches == launches
            forwards = engine.prefill_execs + engine.decode_steps
            fused = GRAPH_CONFIGS[config].get("decode_kernel") == "fused"
            dense_prefills = 0 if engine.kv_layout == "paged" else engine.prefill_execs
            assert engine.replayed_launches() == (
                len(model.blocks) * (forwards - dense_prefills) if fused else 0)
            assert engine.graph_pool_bytes > 0
            assert engine.graphs_captured == sum(
                len(ps.variants) for ps in engine.program_specs())
    assert streams[True] == streams[False]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged_13x11_c130_k7", "ragged_13x11_c130_k3_f32",
                                  "direct_13x11_c130_k9", "b4_672x24_k3"])
def test_cuda_depthwise_kernels_match_plain(case):
    """The stencil (forward, dgrad) and the wgrad against the plain
    version (f32; the wgrad f64) and cuDNN, with chip_smoke's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depthwise kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import depthwise as dwm

    _, b, h, w, c, k, dtype = next(cs_ for cs_ in cs.DW_CASES if cs_[0] == case)
    line = cs.dw_case(dwm, case, b, h, w, c, k, dtype, torch.empty(1024, device="cuda"),
                      torch.Generator(device="cuda").manual_seed(0))
    assert max(line["err_over_limit"].values()) <= 1.0
    assert max(line["cudnn_err_over_limit"].values()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_cuda_depthwise_tma_stencil_sweep(k, dtype):
    """The TMA row-ring stencil (forward and dgrad) against the plain
    version in f32 within chip_smoke's dw_limit, at C in {8, 24, 48, 960}
    and W in {12, 190, 255, 257} (one box, and two boxes a padded row),
    H 11, each launch repeated bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depthwise kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import depthwise as dwm

    g = torch.Generator(device="cuda").manual_seed(k)
    for c in (8, 24, 48, 960):
        for w in (12, 190, 255, 257):
            b, h = (1, 11) if c * w > 20_000 else (2, 11)
            assert dwm.stencil_path(b, h, w, c, k, dtype) == "tma"
            x = torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last)
            taps = (torch.randn(k * k, c, device="cuda", generator=g) / k).to(dtype).float()
            for flip in (False, True):
                got = dwm.stencil_cuda(x, taps, flip)
                again = dwm.stencil_cuda(x, taps, flip)
                ref = dwm.stencil_plain(x.float(), taps, flip)
                lim = cs.dw_limit(ref, dwm.stencil_plain(x.float().abs(), taps.abs(), flip),
                                  k * k, dtype)
                torch.cuda.synchronize()
                what = f"c{c} w{w} k{k} {dtype} flip={flip}"
                assert torch.equal(got, again), what
                assert got.dtype == dtype and got.shape == x.shape, what
                _, ratio = cs._ratio(got, ref, lim)
                assert ratio <= 1.0, (what, ratio)


@pytest.mark.cuda
def test_cuda_depthwise_autograd_launches_each_kernel_once():
    """``depthwise_conv2d`` on the card: the forward, dgrad and wgrad
    kernels once each, dx and dw as the raw launchers give them (dw in
    the weight's dtype); an unsupported shape raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depthwise kernels are CUDA C++ for sm_90a")
    from distributeddeeplearning_tpu_torch.ops import depthwise as dwm

    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(2, 48, 19, 23, device="cuda", generator=g).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    weight = torch.randn(48, 1, 5, 5, device="cuda", generator=g).requires_grad_()
    gy = torch.randn(2, 48, 19, 23, device="cuda", generator=g).to(torch.bfloat16)
    before = dict(dwm.launches_by_op)
    y = dwm.depthwise_conv2d(x, weight)
    dx, dw = torch.autograd.grad(y, (x, weight), gy)
    torch.cuda.synchronize()
    assert {k: dwm.launches_by_op[k] - before[k] for k in before} == {
        "depthwise_conv": 1, "depthwise_dgrad": 1, "depthwise_wgrad": 1}
    taps = weight.detach().reshape(48, 25).t().contiguous()
    assert torch.equal(y, dwm.stencil_cuda(x.detach(), taps))
    assert torch.equal(dx, dwm.stencil_cuda(gy, taps, flip=True))
    want = dwm.wgrad_cuda(x.detach(), gy, 5).t().reshape(48, 1, 5, 5)
    assert dw.dtype == torch.float32 and torch.equal(dw, want)
    with pytest.raises(ValueError):
        dwm.depthwise_conv2d(x.detach(), weight.detach()[:, :, :4, :4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_cuda_depthwise_wgrad_sweep(k, dtype, monkeypatch):
    """The TMA wgrad against the plain version in f64 within chip_smoke's
    ``dw_wgrad_limit`` at its plan's depth, at C in {8, 24, 48, 960} and
    W in {12, 190, 255, 257} (one column tile, and several), H 11; each
    launch repeated bit for bit. The TMA path is taken wherever
    ``stencil_path`` allows it, f32 rows of 12 included, which
    ``wgrad_path`` would send to the staged tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the depthwise kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import depthwise as dwm

    monkeypatch.setattr(dwm, "wgrad_path", dwm.stencil_path)

    g = torch.Generator(device="cuda").manual_seed(10 + k)
    for c in (8, 24, 48, 960):
        for w in (12, 190, 255, 257):
            b, h = (1, 11) if c * w > 20_000 else (2, 11)
            x, dy = (torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype).contiguous(
                memory_format=torch.channels_last) for _ in range(2))
            plan = dwm.wgrad_plan_for(x, dy, k)
            what = f"c{c} w{w} k{k} {dtype} {plan}"
            assert plan["path"] == "tma", what
            got = dwm.wgrad_cuda(x, dy, k)
            again = dwm.wgrad_cuda(x, dy, k)
            torch.cuda.synchronize()
            assert torch.equal(got, again), what
            ref = dwm.wgrad_plain(x.double(), dy.double(), k)
            lim = cs.dw_wgrad_limit(dwm.wgrad_plain(x.double().abs(), dy.double().abs(), k),
                                    cs.dw_wgrad_depth(plan, b, h, w))
            ratio = ((got.double() - ref).abs() / lim.clamp(min=1e-300)).max().item()
            assert got.shape == (k * k, c) and ratio <= 1.0, (what, ratio)


@pytest.mark.cuda
def test_cuda_moe_pallas_remat_step_agrees_with_xla_step():
    """``lm_moe_tiny`` (4 experts) with ``pallas`` attention and REMAT,
    one bf16 step against its eager ``xla`` twin with stored activations,
    within ``chip_smoke.lm_pallas_vs_xla_step``'s limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pallas path runs CUDA kernels for sm_90a")
    import chip_smoke

    out = chip_smoke.moe_remat_vs_xla_step()
    assert out["within_limits"], out


@pytest.mark.cuda
def test_cuda_graphed_remat_dropout_step_equals_stored_step():
    """A captured train step of ``lm_moe_tiny`` (``pallas``, dropout 0.1,
    REMAT) replayed against an eager step without REMAT from the same
    weights, seed and step: the same masks from the registered
    generator, the recompute the same kernels; the parameters after one
    SGD step equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph and the flash kernels need the card")
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    vocab, seq = 512, 128
    sd = convert.init_params("tiny", vocab, torch.Generator(device="cuda").manual_seed(1), seq, 4)
    batch = next(iter(SyntheticTokenDataset(length=4, global_batch_size=4, seq_len=seq,
                                            vocab_size=vocab, num_physical_batches=1).epoch(0)))
    finals = {}
    for remat in (False, True):
        cfg = TrainConfig(model="lm_moe_tiny", batch_size_per_device=4, num_classes=vocab,
                          attn_impl="pallas", remat=remat, moe_experts=4)
        model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=seq, device="cuda",
                          dropout=0.1)
        tx, _ = create_optimizer(cfg, 10)
        state = create_train_state(model, cfg, tx, device="cuda", state_dict=sd)
        step = make_train_step(model, tx, cfg, device="cuda")
        if remat:
            step.aot_compile(state, batch)
            assert step.graphs == 1
        state, _ = step(state, batch)
        assert step.eager_calls == 0 or not remat
        finals[remat] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k, v in finals[False].items():
        assert torch.equal(finals[True][k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", ["pjit_tp", "pp_gpipe"])
def test_cuda_two_rank_mesh_world(scenario, tmp_path):
    """On the card: a two-rank world from ``DDL_*`` (the ranks share the
    card under gloo, or NCCL on two cards) running ``chip_smoke``'s mesh
    scenario at ``lm_small`` widths (8 layers, T 256): the f32 first step
    held to one rank's step, and the flash kernels' launches a bf16 step
    (tp: 8 a pass; GPipe: 4 layers a stage × 4 microbatches = 16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    import chip_smoke

    sc = next(s for s in chip_smoke.MESH_SCENARIOS if s["name"] == scenario)
    size = dict(chip_smoke.MESH_SIZE, variant="small", seq=256, timed=1)
    got = chip_smoke.mesh_phase(chip_smoke.device_line(), scenarios=(sc,), tmp=str(tmp_path),
                                size=size)
    assert got[scenario]["flash_fwd"] == (16 if scenario == "pp_gpipe" else 8)


@pytest.mark.cuda
def test_cuda_two_rank_expert_parallel_world(tmp_path):
    """On the card: ``chip_smoke``'s ``pjit_ep`` scenario (data 1, expert 2)
    at ``lm_moe_small`` widths (8 layers, 4 routed over 8 experts, T 256):
    the f32 first step held to one rank's step, the replicated parameters
    bitwise equal across the expert ranks after the bf16 steps
    (``mesh_phase`` raises otherwise), and 8 flash launches a pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    import chip_smoke

    sc = next(s for s in chip_smoke.MESH_SCENARIOS if s["name"] == "pjit_ep")
    size = dict(chip_smoke.MESH_SIZE, variant="small", seq=256, timed=1)
    got = chip_smoke.mesh_phase(chip_smoke.device_line(), scenarios=(sc,), tmp=str(tmp_path),
                                size=size)
    assert got["pjit_ep"]["flash_fwd"] == 8 and got["pjit_ep"]["flash_bwd_dkv"] == 8


def _generic_flash_check(b, h, tq, tk, d, causal, dtype, seed=0):
    """The generic flash kernels (``csrc/flash_generic.cu``) against their
    plain versions with chip_smoke's limits for the dtype
    (``_generic_limits``, ``flash_lse_limit``): every launch counted on
    the generic route and none on the wgmma route, the backward run twice
    with equal bits, and where Tq == Tk q, k and v are strided views of a
    packed [B, T, 3, H, d] projection."""
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    if tq == tk:
        q, k, v = randn(b, tq, 3, h, d).unbind(2)
    else:
        q, k, v = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d)
    do = randn(b, tq, h, d)
    sc = d ** -0.5
    before = dict(fl.generic_launches_by_op)
    wgmma = fl.launches_by_route["wgmma"]
    out, lse = fl.flash_forward(q, k, v, causal, sc)
    delta = fl.flash_delta(out, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    dq2 = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk2, dv2 = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    torch.cuda.synchronize()
    assert {op: fl.generic_launches_by_op[op] - before[op] for op in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert fl.launches_by_route["wgmma"] == wgmma
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert out.dtype == dtype and dq.dtype == dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_o, ref_lse = fl.flash_forward_plain(qf, kf, vf, causal, sc)
    ref_dq = fl.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    ref_dk, ref_dv = fl.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    limit, (t_o, t_dq, t_dk, t_dv) = cs._generic_limits(q, k, v, out, do, lse, delta, causal, sc)
    assert ((lse - ref_lse).abs() <= cs.flash_lse_limit(q, k, ref_lse, sc)).all()
    for what, got, ref, terms in (("O", out, ref_o, t_o), ("dQ", dq, ref_dq, t_dq),
                                  ("dK", dk, ref_dk, t_dk), ("dV", dv, ref_dv, t_dv)):
        ratio = cs._ratio(got, ref, limit(ref, terms))[1]
        assert ratio <= 1.0, (what, ratio)


# (Tq, Tk, d, causal, dtype): f32 at head dims on both sides of each
# padded width (64, 128, 256), bf16 at the head dims the wgmma kernels do
# not take; T of one row, ragged tiles and two tiles; cross lengths.
GENERIC_FLASH_SHAPES = (
    [(t, t, d, c, torch.float32) for t in (1, 65, 129) for d in (8, 64, 80, 128, 200, 256)
     for c in (False, True)]
    + [(t, t, d, c, torch.bfloat16) for t in (65, 129) for d in (16, 48, 80, 256)
       for c in (False, True)]
    + [(100, 300, 64, False, torch.float32), (300, 100, 80, False, torch.bfloat16)])


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,d,causal,dtype", GENERIC_FLASH_SHAPES,
                         ids=[f"q{tq}-k{tk}-d{d}-{str(dt)[6:]}" + ("-causal" if c else "")
                              for tq, tk, d, c, dt in GENERIC_FLASH_SHAPES])
def test_cuda_generic_flash_matches_plain(tq, tk, d, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the generic flash kernels are CUDA C++ for sm_90a")
    _generic_flash_check(2, 3, tq, tk, d, causal, dtype, seed=tq + d)


@pytest.mark.cuda
def test_cuda_generic_flash_autograd_and_control():
    """f32 flash attention through autograd on views of a packed qkv
    takes the generic route (one launch of each kernel) and equals the
    same call on contiguous copies; the dropped-tile variant misses the
    O limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the generic flash kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl

    g = torch.Generator(device="cuda").manual_seed(2)
    qkv = torch.randn(2, 300, 3, 4, 80, device="cuda", generator=g)
    do = torch.randn(2, 300, 4, 80, device="cuda", generator=g)
    packed = qkv.clone().requires_grad_()
    before = dict(fl.generic_launches_by_op)
    out = fl.flash_attention(*packed.unbind(2), causal=True)
    (grad,) = torch.autograd.grad(out, packed, do)
    assert {op: fl.generic_launches_by_op[op] - before[op] for op in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    parts = [x.contiguous().requires_grad_() for x in qkv.unbind(2)]
    ref = fl.flash_attention(*parts, causal=True)
    assert torch.equal(out, ref)
    assert torch.equal(grad, torch.stack(torch.autograd.grad(ref, parts, do), dim=2))
    q, k, v = (x.contiguous() for x in qkv.unbind(2))
    ref_o, ref_lse = fl.flash_forward_plain(q, k, v, True, 80 ** -0.5)
    bad, _ = fl.flash_forward(q, k, v, True, 80 ** -0.5, drop_last_tile=True)
    lim = cs.flash_f32_limit(ref_o, torch.ones_like(ref_o), 300 + 80)
    assert ((bad - ref_o).abs() / lim).max().item() > 1.0


# (T, d, causal, dtype): packed attention's generic route.
PACKED_GENERIC_SHAPES = [(t, d, c, dt) for t, d, dt in (
    (197, 64, torch.float32), (65, 16, torch.bfloat16), (257, 256, torch.bfloat16),
    (512, 32, torch.float32), (100, 128, torch.float32), (1, 64, torch.float32))
    for c in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,causal,dtype", PACKED_GENERIC_SHAPES,
                         ids=[f"t{t}-d{d}-{str(dt)[6:]}" + ("-causal" if c else "")
                              for t, d, c, dt in PACKED_GENERIC_SHAPES])
def test_cuda_packed_generic_matches_plain(t, d, causal, dtype):
    """``fused_qkv_forward`` / ``fused_qkv_backward`` on the generic
    route (B 2, H 128 // d or 1, at least 2) against the plain versions
    with chip_smoke's limits, the forward's LSE, the backward twice with
    equal bits, one call of each counted on the generic route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the generic kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

    b, h = 2, max(2, 128 // d)
    g = torch.Generator(device="cuda").manual_seed(t + d)
    qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g).to(dtype)
    do = torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype)
    sc = d ** -0.5
    before = dict(fp.generic_launches_by_op)
    out, lse = fp.fused_qkv_forward(qkv, h, causal, sc, return_lse=True)
    dqkv = fp.fused_qkv_backward(qkv, out, do, h, causal, sc, lse=lse)
    again = fp.fused_qkv_backward(qkv, out, do, h, causal, sc, lse=lse)
    torch.cuda.synchronize()
    assert {op: fp.generic_launches_by_op[op] - before[op] for op in before} == {
        "fused_qkv_fwd": 1, "fused_qkv_bwd": 2}
    assert torch.equal(dqkv, again)
    ref_o = fp.fused_qkv_attention_plain(qkv.float(), h, causal, sc).view(b, t, h, d)
    ref_d = fp.fused_qkv_attention_backward_plain(qkv.float(), out.float(), do.float(), h,
                                                  causal, sc).view(b, t, 3, h, d)
    q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    o4, do4 = out.view(b, t, h, d), do.view(b, t, h, d)
    ref_lse = fl.flash_forward_plain(q.float(), k.float(), v.float(), causal, sc)[1]
    assert ((lse - ref_lse).abs() <= cs.flash_lse_limit(q, k, ref_lse, sc)).all()
    limit, terms = cs._generic_limits(q, k, v, o4, do4, lse, fl.flash_delta(o4, do4), causal, sc)
    assert cs._ratio(o4, ref_o, limit(ref_o, terms[0]))[1] <= 1.0
    parts = dqkv.view(b, t, 3, h, d)
    for i, what in enumerate(("dQ", "dK", "dV")):
        ratio = cs._ratio(parts[:, :, i], ref_d[:, :, i], limit(ref_d[:, :, i], terms[i + 1]))[1]
        assert ratio <= 1.0, (what, ratio)


@pytest.mark.cuda
def test_cuda_packed_generic_autograd_and_auto():
    """f32 ViT attention: ``attn_impl="auto"`` resolves to the packed
    kernel on the card, whose Function runs the generic route (one
    forward, one backward call) and equals the two launchers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the generic kernels are CUDA C++ for sm_90a")
    from distributeddeeplearning_tpu_torch.models.vit import Attention
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(2, 197, 3 * 4 * 64, device="cuda", generator=g)
    do = torch.randn(2, 197, 4 * 64, device="cuda", generator=g)
    x = qkv.clone().requires_grad_()
    before = dict(fp.generic_launches_by_op)
    out = fp.fused_qkv_attention(x, 4)
    (grad,) = torch.autograd.grad(out, x, do)
    assert {op: fp.generic_launches_by_op[op] - before[op] for op in before} == {
        "fused_qkv_fwd": 1, "fused_qkv_bwd": 1}
    ref, lse = fp.fused_qkv_forward(qkv, 4, False, 64 ** -0.5, return_lse=True)
    assert torch.equal(out, ref)
    assert torch.equal(grad, fp.fused_qkv_backward(qkv, ref, do, 4, False, 64 ** -0.5, lse=lse))
    attn = Attention(256, 4, torch.float32, device="cuda", attn_impl="auto")
    before = fp.generic_launches_by_op["fused_qkv_fwd"]
    with torch.no_grad():
        attn(torch.randn(2, 197, 256, device="cuda", generator=g))
    assert fp.generic_launches_by_op["fused_qkv_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["matmul_stats", "bn_relu_matmul_stats"])
@pytest.mark.parametrize("m", [1, 127, 129, 3_213])
def test_cuda_f32_fused_block_sweep(op, m):
    """The f32 kernel (``csrc/fused_block_f32.cu``) at M rows over K ∈ {1,
    3, 64, 100} and N ∈ {1, 5, 64, 130} (shapes the bf16 kernel refuses)
    against the plain version: y within chip_smoke's ``fb_f32_y_limit``,
    the statistics within ``fb_stats_limit`` at ``f32_fb_depth``, a
    second call equal bit for bit, one launch a call on the f32 route.
    The prologue's shift is positive, so rows past M and K past its end
    would not be zero if they were read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(m)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for k in (1, 3, 64, 100):
        a = torch.randn(m, k, device="cuda", generator=g)
        mean = 0.1 * torch.randn(k, device="cuda", generator=g)
        var = 1.0 + torch.rand(k, device="cuda", generator=g)
        scale = 1.0 + 0.1 * torch.randn(k, device="cuda", generator=g)
        bias = 0.5 + 0.1 * torch.rand(k, device="cuda", generator=g)
        for n in (1, 5, 64, 130):
            w = torch.randn(n, k, device="cuda", generator=g) * k ** -0.5
            before = fb.launches_by_route["f32"]
            if op == "matmul_stats":
                outs = [fb.matmul_stats(a, w) for _ in range(2)]
                z = a
            else:
                outs = [fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w) for _ in range(2)]
                inv = torch.rsqrt(var + 1e-5) * scale
                z = torch.relu(a * inv + (bias - mean * inv))
            torch.cuda.synchronize()
            assert fb.launches_by_route["f32"] == before + 2
            (y, s, ss), (y2, s2, ss2) = outs
            assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2), (k, n)
            ref = fb.matmul_stats_plain(z, w)[0]
            lim = cs.fb_f32_y_limit(z.abs() @ w.abs().t(), k)
            assert ((y - ref).abs() <= lim).all(), (k, n)
            assert cs._fb_stats_ratio(s, ss, y, cs.f32_fb_depth(fb, m, n, sms)) <= 1.0, (k, n)


@pytest.mark.cuda
def test_cuda_f32_fused_block_autograd_and_control():
    """An f32 ``bn_relu_matmul_stats`` through autograd launches the f32
    kernel once and returns the gradients of the plain version's (the
    backward is torch in both); leaving each panel's last group out of
    the statistics misses their limit more than tenfold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ for sm_90a")
    import chip_smoke as cs

    g = torch.Generator(device="cuda").manual_seed(5)
    m, k, n = 12_544, 64, 256
    a = torch.randn(m, k, device="cuda", generator=g)
    stats = [a.mean(0), a.var(0, unbiased=False), 1.0 + 0.1 * torch.randn(k, device="cuda",
                                                                          generator=g),
             0.1 * torch.randn(k, device="cuda", generator=g)]
    w = torch.randn(n, k, device="cuda", generator=g) * 0.1
    leaves = [x.clone().requires_grad_() for x in [a, *stats, w]]
    before = fb.launches_by_route["f32"]
    y, s, ss = fb.bn_relu_matmul_stats(*leaves)
    grads = torch.autograd.grad((y.sum(), s.sum(), ss.sum()), leaves)
    assert fb.launches_by_route["f32"] == before + 1
    cpu = [x.detach().cpu().requires_grad_() for x in leaves]
    yc, sc_, ssc = fb.bn_relu_matmul_stats(*cpu)
    want = torch.autograd.grad((yc.sum(), sc_.sum(), ssc.sum()), cpu)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fb.f32_plan(m, n, sms)["groups"] >= 2
    yb, sb, ssb = fb.bn_relu_matmul_stats(a, *stats, w, drop_last_partial=True)
    assert cs._fb_stats_ratio(sb, ssb, yb, cs.f32_fb_depth(fb, m, n, sms)) > 10
