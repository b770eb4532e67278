#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--phases kernels,serve,train,lmtrain]

(all phases by default). Any failure raises and the script exits
non-zero.

1. Device: print ``nvidia-smi --query-gpu=name,power.limit`` and pin
   float32 matmuls and convolutions to full precision (no TF32).
2. Build every kernel from ``csrc/`` with ``nvcc`` for ``sm_90a``, one
   ``nvcc`` per source, all started together; print ptxas's registers,
   shared memory and spills.
3. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card (run in f32 on the same bf16 inputs), with
   CUDA-event times of the kernel, the plain version and one library
   call (a yardstick only) beside the byte/operation bound:
   decode attention at lm_base shapes; ``matmul_stats`` and
   ``bn_relu_matmul_stats`` at the four ResNet-50 training shapes, a
   ragged M and a prologue channel with σ ≪ |μ|; the three flash
   kernels (forward, dq, dk/dv) at lm_base training, its longest
   sequence, lm_large's head dim 96, ViT-B/16's ragged 197 tokens, a
   ragged cross-attention and a near one-hot softmax, with a negative
   control (a variant that drops each row's last key tile must fail).
4. ``serve``: full-width ``lm_base`` with seeded random weights behind
   ``Server.build`` (paged KV, fused kernel, 8 slots) answers 16
   requests. Checks: lengths and vocab range, the kernel ran exactly
   once per layer per forward (``launches == 12 × (prefills +
   decode_steps)``), each greedy stream equals the same request served
   alone, and the first request's first-token logits agree with a
   full-sequence plain re-forward; then a decode-tick profile.
5. ``train``: ResNet-50 (224 px, 1000 classes, batch 64, bf16) through
   the port's entry points on seeded synthetic data, ``fused=True``:
   3 warm-up and 20 timed steps, finite losses, and the fused kernels
   launched exactly 32 times per forward; a profile of 5 steady steps;
   the same protocol with ``fused=False`` (cuDNN 1x1 convs) as the
   yardstick of the whole step; and one fused against one unfused step
   from the same weights and batch, within stated limits.
6. ``lmtrain``: full-width ``lm_base`` (vocab 32,000, T = 1024, batch 8,
   bf16) through the same entry points on seeded synthetic tokens with
   ``attn_impl="pallas"``: 3 warm-up and 20 timed steps, finite losses,
   each flash kernel launched 12 times per forward (``flash_fwd``) or
   backward (``flash_bwd_dq``, ``flash_bwd_dkv``); a profile of 5 steady
   steps; the same protocol with ``attn_impl="xla"`` (plain masked
   softmax) as the yardstick of the whole step; and one pallas against
   one xla step from the same weights and batch, within stated limits.
7. The ``kernels`` JSON line (every kernel whose phases ran), then the
   contract's last line ``{"ok": true, "device": {...}}``.

Exits with code 2 and prints no result when CUDA is absent or the port
is not importable (the script on its own, outside the repository).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOP_S = 989e12  # dense bf16 tensor-core peak
N_TIMED = 25  # timed launches per measurement (median reported)


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over N_TIMED launches, each with a
    cold L2 (a 256 MB write between launches, outside the timed span),
    as a serving step finds the next layer's K/V."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(N_TIMED):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element limit on |kernel - f32 plain| for bf16 inputs.

    The kernel rounds three values to bf16 (unit roundoff 2**-8) that
    the f32 reference does not: the output, which is off by at most
    2**-8 of |ref|; and p and q·scale, whose roundings perturb each
    term of sum(p·v) by up to 2**-8 relative, with signs that cancel
    across keys, so their sum stays within a few 2**-8 of the output
    row's scale, max |ref| over the head dim: 2**-6 = 4 × 2**-8 of it.
    On the case shapes the kernel's roundings reach 0.2–0.3 of this
    limit (the plain version run in bf16 against itself in f32), while
    dropping each row's last 32-key chunk exceeds it 20-fold and a
    2**-5 scale error 1.6-fold."""
    row_max = ref.abs().amax(dim=-1, keepdim=True)
    return 2 ** -8 * ref.abs() + 2 ** -6 * row_max


def kernel_case(name, pd, q, k, v, q_pos, flush, *, table=None, bs=0):
    """Kernel vs plain (f32) on the same inputs; times and bound."""
    kw = dict(block_table=table, block_size=bs) if table is not None else {}
    out = pd.fused_decode_attention(q, k, v, q_pos, **kw)
    ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), q_pos, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (out.float() - ref).abs()
    tol = bf16_tolerance(ref)
    err = diff.max().item()
    tol_ratio = (diff / tol.clamp(min=torch.finfo(torch.float32).tiny)).max().item()
    if not (diff <= tol).all():
        raise AssertionError(
            f"{name}: |kernel - plain| exceeds the bf16 tolerance "
            f"{tol_ratio:.2f}x (max abs error {err})")

    b, t, h, d = q.shape
    # Bytes the function must move: q, the K/V rows its queries can
    # reach (up to each row's max position, as the kernel reads them),
    # q_pos, the table, the output. Operations: QK and PV over the keys
    # each query attends (k_idx <= q_pos).
    pos = q_pos.long().cpu().numpy()
    reach = (pos.max(axis=1) + 1).sum()
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem + 2 * reach * h * d * elem
              + q_pos.numel() * 4 + (table.numel() * 4 if table is not None else 0))
    flops = 4.0 * (pos + 1).sum() * h * d
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOP_S * 1e3

    # Library yardstick: SDPA over the pre-gathered [B, H, L, d] K/V
    # with the same boolean mask (gather and layout not timed).
    length = (table.shape[1] * bs) if table is not None else k.shape[1]
    if table is not None:
        k_all = k[table.long()].reshape(b, length, h, d)
        v_all = v[table.long()].reshape(b, length, h, d)
    else:
        k_all, v_all = k, v
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k_all, v_all))
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= q_pos.long()[:, :, None])[:, None]
    scale = d ** -0.5

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale)

    return {
        "case": name, "shape": {"B": b, "t": t, "H": h, "d": d, "L": length,
                                "paged": table is not None},
        "max_abs_err": err, "err_over_tol": tol_ratio,
        "ms": time_ms(lambda: pd.fused_decode_attention(q, k, v, q_pos, **kw), flush),
        "plain_ms": time_ms(
            lambda: pd.fused_decode_attention_plain(q, k, v, q_pos, **kw), flush),
        "library_ms": time_ms(sdpa, flush),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "bytes": int(nbytes), "flops": float(flops),
    }


def kernel_phase(pd, flush):
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1234)
    rng = np.random.RandomState(1234)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(bf)

    def pool_and_table(b, length, h, d, bs, live):
        """A shuffled pool: row r owns ceil(live[r]/bs) random physical
        blocks; the rest of its table points at trash block 0, which
        holds garbage."""
        mb = length // bs
        nb = b * mb + 1
        k, v = randn(nb, bs, h, d), randn(nb, bs, h, d)
        k[0] = 1e4
        v[0] = 1e4
        perm = rng.permutation(np.arange(1, nb))
        table = np.zeros((b, mb), np.int32)
        for r in range(b):
            n = -(-int(live[r]) // bs)
            table[r, :n] = perm[r * mb:r * mb + n]
        return k, v, torch.from_numpy(table).to(dev)

    cases = []
    b, h, d, length = 8, 12, 64, 2048
    pos = rng.randint(0, length, size=b)
    pos[0] = length - 1
    q_pos = torch.from_numpy(pos[:, None].astype(np.int32)).to(dev)
    cases.append(kernel_case("dense_decode", pd, randn(b, 1, h, d),
                             randn(b, length, h, d), randn(b, length, h, d),
                             q_pos, flush))
    k, v, table = pool_and_table(b, length, h, d, 16, pos + 1)
    cases.append(kernel_case("paged_decode", pd, randn(b, 1, h, d), k, v, q_pos,
                             flush, table=table, bs=16))
    # Full-depth paged decode: every row at the last position (the
    # bound the source note estimates).
    full = torch.full((b, 1), length - 1, dtype=torch.int32, device=dev)
    kf, vf, tf = pool_and_table(b, length, h, d, 16, np.full(b, length))
    cases.append(kernel_case("paged_decode_full", pd, randn(b, 1, h, d), kf, vf,
                             full, flush, table=tf, bs=16))
    start = 256
    wpos = torch.arange(start, start + 512, dtype=torch.int32, device=dev)[None]
    k1, v1, t1 = pool_and_table(1, length, h, d, 16, [start + 512])
    cases.append(kernel_case("paged_prefill_t512", pd, randn(1, 512, h, d), k1, v1,
                             wpos, flush, table=t1, bs=16))
    starts = rng.randint(0, length - 5, size=b)
    vpos = torch.from_numpy(
        (starts[:, None] + np.arange(5)).astype(np.int32)).to(dev)
    kv, vv, tv = pool_and_table(b, length, h, d, 16, starts + 5)
    cases.append(kernel_case("paged_verify_t5", pd, randn(b, 5, h, d), kv, vv,
                             vpos, flush, table=tv, bs=16))
    for dd in (32, 128):
        hh = 768 // dd
        kd, vd, td = pool_and_table(b, length, hh, dd, 16, pos + 1)
        cases.append(kernel_case(f"paged_decode_d{dd}", pd, randn(b, 1, hh, dd),
                                 kd, vd, q_pos, flush, table=td, bs=16))
    return cases


FB_ROW_TILE = 128  # csrc/fused_block.cu kBM: rows of y per block

# The training path's shapes (ResNet-50, batch 64, 224 px): (where, M, K, N).
FB_SHAPES = (
    ("stage1_conv3", 200_704, 64, 256),
    ("stage1_conv1", 200_704, 256, 64),
    ("stage3_conv1", 12_544, 1024, 256),
    ("stage4_conv3", 3_136, 512, 2048),
)


def fb_y_limit(ref: torch.Tensor) -> torch.Tensor:
    """Per-element limit on |kernel y - plain y| for bf16 inputs.

    The reference is the plain version's f32 product of the same bf16
    inputs; with the BN-ReLU prologue, its z is rounded to bf16 where
    the kernel (and the TPU kernel) rounds it. The kernel then differs
    by the rounding of y to bf16 (at most 2**-9·|ref| under
    round-to-nearest), by f32 accumulation in another order (K·2**-24
    of Σ|z_k·w_k|, far below), and, with the prologue, by its fused
    multiply-add, which can move a z that lies on a rounding boundary
    by one bf16 step: 2**-8 of one term of the row, below 2**-8 of the
    row's largest |y|. So the limit is 2**-8·|ref| + 2**-8·(the row's
    max |ref|). Written before the first run on the card: the plain
    version in bf16 against this reference on the CPU, at these
    shapes' K and N and the chip run's input distributions (2,048
    rows), reads 0.49 of the limit; dropping one 32-wide K slice
    exceeds it 80-fold or more, and skipping the ReLU 380-fold."""
    row_max = ref.abs().amax(dim=-1, keepdim=True)
    return 2 ** -8 * ref.abs() + 2 ** -8 * row_max


def fb_stats_limit(terms: torch.Tensor, m: int) -> torch.Tensor:
    """Per-column limit on |kernel Σ - f64 Σ of the kernel's own y|.

    The kernel sums each 128-row tile in f32, then the tiles' partials
    in f32 in a fixed order. Recursive f32 summation of n terms errs by
    at most (n-1)·2**-24·Σ|term|, so a BM-row tile sum followed by a
    sum over the row tiles stays within (BM + tiles)·2**-24·Σ|term|
    (|y| for Σy, y² for Σy²). At M = 200,704 that is about 1e-4 of
    Σ|term|; a dropped row tile moves Σy² by about 1/1568 = 6.4e-4 of
    it and fails. (M·2**-24, 0.012, would pass it.)"""
    tiles = -(-m // FB_ROW_TILE)
    return (FB_ROW_TILE + tiles) * 2 ** -24 * terms


def fb_case(name, fb, op, a, w, flush, *, bn=None):
    """One fused-block case: the kernel against its plain version run in
    f32 on the same bf16 inputs, the two limits above, and CUDA-event
    times of the kernel, the plain version (bf16 operands), the library
    yardstick (torch.matmul, then the two column sums; the elementwise
    prologue first for bn_relu) and the bound."""
    m, k = a.shape
    n = w.shape[0]
    if bn is None:
        def kern():
            return fb.matmul_stats(a, w)

        def plain():
            return fb.matmul_stats_plain(a, w)

        ref_y = fb.matmul_stats_plain(a.float(), w.float())[0]
        prologue_bytes = 0
    else:
        mean, var, scale, bias = bn

        def kern():
            return fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w)

        def plain():
            return fb.bn_relu_matmul_stats_plain(a, mean, var, scale, bias, w)

        inv = torch.rsqrt(var + 1e-5) * scale
        z = torch.relu(a.float() * inv + (bias - mean * inv)).to(a.dtype)
        ref_y = fb.matmul_stats_plain(z.float(), w.float())[0]
        del z
        prologue_bytes = 4 * 4 * k
    with torch.no_grad():
        y, s, ss = kern()
    torch.cuda.synchronize()
    if y.shape != (m, n) or y.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: y {tuple(y.shape)} {y.dtype}")
    yf = y.float()
    if not torch.isfinite(yf).all() or not (torch.isfinite(s).all() and torch.isfinite(ss).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (yf - ref_y).abs()
    lim = fb_y_limit(ref_y)
    err = diff.max().item()
    y_ratio = (diff / lim.clamp(min=torch.finfo(torch.float32).tiny)).max().item()
    if not (diff <= lim).all():
        raise AssertionError(f"{name}: |y - plain| exceeds its limit {y_ratio:.2f}x (max {err})")
    y64 = y.double()
    s_ratio = 0.0
    for got, exact, terms, what in (
        (s, y64.sum(0), y64.abs().sum(0), "sum"),
        (ss, (y64 * y64).sum(0), (y64 * y64).sum(0), "sumsq"),
    ):
        d = (got.double() - exact).abs()
        lim_s = fb_stats_limit(terms, m)
        ratio = (d / lim_s.clamp(min=1e-300)).max().item()
        s_ratio = max(s_ratio, ratio)
        if not (d <= lim_s).all():
            raise AssertionError(f"{name}: {what} exceeds its limit {ratio:.2f}x")
    del y64, yf, diff, lim

    # Library yardstick: one bf16 product, then the column sums (f32).
    if bn is None:
        def library():
            yl = torch.matmul(a, w.t())
            yf = yl.float()
            return yl, yf.sum(0), (yf * yf).sum(0)
    else:
        shift = bias - mean * inv

        def library():
            z = torch.relu(a.float() * inv + shift).to(a.dtype)
            yl = torch.matmul(z, w.t())
            yf = yl.float()
            return yl, yf.sum(0), (yf * yf).sum(0)

    nbytes = 2 * m * k + 2 * k * n + 2 * m * n + 8 * n + prologue_bytes
    flops = 2.0 * m * k * n
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOP_S * 1e3
    with torch.no_grad():
        out = {
            "case": name, "op": "matmul_stats" if bn is None else "bn_relu_matmul_stats",
            "shape": {"M": m, "K": k, "N": n},
            "max_abs_err": err, "y_err_over_limit": y_ratio,
            "stats_err_over_limit": s_ratio,
            "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": int(nbytes), "flops": flops,
        }
    return out


def fused_block_phase(fb, flush):
    """Both ops at the four training shapes, a ragged M for each (not a
    multiple of the 128-row tile), and a prologue channel with σ ≪ |μ|."""
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    def weights(n, k):  # He-scaled, as the model's 1x1 kernels
        return (randn(n, k) * (2.0 / n) ** 0.5).to(bf)

    def bn_inputs(m, k, wide=None):
        """Pre-norm rows with per-channel mean μ and sd σ, and the BN
        affine; channel ``wide`` gets σ = 0.01 at μ = 100."""
        mu = randn(k) * 0.5
        sd = randn(k).abs() * 0.5 + 0.5
        if wide is not None:
            mu[wide], sd[wide] = 100.0, 0.01
        a = (randn(m, k) * sd + mu).to(bf)
        af = a.float()
        mean = af.mean(0)
        var = (af * af).mean(0) - mean * mean
        return a, (mean, var, 1.0 + 0.1 * randn(k), 0.1 * randn(k))

    cases = []
    for where, m, k, n in FB_SHAPES:
        w = weights(n, k)
        a = randn(m, k).to(bf)
        cases.append(fb_case(f"matmul_stats/{where}", fb, "matmul_stats", a, w, flush))
        a, bn = bn_inputs(m, k)
        cases.append(fb_case(f"bn_relu_matmul_stats/{where}", fb, "bn_relu", a, w,
                             flush, bn=bn))
        del a, w, bn
    m, k, n = 3_136 + 77, 512, 128
    w = weights(n, k)
    cases.append(fb_case("matmul_stats/ragged_m", fb, "matmul_stats",
                         randn(m, k).to(bf), w, flush))
    a, bn = bn_inputs(m, k)
    cases.append(fb_case("bn_relu_matmul_stats/ragged_m", fb, "bn_relu", a, w, flush, bn=bn))
    a, bn = bn_inputs(12_544, 256, wide=3)
    cases.append(fb_case("bn_relu_matmul_stats/sigma_much_less_than_mu", fb, "bn_relu",
                         a, weights(256, 256), flush, bn=bn))
    return cases


# Flash-attention cases: (name, B, H, Tq, Tk, d, causal, q multiplier).
FLASH_CASES = (
    ("lm_base_train", 8, 12, 1024, 1024, 64, True, 1.0),
    ("lm_base_maxlen", 4, 12, 2048, 2048, 64, True, 1.0),
    ("lm_large_d96", 4, 16, 1024, 1024, 96, True, 1.0),
    ("vit_b16_ragged", 32, 12, 197, 197, 64, False, 1.0),
    ("cross_ragged", 2, 4, 100, 300, 64, False, 1.0),
    ("peaky", 8, 12, 1024, 1024, 64, True, 8.0),  # softmax near one-hot
)
FLASH_OPS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def flash_limit(ref: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    """Per-element limit on |kernel - f32 plain| for O, dQ, dK and dV,
    given bf16 inputs (for the backward: the same q, k, v, dO, LSE and
    Δ). ``terms`` is Σ|x_j·y_j| of the element's sum Σ x_j·y_j (O: Σ
    p̂·|v| over keys, p̂ = exp(s - lse); dQ: Σ|ds|·|k|; dK: Σ|ds|·|q|;
    dV: Σ p·|dO|).

    The kernel rounds one factor of every term to bf16 where the plain
    version (f32) does not: p before p·V and dV, ds before dQ and dK
    (the TPU kernels' rounding points). bf16's unit roundoff is 2**-8,
    so under round-to-nearest each factor moves by at most 2**-8 of
    itself and the sum by at most 2**-8·terms (signs cancel in practice;
    this is the worst case). It then rounds the result to bf16: at most
    2**-8·|ref|. Summing in another order in f32 adds at most
    n·2**-24·terms (n <= 2,048 terms: 2**-13·terms), and exp2f against
    exp a few f32 ulps of p. In all below 2**-8·|ref| + (2**-8 +
    2**-13)·terms, so the limit is 2**-7·(|ref| + terms), about twice
    the worst case. (ds itself can cancel to nothing where dp ≈ Δ, so
    dQ's and dK's terms also carry ds's f32 error: see
    :func:`flash_terms`.) Written before the first timed run on the card: the
    plain version in bf16 (p and O rounded; ds and p rounded before the
    gradient products) against itself in f32 on the CPU (B = 2, H = 4,
    T = 256, d = 64, causal) reads 0.36-0.39 of it for O, dQ, dK and dV,
    0.38-0.47 with q × 8. Dropping each 64-row tile's last key tile (the
    negative control) reads 87-177,000 times the O limit in the same
    rehearsal."""
    return 2 ** -7 * (ref.abs() + terms)


def flash_lse_limit(q, k, lse, scale: float) -> torch.Tensor:
    """Per-row limit on |kernel LSE - f32 plain LSE| ([B·H, Tq]).

    A score is scale·Σ_d q_i·k_i, d exact products of bf16 values (exact
    in f32) summed in another order: it moves by at most
    d·2**-24·scale·Σ|q_i·k_i| <= d·2**-24·scale·‖q‖·max‖k‖
    (Cauchy-Schwarz), and LSE by at most its row's largest score error.
    l sums at most Tk terms <= 1 in another order (relative error
    Tk·2**-24, which the log makes absolute); exp2f, logf and the final
    rounding add a few 2**-24 and 2**-24·|lse|. Limit:
    2**-24·(d·scale·‖q‖·max‖k‖ + Tk + 4 + |lse|)."""
    b, tq, h, d = q.shape
    qn = q.float().norm(dim=-1).permute(0, 2, 1).reshape(b * h, tq)
    kn = k.float().norm(dim=-1).amax(dim=1).reshape(b * h, 1)
    return 2 ** -24 * (d * scale * qn * kn + k.shape[1] + 4 + lse.abs())


def flash_terms(q, k, v, o, do, lse, delta, causal: bool, scale: float):
    """Σ|terms| of each element of (O, dQ, dK, dV), f32 (see
    :func:`flash_limit`). For dQ and dK each |ds| carries 2**8 times
    its f32 cancellation bound: ds = p·(dp − Δ)·scale, where dp (the
    kernel's MMA) and Δ (a torch sum) are d-term f32 sums taken in
    other orders than the plain version's, each off by at most
    d·2**-24·Σ|do_i·v_i| (Σ|do_i·o_i| for Δ); where dp ≈ Δ that is all
    of ds. Under the 2**-7 of the limit that allows twice the bound."""
    b, tq, h, d = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    keep = torch.ones(tq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        keep = keep.tril()
    p = torch.where(keep, torch.exp(s - lse.reshape(b, h, tq, 1)), 0.0)
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ads = (p * (dp - delta.reshape(b, h, tq, 1)) * scale).abs()
    del dp
    dof = do.float().abs()
    cancel = torch.einsum("bqhd,bkhd->bhqk", dof, v.float().abs())
    cancel += (dof * o.float().abs()).sum(-1).permute(0, 2, 1)[..., None]
    ads += p * (2 ** 8 * scale * d * 2 ** -24) * cancel
    del cancel
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs()),
            torch.einsum("bhqk,bkhd->bqhd", ads, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


def _ratio(got, ref, lim) -> Tuple[float, float]:
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff / lim.clamp(min=torch.finfo(torch.float32).tiny)).max().item()


def flash_bounds(b, h, tq, tk, d, causal):
    """Per kernel (bound_ms, bound_by, bytes, flops): bytes of each input
    read once and each output written once; 4/6/8 flops per (q, k) pair
    per head dim (QKᵀ and PV; + dOVᵀ and dS·K; + dSᵀQ and PᵀdO)."""
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    nq, nk = b * tq * h * d, b * tk * h * d
    rows = b * h * tq
    work = {
        "flash_fwd": (2 * (2 * nq + 2 * nk) + 4 * rows, 4.0 * b * h * pairs * d),
        "flash_bwd_dq": (2 * (3 * nq + 2 * nk) + 8 * rows, 6.0 * b * h * pairs * d),
        "flash_bwd_dkv": (2 * (2 * nq + 4 * nk) + 8 * rows, 8.0 * b * h * pairs * d),
    }
    out = {}
    for op, (nbytes, flops) in work.items():
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOP_S * 1e3
        out[op] = (max(tb, to), "bytes" if tb >= to else "operations", int(nbytes), flops)
    return out


def flash_case(fl, name, b, h, tq, tk, d, causal, q_mul, flush, g):
    """Forward and both backward kernels against their plain versions
    (f32, same bf16 inputs; the backward's plain version gets the
    kernel's own O and LSE, so it holds the backward kernels alone),
    the limits above, and CUDA-event times of each kernel, its plain
    version (bf16 operands, f32 inside), the library yardstick
    (scaled_dot_product_attention forward; its backward, timed as
    forward+backward minus forward, for both backward kernels) and the
    bound."""
    import torch.nn.functional as F

    bf = torch.bfloat16

    def randn(*shape, mul=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * mul).to(bf)

    q = randn(b, tq, h, d, mul=q_mul)
    k, v = randn(b, tk, h, d), randn(b, tk, h, d)
    do = randn(b, tq, h, d)
    sc = d ** -0.5
    out, lse = fl.flash_forward(q, k, v, causal, sc)
    delta = fl.flash_delta(out, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    torch.cuda.synchronize()
    for x, what in ((out, "O"), (lse, "LSE"), (dq, "dQ"), (dk, "dK"), (dv, "dV")):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    ref_o, ref_lse = fl.flash_forward_plain(qf, kf, vf, causal, sc)
    ref_dq = fl.flash_bwd_dq_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    ref_dk, ref_dv = fl.flash_bwd_dkv_plain(qf, kf, vf, dof, lse, delta, causal, sc)
    t_o, t_dq, t_dk, t_dv = flash_terms(q, k, v, out, do, lse, delta, causal, sc)
    errs = {}
    for what, got, ref, lim in (
        ("O", out, ref_o, flash_limit(ref_o, t_o)),
        ("LSE", lse, ref_lse, flash_lse_limit(q, k, ref_lse, sc)),
        ("dQ", dq, ref_dq, flash_limit(ref_dq, t_dq)),
        ("dK", dk, ref_dk, flash_limit(ref_dk, t_dk)),
        ("dV", dv, ref_dv, flash_limit(ref_dv, t_dv)),
    ):
        errs[what] = _ratio(got, ref, lim)
        if errs[what][1] > 1.0:
            raise AssertionError(
                f"{name}: |kernel {what} - plain| exceeds its limit "
                f"{errs[what][1]:.2f}x (max abs error {errs[what][0]})")
    control = None
    if name == "lm_base_train":
        # Negative control: the kernel with each row's last key tile
        # dropped must fail the O limit.
        bad, _ = fl.flash_forward(q, k, v, causal, sc, drop_last_tile=True)
        control = _ratio(bad, ref_o, flash_limit(ref_o, t_o))[1]
        if not control > 1.0:
            raise AssertionError(f"{name}: the dropped-tile variant passes ({control:.2f}x)")
        del bad
    del ref_o, ref_dq, ref_dk, ref_dv, t_o, t_dq, t_dk, t_dv

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=sc)

    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=sc)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    with torch.no_grad():
        times = {
            "flash_fwd": time_ms(lambda: fl.flash_forward(q, k, v, causal, sc), flush),
            "flash_bwd_dq": time_ms(
                lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc), flush),
            "flash_bwd_dkv": time_ms(
                lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc), flush),
        }
        plain = {
            "flash_fwd": time_ms(lambda: fl.flash_forward_plain(q, k, v, causal, sc), flush),
            "flash_bwd_dq": time_ms(
                lambda: fl.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sc), flush),
            "flash_bwd_dkv": time_ms(
                lambda: fl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sc), flush),
        }
        sdpa_fwd = time_ms(sdpa, flush)
    sdpa_fb = time_ms(sdpa_fwd_bwd, flush)
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_fb - sdpa_fwd,
               "flash_bwd_dkv": sdpa_fb - sdpa_fwd}
    bounds = flash_bounds(b, h, tq, tk, d, causal)
    return {
        "case": name, "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "d": d,
                                "causal": causal, "q_mul": q_mul},
        "max_abs_err": {w: e[0] for w, e in errs.items()},
        "err_over_limit": {w: e[1] for w, e in errs.items()},
        "negative_control_O_err_over_limit": control,
        "kernels": {op: {"ms": times[op], "plain_ms": plain[op], "library_ms": library[op],
                         "bound_ms": bounds[op][0], "bound_by": bounds[op][1],
                         "bytes": bounds[op][2], "flops": bounds[op][3]}
                    for op in FLASH_OPS},
        "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_fb,
    }


def flash_phase(fl, flush):
    g = torch.Generator(device="cuda").manual_seed(2468)
    cases = []
    for case in FLASH_CASES:
        cases.append(flash_case(fl, *case, flush, g))
        torch.cuda.empty_cache()
    return cases


def _flash_entry(op, cases, launches):
    main_case = next(c for c in cases if c["case"] == "lm_base_train")["kernels"][op]
    outputs = {"flash_fwd": ("O",), "flash_bwd_dq": ("dQ",), "flash_bwd_dkv": ("dK", "dV")}[op]
    return {
        "name": op, "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/flash.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/flash.py:"
                    + {"flash_fwd": "179", "flash_bwd_dq": "371", "flash_bwd_dkv": "394"}[op],
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"][w] for c in cases for w in outputs),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "timed_case": "lm_base_train",
    }


def serving_phase(pd, card):
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import Request, ServeConfig, Server

    vocab, new = 32_000, 64
    params = convert.init_params(
        "base", vocab, torch.Generator(device="cuda").manual_seed(0))
    model = get_model("lm_base", num_classes=vocab, device="cuda")
    cfg = ServeConfig.from_env({
        "SERVE_KV_LAYOUT": "paged", "SERVE_DECODE_KERNEL": "fused",
        "SERVE_SLOTS": "8",
    })
    t0 = time.perf_counter()
    server = Server.build(model, params, cfg)
    engine = server.engine
    engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    shared = rng.randint(0, vocab, size=256).astype(np.int32)
    reqs = []
    for i in range(16):
        if i in (1, 9):  # share a 256-token prefix (prefix-cache hit)
            tail = rng.randint(0, vocab, size=rng.randint(16, 512)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.randint(0, vocab, size=rng.randint(32, 1025)).astype(np.int32)
        sampled = i % 2 == 1
        reqs.append(Request(
            prompt=prompt, max_new_tokens=new,
            temperature=0.8 if sampled else 0.0,
            top_k=40 if sampled else None, rng=i,
        ))

    pd.launches = 0
    prefills0, steps0 = engine.prefill_execs, engine.decode_steps
    t0 = time.perf_counter()
    handles = [server.submit(r) for r in reqs]
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pd.launches
    prefills = engine.prefill_execs - prefills0
    steps = engine.decode_steps - steps0

    for i, h in enumerate(handles):
        toks = np.asarray(h.new_tokens)
        if h.status != "done" or toks.shape != (new,):
            raise AssertionError(f"request {i}: {h.status}, {toks.shape[0]} tokens")
        if toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"request {i}: token outside the vocab")
    depth = len(engine.model.blocks)
    if launches != depth * (prefills + steps) or launches == 0:
        raise AssertionError(
            f"launches {launches} != {depth} x ({prefills} prefills + "
            f"{steps} decode steps)")
    hits = engine.allocator.stats["prefix_hit_requests"]
    if hits < 1:
        raise AssertionError("the shared-prefix request did not hit the prefix cache")

    # Each greedy stream against the same request served alone. The
    # prefix cache is switched off for the solo runs: it now holds each
    # prompt's own blocks, and a hit would change the prefill's shapes,
    # which the batched run (no hit for these prompts) did not have.
    engine.prefix_cache = False
    first_logits = None
    for i, (r, h) in enumerate(zip(reqs, handles)):
        if r.temperature > 0:
            continue
        solo = Server(engine)
        hs = solo.submit(r)
        solo.drain()
        if i == 0:
            first_logits = engine.last_prefill["logits"].float()
        if hs.new_tokens != h.new_tokens:
            raise AssertionError(f"greedy request {i}: batched stream != alone")
    engine.prefix_cache = True

    # First-token logits vs a full-sequence plain re-forward (no cache,
    # plain attention) on the card.
    with torch.no_grad():
        prompt = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device="cuda")
        ref = engine.model(prompt[None])[0, -1].float()
    if not (torch.isfinite(first_logits).all() and first_logits.shape == (vocab,)):
        raise AssertionError("first-token logits not finite / wrong shape")
    logit_err = (first_logits - ref).abs().max().item()
    logit_scale = ref.abs().max().item()
    # bf16 stack, two attention lowerings (f32-score kernel vs
    # bf16-score plain softmax). The card read 0.026 against a largest
    # logit of 2.34 (0.011 of it): the limit is 2**-6 (0.0156) of it.
    if not logit_err <= 2 ** -6 * logit_scale:
        raise AssertionError(
            f"first-token logits differ from the re-forward by {logit_err} "
            f"(max |logit| {logit_scale})")

    ttft = sorted(h.ttft_s for h in handles)
    gen = sum(len(h.new_tokens) for h in handles)
    summary = {
        "tokens_per_s": gen / wall, "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)), "wall_s": wall,
        "requests": len(handles), "generated_tokens": gen, "prefills": prefills,
        "decode_steps": steps, "launches": launches, "prefix_hit_requests": hits,
        "first_logit_max_abs_err": logit_err, "first_logit_max_abs": logit_scale,
        "setup_s": setup_s, "card": card,
    }
    print("serve " + json.dumps(summary), flush=True)
    profile_decode(server, vocab, card)
    return launches


def profile_decode(server, vocab, card, ticks=8):
    """Where a decode tick's time goes: 8 slots at 512-token contexts,
    ``ticks`` steady decode ticks under ``torch.profiler``. Reports the
    tick's host wall, the device time summed over kernels (busy share =
    device / wall) and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from distributeddeeplearning_tpu_torch.serving import Request

    rng = np.random.RandomState(1)
    for _ in range(server.engine.num_slots):
        server.submit(Request(
            prompt=rng.randint(0, vocab, size=512).astype(np.int32),
            max_new_tokens=3 * ticks))
    for _ in range(server.engine.num_slots + 2):  # admit all, warm up
        server.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            server.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    server.drain()
    # Device-side kernel and copy events only: CPU ops carry the device
    # time of what they launched too, and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    print("profile " + json.dumps({
        "tick_wall_ms": wall_ms,
        "tick_device_ms": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "top_kernels_ms_per_tick": {
            e.key[:80]: e.device_time_total / 1e3 / ticks for e in top},
        "slots": server.engine.num_slots, "context": 512, "card": card,
    }), flush=True)


# Fused vs unfused bf16 step from the same weights and batch: the limits
# (derived in fused_vs_unfused_step's docstring).
AGREE_LOSS_REL = 1e-3
AGREE_UPDATE_REL = 0.35
AGREE_STATS_REL = 1e-2


def _train_setup(fused, *, depth=50, image_size=224, batch=64, num_classes=1000,
                 num_physical_batches=4, state_dict=None, device="cuda"):
    """The port's entry points as a user calls them: config, synthetic
    data, model, optimizer, seeded train state and step, on the card
    (``device="cpu"`` rehearses the flow at a small size)."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = TrainConfig(model=f"resnet{depth}", image_size=image_size,
                      batch_size_per_device=batch, num_classes=num_classes)
    ds = SyntheticImageDataset(global_batch_size=cfg.global_batch_size,
                               image_size=cfg.image_size, num_classes=cfg.num_classes,
                               num_physical_batches=num_physical_batches, seed=cfg.seed)
    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      fused=fused, device=device)
    tx, _ = create_optimizer(cfg, ds.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device, state_dict=state_dict)
    return cfg, ds, model, state, make_train_step(model, tx, cfg, device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def train_phase(fb, card, fused, warmup=3, timed=20, device="cuda", **size):
    """ResNet-50 at 224 px, batch 64, bf16, on the port's synthetic data:
    ``warmup`` steps, then ``timed`` steps closed by a host readback of
    the loss (the bench.py protocol). Checks finite losses and, fused,
    ``launches == 32 x forwards`` (16 of each op), unfused none."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device

    t0 = time.perf_counter()
    cfg, ds, model, state, step = _train_setup(fused, device=device, **size)
    batches = prefetch_to_device(ds.epoch(0), device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(warmup):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fb.launches = 0
    for k in fb.launches_by_op:
        fb.launches_by_op[k] = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    float(m["loss"])  # host readback closes the timed window
    wall = time.perf_counter() - t0
    launches, by_op = fb.launches, dict(fb.launches_by_op)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want = {k: (16 * timed if fused and device == "cuda" else 0) for k in by_op}
    if by_op != want or launches != sum(want.values()):
        raise AssertionError(f"fused={fused}: launches {by_op} over {timed} forwards, want {want}")
    line = {
        "path": "fused" if fused else "unfused (cuDNN 1x1 convs)",
        "model": cfg.model, "image_size": cfg.image_size, "batch": cfg.global_batch_size,
        "dtype": cfg.compute_dtype, "images_per_s": timed * cfg.global_batch_size / wall,
        "step_ms": wall / timed * 1e3, "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "launches_by_op": by_op, "forwards": timed,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                        else "not measured"), "setup_s": setup_s,
        "card": card,
    }
    print("train " + json.dumps(line), flush=True)
    return line, state, step, batches


def _family(key: str) -> str:
    """A device kernel's family, by name."""
    k = key.lower()
    for fam, marks in (("flash (ours)", ("flash_",)),
                       ("fused_block (ours)", ("matmul_stats", "reduce_partials")),
                       ("gemm (library)", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
                       ("conv (library)", ("conv", "cudnn")),
                       ("copy/set", ("memcpy", "memset")),
                       ("reduce/softmax/norm", ("reduce", "softmax", "norm", "logsumexp")),
                       ("elementwise", ("elementwise", "vectorized", "foreach"))):
        if any(m in k for m in marks):
            return fam
    return "other"


def profile_train(state, step, batches, card, step_ms, what, ours, steps=5):
    """Where a training step's time goes: ``steps`` steady steps under
    ``torch.profiler`` (device activity only, to keep the tracer off the
    host's critical path). Reports the step's wall under the profiler,
    the device time summed over kernels and copies, the busy share
    against that wall and against ``step_ms`` (the same step timed
    without the profiler), device ms by kernel family, the top kernels
    by device time and the port's own kernels (names containing one of
    ``ours``) with their share of the device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, next(batches))
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    batches.close()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in events) / 1e3 / steps
    top = sorted(events, key=lambda e: -e.device_time_total)[:10]
    mine = [e for e in events if any(o in e.key for o in ours)]
    families = {}
    for e in events:
        fam = _family(e.key)
        families[fam] = families.get(fam, 0.0) + e.device_time_total / 1e3 / steps
    mine_ms = sum(e.device_time_total for e in mine) / 1e3 / steps
    measured = device_ms > 0
    print("profile " + json.dumps({
        "what": what,
        "step_wall_ms_profiled": wall_ms, "step_wall_ms_unprofiled": step_ms,
        "step_device_ms": device_ms if measured else "not measured",
        "device_busy_share": device_ms / wall_ms if measured else "not measured",
        "device_busy_share_vs_unprofiled": device_ms / step_ms if measured else "not measured",
        "device_ms_per_step_by_family": families,
        "top_kernels_ms_per_step": {
            e.key[:90]: e.device_time_total / 1e3 / steps for e in top},
        "top_kernels_launches_per_step": {e.key[:90]: e.count / steps for e in top},
        "our_kernels": {
            e.key[:90]: {"ms_per_step": e.device_time_total / 1e3 / steps,
                         "launches_per_step": e.count / steps} for e in mine},
        "our_kernels_share_of_device": mine_ms / device_ms if measured else "not measured",
        "device_kernel_launches_per_step": sum(e.count for e in events) / steps,
        "card": card,
    }), flush=True)


def _agree_group(name: str) -> str:
    if ".Conv_0." in name or ".Conv_2." in name:
        return "fused_1x1_kernels"
    if name.endswith(("BatchNorm_0.weight", "BatchNorm_1.weight", "BatchNorm_2.weight",
                      "_bn.weight", "BatchNorm_0.bias", "BatchNorm_1.bias",
                      "BatchNorm_2.bias", "_bn.bias")):
        return "bn_scale_bias"
    return "other"


def fused_vs_unfused_step(depth=50, image_size=224, batch=64, num_classes=1000,
                          device="cuda"):
    """One fused and one unfused bf16 step from the same weights on the
    same batch, and whether they agree.

    Weights: the seeded init with every BN γ drawn as 1 ± 0.2 (sd), and
    0.1 ± 0.02 on each branch's last BN (0 at init, which would hide the
    branches from the forward). Limits:

    * loss: |L_fused - L_unfused| / |L_unfused| <= 1e-3;
    * updates, per group (the fused ops' 1x1 kernels; the BN scales and
      biases; the other parameters): ||Δ_fused - Δ_unfused|| /
      ||Δ_unfused|| <= 0.35;
    * running statistics: max |fused - unfused| / max |unfused| per
      buffer <= 1e-2.

    Derivation, written before the first run on the card: the two paths
    round to bf16 in other places (the kernel's accumulation order, the
    folded BN affine, z rounded after the ReLU), so they differ by bf16
    noise. A CPU rehearsal of this function (plain versions in bf16;
    resnet50, batch 16, at 112 and 224 px) read: loss 1.8e-4 and 8.1e-5,
    updates per group 0.09-0.15, running statistics 2.0e-3 and 1.2e-3;
    the unfused bf16 step against itself in f32 read loss 1.5e-4 and
    4.6e-5, updates 0.16-0.23, running statistics 4.4e-3 and 4.8e-3.
    The limits are 2.3-6x those readings. The same rehearsal with the
    backward's 2·y·dΣ² term dropped moves the 1x1 kernels' update gap
    to 0.71, and fails. Predicted on the card: loss ~1e-4, update gaps
    0.05-0.15, running statistics ~2e-3."""
    from distributeddeeplearning_tpu_torch.models import convert

    sd = convert.init_resnet_params(depth, num_classes,
                                    torch.Generator(device=device).manual_seed(42))
    g = torch.Generator(device=device).manual_seed(7)
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 1:
            base = 0.1 if bool((v == 0).all()) else 1.0
            sd[k] = base * (1.0 + 0.2 * torch.randn(v.shape, device=device, generator=g))
    out = {}
    for fused in (False, True):
        cfg, ds, model, state, step = _train_setup(
            fused, depth=depth, image_size=image_size, batch=batch,
            num_classes=num_classes, num_physical_batches=1, state_dict=sd, device=device)
        state, m = step(state, next(iter(ds.epoch(0))))
        out[fused] = (float(m["loss"]),
                      {k: v.detach().clone() for k, v in model.state_dict().items()})
        del cfg, ds, model, state, step
    (lu, pu), (lf, pf) = out[False], out[True]
    sums = {}
    stats = 0.0
    for k, ref in sd.items():
        if "running" in k:
            stats = max(stats, ((pf[k] - pu[k]).abs().max() / pu[k].abs().max()).item())
            continue
        du, df = pu[k].double() - ref.double(), pf[k].double() - ref.double()
        n, d = sums.get(_agree_group(k), (0.0, 0.0))
        sums[_agree_group(k)] = (n + (df - du).pow(2).sum().item(), d + du.pow(2).sum().item())
    gaps = {grp: (n / d) ** 0.5 for grp, (n, d) in sums.items()}
    res = {"loss_fused": lf, "loss_unfused": lu, "loss_rel": abs(lf - lu) / abs(lu),
           "update_rel_by_group": gaps, "running_stats_rel": stats,
           "limits": {"loss_rel": AGREE_LOSS_REL, "update_rel": AGREE_UPDATE_REL,
                      "running_stats_rel": AGREE_STATS_REL}}
    res["within_limits"] = (res["loss_rel"] <= AGREE_LOSS_REL
                            and max(gaps.values()) <= AGREE_UPDATE_REL
                            and stats <= AGREE_STATS_REL)
    return res


# The pallas and xla lm_base steps from the same weights and batch: the
# limits (derived in lm_pallas_vs_xla_step's docstring).
LM_AGREE_LOSS_REL = 1e-3
LM_AGREE_UPDATE_REL = 0.1
LM_AGREE_LOGITS_REL = 2 ** -4


def _lm_setup(attn_impl, *, variant="base", batch=8, seq=1024, vocab=32_000,
              num_physical_batches=4, state_dict=None, device="cuda"):
    """The port's entry points as a user calls them for LM training
    (bench.py's LM protocol): config, synthetic tokens, model, optimizer,
    seeded train state and step, on the card (``device="cpu"``
    rehearses the flow at a small size)."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = TrainConfig(model=f"lm_{variant}", batch_size_per_device=batch, num_classes=vocab,
                      attn_impl=attn_impl)
    ds = SyntheticTokenDataset(global_batch_size=cfg.global_batch_size, seq_len=seq,
                               vocab_size=vocab, num_physical_batches=num_physical_batches,
                               seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=seq, device=device)
    tx, _ = create_optimizer(cfg, ds.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device, state_dict=state_dict)
    return cfg, ds, model, state, make_train_step(model, tx, cfg, device=device)


def lm_train_phase(fl, card, attn_impl, warmup=3, timed=20, device="cuda", **size):
    """lm_base (vocab 32,000, T = 1024, batch 8, bf16) on the port's
    synthetic tokens: ``warmup`` steps, then ``timed`` steps closed by a
    host readback of the loss. Checks finite losses and, with
    ``attn_impl="pallas"`` on the card, each flash kernel launched once
    per layer per forward (``flash_fwd``) or backward (``flash_bwd_dq``,
    ``flash_bwd_dkv``); with ``"xla"`` none."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device

    t0 = time.perf_counter()
    cfg, ds, model, state, step = _lm_setup(attn_impl, device=device, **size)
    batches = prefetch_to_device(ds.epoch(0), device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(warmup):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fl.launches = 0
    for k in fl.launches_by_op:
        fl.launches_by_op[k] = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    float(m["loss"])  # host readback closes the timed window
    wall = time.perf_counter() - t0
    launches, by_op = fl.launches, dict(fl.launches_by_op)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    on_card = attn_impl == "pallas" and device == "cuda"
    want = {k: (model.depth * timed if on_card else 0) for k in by_op}
    if by_op != want or launches != sum(want.values()):
        raise AssertionError(
            f"{attn_impl}: launches {by_op} over {timed} forwards and backwards, want {want}")
    tokens = timed * cfg.global_batch_size * ds.seq_len
    line = {
        "path": attn_impl, "model": cfg.model, "seq_len": ds.seq_len,
        "batch": cfg.global_batch_size, "vocab": cfg.num_classes, "dtype": cfg.compute_dtype,
        "tokens_per_s": tokens / wall, "step_ms": wall / timed * 1e3,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches, "launches_by_op": by_op, "forwards": timed, "backwards": timed,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                        else "not measured"), "setup_s": setup_s, "card": card,
    }
    print("lmtrain " + json.dumps(line), flush=True)
    return line, state, step, batches


def _lm_group(name: str) -> str:
    if ".attn." in name:
        return "attention"
    if ".mlp." in name:
        return "mlp"
    if "embed" in name:
        return "embeddings"
    return "layernorm"


def lm_pallas_vs_xla_step(variant="base", batch=8, seq=1024, vocab=32_000, device="cuda"):
    """One ``pallas`` and one ``xla`` bf16 step from the same seeded
    weights on the same batch, and whether they agree. Limits:

    * loss: |L_pallas - L_xla| / |L_xla| <= 1e-3;
    * updates, per group (attention, MLP, embeddings, LayerNorm):
      ||Δ_pallas - Δ_xla|| / ||Δ_xla|| <= 0.1;
    * logits at the initial weights: max |pallas - xla| <= 2**-4 of the
      largest |logit|.

    Derivation, written before the first run on the card: the two
    attentions round at other places. The xla path rounds its scores to
    bf16 before the softmax (ops/attention.py, as the JAX package's
    ``_xla_attention``), an error of up to 2**-9 of each score, which
    moves each probability by about that times the score's size, and it
    rounds p·V's weights; the kernels keep f32 scores and round p (and
    ds in the backward) to bf16. So the two steps differ by bf16 noise
    in every attention output, carried through 12 layers. A CPU
    rehearsal of this function (plain versions in bf16; lm_small at
    batch 2 and lm_base at batch 1, T = 256) read: loss 3.1e-5 and
    4.2e-6, update gaps 0.008-0.014 per group, logits 0.011 and 0.012 of
    the largest; the limits are 5-30x those, for the longer sequences
    and larger batch on the card. The same rehearsal with the causal
    mask dropped from the pallas path read update gaps 1.0-1.5 and
    logits 1.3 (and fails); an O 1 % too large read 0.02-0.03, which
    only the kernel cases catch. Predicted on the card: loss ~1e-4,
    update gaps 0.01-0.05, logits 0.01-0.03."""
    from distributeddeeplearning_tpu_torch.models import convert

    sd = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(42),
                             seq)
    out = {}
    for impl in ("xla", "pallas"):
        cfg, ds, model, state, step = _lm_setup(
            impl, variant=variant, batch=batch, seq=seq, vocab=vocab,
            num_physical_batches=1, state_dict=sd, device=device)
        tokens, labels = next(iter(ds.epoch(0)))
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens).to(device)).float()
        state, m = step(state, (tokens, labels))
        out[impl] = (float(m["loss"]), logits,
                     {k: v.detach().clone() for k, v in model.state_dict().items()})
        del cfg, ds, model, state, step
    (lx, gx, px), (lp, gp, pp) = out["xla"], out["pallas"]
    logits_rel = ((gp - gx).abs().max() / gx.abs().max()).item()
    sums = {}
    for k, ref in sd.items():
        dx, dp = px[k].double() - ref.double(), pp[k].double() - ref.double()
        n, d = sums.get(_lm_group(k), (0.0, 0.0))
        sums[_lm_group(k)] = (n + (dp - dx).pow(2).sum().item(), d + dx.pow(2).sum().item())
    gaps = {grp: (n / d) ** 0.5 for grp, (n, d) in sums.items()}
    res = {"loss_pallas": lp, "loss_xla": lx, "loss_rel": abs(lp - lx) / abs(lx),
           "update_rel_by_group": gaps, "logits_rel": logits_rel,
           "limits": {"loss_rel": LM_AGREE_LOSS_REL, "update_rel": LM_AGREE_UPDATE_REL,
                      "logits_rel": LM_AGREE_LOGITS_REL}}
    res["within_limits"] = (res["loss_rel"] <= LM_AGREE_LOSS_REL
                            and max(gaps.values()) <= LM_AGREE_UPDATE_REL
                            and logits_rel <= LM_AGREE_LOGITS_REL)
    return res


def _fb_entry(name, cases, timed_case, launches):
    main_case = next(c for c in cases if c["case"] == timed_case)
    return {
        "name": name, "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/fused_block.cu",
        "replaces": ("distributeddeeplearning_tpu/ops/pallas/fused_block.py:160"
                     if name == "matmul_stats"
                     else "distributeddeeplearning_tpu/ops/pallas/fused_block.py:194"),
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["op"] == name),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "timed_case": timed_case,
    }


PHASES = ("kernels", "serve", "train", "lmtrain")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all)" % ",".join(PHASES))
    phases = set(ap.parse_args(argv).phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        _die("CUDA is not available; this smoke runs the port on an NVIDIA GPU")
    try:
        from distributeddeeplearning_tpu_torch.ops import _build
        from distributeddeeplearning_tpu_torch.ops import flash as fl
        from distributeddeeplearning_tpu_torch.ops import fused_block as fb
        from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    except ImportError as e:
        _die(f"the port is not importable from here ({e}); run from the repo root")

    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    # One nvcc per source, all started together.
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    names = ("paged_decode", "fused_block", "flash")
    with ThreadPoolExecutor(len(names)) as pool:
        secs = list(pool.map(timed_build, names))
    for name, sec in zip(names, secs):
        print(f"build {name} {sec:.1f}s", flush=True)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas {name}:", line.strip(), flush=True)

    entries = []
    pd_cases = fb_cases = flash_cases = None
    if "kernels" in phases:
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        pd_cases = kernel_phase(pd, flush)
        fb_cases = fused_block_phase(fb, flush)
        flash_cases = flash_phase(fl, flush)
        for c in pd_cases + fb_cases + flash_cases:
            print("case " + json.dumps(c), flush=True)
        del flush
        torch.cuda.empty_cache()

    if "serve" in phases:
        launches = serving_phase(pd, card)
        if pd_cases is not None:
            main_case = next(c for c in pd_cases if c["case"] == "paged_decode_full")
            entries.append({
                "name": "paged_decode_attention",
                "route": "cuda",
                "source": "distributeddeeplearning_tpu_torch/csrc/paged_decode.cu",
                "replaces": "distributeddeeplearning_tpu/ops/pallas/paged_decode.py:175",
                "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in pd_cases),
                "ms": main_case["ms"],
                "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": main_case["library_ms"],
                "timed_case": main_case["case"],
            })

    if "train" in phases:
        fused_line, state, step, batches = train_phase(fb, card, fused=True)
        by_op = fused_line["launches_by_op"]
        profile_train(state, step, batches, card, fused_line["step_ms"],
                      "fused resnet50 train step, batch 64, 224 px, bf16",
                      ("matmul_stats_kernel", "reduce_partials"))
        del state, step, batches
        torch.cuda.empty_cache()
        _, state, step, batches = train_phase(fb, card, fused=False)
        batches.close()
        del state, step, batches
        torch.cuda.empty_cache()
        agree = fused_vs_unfused_step()
        print("agree " + json.dumps(dict(agree, card=card)), flush=True)
        if not agree["within_limits"]:
            raise AssertionError(f"fused and unfused steps disagree: {agree}")
        if fb_cases is not None:
            entries += [
                _fb_entry("matmul_stats", fb_cases, "matmul_stats/stage1_conv1",
                          by_op["matmul_stats"]),
                _fb_entry("bn_relu_matmul_stats", fb_cases,
                          "bn_relu_matmul_stats/stage1_conv3", by_op["bn_relu_matmul_stats"]),
            ]

    if "lmtrain" in phases:
        line, state, step, batches = lm_train_phase(fl, card, "pallas")
        by_op = line["launches_by_op"]
        profile_train(state, step, batches, card, line["step_ms"],
                      "lm_base train step (attn_impl=pallas), batch 8, T 1024, bf16",
                      ("flash_",))
        del state, step, batches
        torch.cuda.empty_cache()
        _, state, step, batches = lm_train_phase(fl, card, "xla")
        batches.close()
        del state, step, batches
        torch.cuda.empty_cache()
        agree = lm_pallas_vs_xla_step()
        print("lmagree " + json.dumps(dict(agree, card=card)), flush=True)
        if not agree["within_limits"]:
            raise AssertionError(f"pallas and xla LM steps disagree: {agree}")
        if flash_cases is not None:
            entries += [_flash_entry(op, flash_cases, by_op[op]) for op in FLASH_OPS]

    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
