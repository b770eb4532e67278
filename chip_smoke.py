#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--phases kernels,serve,servequant,servespec,train,lmtrain,
                                    vittrain,effnettrain,fit,warmup,frontends,launch,
                                    trace,bench]

(all phases by default). Any failure raises and the script exits
non-zero.

1. Device: print ``nvidia-smi --query-gpu=name,power.limit`` and pin
   float32 matmuls and convolutions to full precision (no TF32).
2. Build every kernel from ``csrc/`` with ``nvcc`` for ``sm_90a``, one
   ``nvcc`` per source, all started together; print ptxas's registers,
   spills and any wgmma serialization it reports.
3. ``kernels``: each hand-written kernel against its plain PyTorch
   version on the card (run in f32 on the same bf16 inputs), with
   CUDA-event times (device time: the device spins before each timed
   span, so the host's side of a call never sets it) of the kernel, the
   plain version and one library call (a yardstick only) beside the
   byte/operation bound:
   decode attention at lm_base shapes, on bf16 caches and on int8 and
   fp8 codes with f32 scales (``QUANT_CASES``; the yardstick gathers the
   K/V out of the page pool, dequantizes the codes, and runs SDPA, all
   timed together; bf16 cases also time SDPA on K/V gathered before the
   timer, ``sdpa_pregathered_ms``), each case run twice with equal bits
   and its line naming the split plan, with two negative controls (the
   kernel dropping each tile's last key split, and the int8 kernel given
   scales of 1, must fail);
   ``matmul_stats`` and
   ``bn_relu_matmul_stats`` at the four ResNet-50 training shapes (the
   plain version timed), at the rest of the forward's twelve shapes
   (``FB_MODEL_SHAPES``; the ``fbforward`` line sums them by launches),
   at stage 1's two timed shapes under ``ACCUM_STEPS=2``
   (``FB_MICRO_SHAPES``, M = 100,352),
   a ragged M and a prologue channel with σ ≪ |μ|, each run twice with
   equal bits, its line naming the plan, timed beside the library
   yardstick and a bare ``torch.matmul``, with a negative control (each
   panel's last block left out of the statistics must fail); the three flash
   kernels (forward, dq, dk/dv) at lm_base training, its longest
   sequence, lm_large's head dim 96, ViT-B/16's ragged 197 tokens, a
   ragged cross-attention and a near one-hot softmax, the backward run
   twice with equal bits, and a negative control (a variant that drops
   each row's last key tile must fail);
   the two packed-QKV attention kernels (forward, packed backward) at
   ViT-B/16 and ViT-L/16 training, T = 512, head dim 128 and a ragged
   causal case, with the backward's statistics scratch held to its plain
   version, the backward run twice with equal bits, and the same
   negative control at ViT-B/16; and the
   dW+db kernel at the four ViT-B/16 Dense shapes, the f32 head and a
   ragged N, each run twice with equal bits, its line naming the plan
   (path, tile, row splits), timed beside two yardsticks (cuBLAS with a
   bf16 dW plus a column sum of an f32 copy; cuBLAS with an f32 dW plus
   an f32-accumulated column sum), with a negative control (each tile's
   last row split left out of the merge must fail); the depthwise
   stencil (forward, dgrad) and wgrad, each run twice with equal bits,
   each line naming the stencil path and the wgrad's plan, at
   EfficientNet-B4's ten stride-1 layer shapes (batch 64, bf16; all on
   the TMA row ring), an f32 case, ragged H, W and C, k = 7 and k = 9,
   against the plain version (f32; the wgrad f64) and cuDNN's grouped
   conv, with negative controls (the dgrad with unflipped taps must
   fail, on the staged-tile kernel and on the TMA stencil; the wgrad
   with its last partial row left out of the sum must fail).
4. ``serve``: full-width ``lm_base`` with seeded random weights behind
   ``Server.build`` (paged KV, fused kernel, 8 slots) answers 16
   requests. Checks: lengths and vocab range, the kernel ran exactly
   once per layer per forward (``launches == 12 × (prefills +
   decode_steps)``), each greedy stream equals the same request served
   alone, and the first request's first-token logits agree with a
   full-sequence plain re-forward; then a decode-tick profile.
5. ``servequant``: the same mix with int8 KV and weights, then fp8
   (``SERVE_KV_DTYPE``/``SERVE_WEIGHT_DTYPE``): the same checks, the
   kernel counted under the storage dtype, the pools in that dtype (no
   fall-back), ``byte_accounting()`` (12 x 2 x 12 x (64 + 4) KV bytes a
   token; parameter bytes = the resident tensors', under 0.55 of bf16's),
   the first-token logit gap to the bf16 model; a decode-tick profile.
6. ``servespec``: the mix with ``SERVE_SPEC_K=4``, int8 self-draft and
   prompt-lookup drafts: the kernel launched 12 times per prefill and
   per verify tick, drafts accepted, greedy streams equal to the
   non-speculative engine's but at a bf16 near-tie (printed).
7. ``train``: ResNet-50 (224 px, 1000 classes, batch 64, bf16) through
   the port's entry points on seeded synthetic data, ``fused=True``:
   3 warm-up and 20 timed steps, finite losses, and the fused kernels
   launched exactly 32 times per forward; a profile of 5 steady steps;
   the same protocol with ``fused=False`` (cuDNN 1x1 convs) as the
   yardstick of the whole step; and one fused against one unfused step
   from the same weights and batch, within stated limits.
8. ``lmtrain``: full-width ``lm_base`` (vocab 32,000, T = 1024, batch 8,
   bf16) through the same entry points on seeded synthetic tokens with
   ``attn_impl="pallas"``: 3 warm-up and 20 timed steps, finite losses,
   each flash kernel launched 12 times per forward (``flash_fwd``) or
   backward (``flash_bwd_dq``, ``flash_bwd_dkv``); a profile of 5 steady
   steps; the same protocol, and profile, with ``attn_impl="xla"`` (plain
   masked softmax) as the yardstick of the whole step; and one pallas against
   one xla step from the same weights and batch, within stated limits.
9. ``vittrain``: ViT-B/16 (224 px, 1000 classes, batch 64, bf16)
   through the same entry points on seeded synthetic images with
   ``attn_impl="fused"`` and fused dense grads: 3 warm-up and 20 timed
   steps, finite losses, exactly 12 launches per step of each packed
   attention kernel and 49 of ``matmul_dw_db``; a profile of 5 steady
   steps; the same protocol, and profile, with ``attn_impl="xla"`` and
   stock Dense layers as the yardstick; one flagged against one yardstick step from
   the same weights and batch, within stated limits; and ``"auto"``
   taking the packed kernel once per layer of a forward on the card.
10. ``effnettrain``: EfficientNet-B4 (380 px, 1000 classes, batch 64,
   bf16, drop-path and head dropout on) through the same entry points
   on seeded synthetic images: 3 warm-up and 20 timed steps, finite
   losses, no depthwise kernel launched by the model (its depthwise
   convs are cuDNN's, as JAX's are XLA's); a profile of 5 steady steps;
   then the hook pass: one training forward and backward with the 28
   stride-1 depthwise layers handed to the kernels by forward hooks
   (28 launches of each of forward, dgrad and wgrad), each layer's
   kernels held to the plain version and to cuDNN on its real x, weight
   and dy, and timed beside cuDNN (the ``effnetdw`` line). Batch 64 is
   halved, and the cut printed, if it does not fit the card.
11. ``fit``: the training loop (``training.loop.fit``) at full width:
   fused ResNet-50 for an epoch as a user runs it (32 launches a
   forward, one host sync, no synchronizing CUDA call in the steady
   steps but the epoch readback, under
   ``torch.cuda.set_sync_debug_mode("warn")``), then against the bare
   step in turns (bare, fit, fit, bare); 2 epochs with
   ``CHECKPOINT_EVERY_STEPS=5`` under ``hostsync.track()`` (one sync an
   epoch and one a save); a resume from the step-15 checkpoint held to
   the uninterrupted run (``FIT_RESUME_*``); an epoch with
   ``ACCUM_STEPS=2`` (64 launches a dispatch) and one fused against one
   unfused accumulated step; ``lm_base`` pallas through ``fit`` (12
   launches a pass of each flash kernel). See :func:`fit_phase`.
12. ``warmup``: ``AOT_WARMUP`` (the step captured as CUDA graphs)
   through ``fit``: fused ResNet-50 and ``lm_base`` ``pallas``, eager,
   graphed, graphed, eager, each run's step medians, busy share, peak
   memory, ``compile_sec`` and ``graphs_captured``, graphed against
   eager bit for bit, the kernels counted under replay by the
   profiler's names; EfficientNet-B0 with dropout and ViT-B/16 flagged
   at 64 px, and ``GRAD_ACCUM_STEPS=2``, graphed against eager. See
   :func:`warmup_phase`.
13. ``frontends``: the four example modules
   (``distributeddeeplearning_tpu_torch.examples``) as subprocesses,
   one in a one-rank NCCL world from ``DDL_*``. See
   :func:`frontends_phase`.
14. ``launch``: the process tier: four launchers of ``python -m
   distributeddeeplearning_tpu_torch.launch -n 1 --max-restarts 1`` at
   once, each child training fused ResNet-50 (224 px, batch 64) through
   ``fit`` in a one-rank NCCL world: (a) ``FAULT_PLAN=kill:step=8``,
   restarted with resume (mid-epoch 2, library cache hits), held to
   (the fourth) an uninterrupted launch within ``FIT_RESUME_*``; (b) a
   hang ended by the watchdog (125) once, then completed; (c) a NaN
   loss, 121 and no restart; 32 fused-block launches a step in every
   attempt. See :func:`launch_phase`. (``--launch-child`` runs one rank
   of a drill.)
15. ``trace``: ``TRACE_EVERY_N_EPOCHS=1`` on a graphed two-epoch ``fit``:
   a Chrome trace an epoch naming the fused kernels. See
   :func:`trace_phase`.
16. ``bench``: ``python -m distributeddeeplearning_tpu_torch.bench`` in a
   subprocess, three runs of the canonical ResNet-50 protocol and three
   of ``BENCH_MODEL=lm_base``, each timing the captured step: each
   record printed (``platform`` cuda, ``graphs_captured`` 1,
   ``host_sync_count`` 1; ``lm_base``'s runs share a fresh
   ``COMPILATION_CACHE_DIR``: misses in the first, hits after), and a
   ``benchwall`` line with each protocol's median, min and max.
17. The ``kernels`` JSON line (every kernel whose phases ran; rows 1–5
   also with their launches a step under graph replay), then the
   contract's last line ``{"ok": true, "device": {...}}``.

Exits with code 2 and prints no result when CUDA is absent or the port
is not importable (the script on its own, outside the repository).
"""

from __future__ import annotations

import gc
import json
import os
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
SPIN_CYCLES = 4_000_000  # device spin before each timed span: about 2 ms


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
    as a serving step finds the next layer's K/V. Before each span the
    device spins for SPIN_CYCLES (``torch.cuda._sleep``), so the host has
    queued ``fn``'s work before the device reaches the first event: the
    span is device time even where the host's side of ``fn`` (autograd,
    a wrapper's checks) takes longer than the device's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(N_TIMED):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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


def kernel_case(name, pd, q, k, v, q_pos, flush, *, table=None, bs=0, k_scale=None,
                v_scale=None):
    """Kernel vs plain (f32) on the same inputs; times and bound. With
    ``k_scale``/``v_scale``, ``k`` and ``v`` hold int8 or fp8 codes and
    both sides read the same codes and scales (the plain version then
    dequantizes to f32, the kernel to bf16 as the TPU kernel does)."""
    kw = dict(block_table=table, block_size=bs) if table is not None else {}
    quantized = k_scale is not None
    if quantized:
        kw.update(k_scale=k_scale, v_scale=v_scale)
    out = pd.fused_decode_attention(q, k, v, q_pos, **kw)
    again = pd.fused_decode_attention(q, k, v, q_pos, **kw)
    if quantized:
        ref = pd.fused_decode_attention_plain(q.float(), k, v, q_pos, **kw)
    else:
        ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), q_pos, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: a second call did not repeat the first bit for bit")
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
    # reach (up to each row's max position, as the kernel reads them;
    # codes and their f32 scales when quantized), q_pos, the table, the
    # output. Operations: QK and PV over the keys each query attends
    # (k_idx <= q_pos).
    pos = q_pos.long().cpu().numpy()
    reach = (pos.max(axis=1) + 1).sum()
    elem = q.element_size()
    row_bytes = h * d * k.element_size() + (h * 4 if quantized else 0)
    nbytes = (2 * q.numel() * elem + 2 * reach * row_bytes
              + q_pos.numel() * 4 + (table.numel() * 4 if table is not None else 0))
    flops = 4.0 * (pos + 1).sum() * h * d
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_BF16_FLOP_S * 1e3

    # Library yardstick: SDPA over the [B, H, L, d] K/V with the same
    # boolean mask, timed with the gather out of the page pool that the
    # kernel does in its own body (quantized: gather the codes and
    # scales, dequantize to bf16, then SDPA). In the compute dtype the
    # case also keeps SDPA alone on K/V gathered before the timer
    # (`sdpa_pregathered_ms`, the yardstick before the gather was timed).
    length = (table.shape[1] * bs) if table is not None else k.shape[1]
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= q_pos.long()[:, :, None])[:, None]
    scale = d ** -0.5
    qh = q.transpose(1, 2).contiguous()

    def logical(x):
        if table is None:
            return x
        return x[table.long()].reshape(b, length, h, x.shape[-1])

    def sdpa(kh, vh):
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, scale=scale)

    if quantized:
        def library():
            kd = (logical(k).float() * logical(k_scale)).to(q.dtype)
            vd = (logical(v).float() * logical(v_scale)).to(q.dtype)
            return sdpa(kd.transpose(1, 2), vd.transpose(1, 2))
    else:
        kh, vh = (logical(x).transpose(1, 2).contiguous() for x in (k, v))

        def pregathered():
            return sdpa(kh, vh)

        def library():
            return sdpa(logical(k).transpose(1, 2), logical(v).transpose(1, 2))

    plan = pd.plan_for(q, k, table, bs, quantized)
    return {
        "case": name, "shape": {"B": b, "t": t, "H": h, "d": d, "L": length,
                                "paged": table is not None,
                                "store": str(k.dtype).replace("torch.", "")},
        "plan": {key: plan[key] for key in ("splits", "chunks_per_split", "groups", "blocks",
                                            "stages", "combine")},
        "max_abs_err": err, "err_over_tol": tol_ratio, "repeats_bitwise": True,
        "ms": time_ms(lambda: pd.fused_decode_attention(q, k, v, q_pos, **kw), flush),
        "plain_ms": time_ms(
            lambda: pd.fused_decode_attention_plain(q, k, v, q_pos, **kw), flush),
        "library_ms": time_ms(library, flush),
        "sdpa_pregathered_ms": None if quantized else time_ms(pregathered, flush),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "bytes": int(nbytes), "flops": float(flops),
    }


# Quantized decode-attention cases: (storage, case names). The bf16
# cases' shapes, on pools quantized by ops/quant.quantize_kv.
QUANT_CASES = {
    "int8": ("dense_decode", "paged_decode", "paged_decode_full", "paged_verify_t5",
             "paged_decode_d32", "paged_decode_d128"),
    "fp8": ("dense_decode", "paged_decode", "paged_decode_full", "paged_verify_t5"),
}


def kernel_phase(pd, flush):
    """The decode kernel's cases: in bf16 at lm_base shapes (dense and
    paged decode, the full-depth paged decode, a 512-row paged prefill,
    the speculative verify window, head dims 32 and 128), then the
    quantized storage's (``QUANT_CASES``), each run twice with equal
    bits, and two negative controls that must miss the tolerance by a
    large factor: the bf16 full-depth decode with each tile's last live
    key split dropped (every split is combined), and the int8 kernel
    given scales of 1 in place of the true ones (the scales are read)."""
    from distributeddeeplearning_tpu_torch.ops import quant

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

    b, h, d, length = 8, 12, 64, 2048
    pos = rng.randint(0, length, size=b)
    pos[0] = length - 1
    q_pos = torch.from_numpy(pos[:, None].astype(np.int32)).to(dev)
    full = torch.full((b, 1), length - 1, dtype=torch.int32, device=dev)
    start = 256
    # name -> (q, k, v, q_pos, table, block size)
    inputs = {"dense_decode": (randn(b, 1, h, d), randn(b, length, h, d),
                               randn(b, length, h, d), q_pos, None, 0)}
    k, v, table = pool_and_table(b, length, h, d, 16, pos + 1)
    inputs["paged_decode"] = (randn(b, 1, h, d), k, v, q_pos, table, 16)
    # Full-depth paged decode: every row at the last position (the
    # bound the source note estimates).
    kf, vf, tf = pool_and_table(b, length, h, d, 16, np.full(b, length))
    inputs["paged_decode_full"] = (randn(b, 1, h, d), kf, vf, full, tf, 16)
    wpos = torch.arange(start, start + 512, dtype=torch.int32, device=dev)[None]
    k1, v1, t1 = pool_and_table(1, length, h, d, 16, [start + 512])
    inputs["paged_prefill_t512"] = (randn(1, 512, h, d), k1, v1, wpos, t1, 16)
    starts = rng.randint(0, length - 5, size=b)
    vpos = torch.from_numpy((starts[:, None] + np.arange(5)).astype(np.int32)).to(dev)
    kv, vv, tv = pool_and_table(b, length, h, d, 16, starts + 5)
    inputs["paged_verify_t5"] = (randn(b, 5, h, d), kv, vv, vpos, tv, 16)
    for dd in (32, 128):
        hh = 768 // dd
        kd, vd, td = pool_and_table(b, length, hh, dd, 16, pos + 1)
        inputs[f"paged_decode_d{dd}"] = (randn(b, 1, hh, dd), kd, vd, q_pos, td, 16)

    cases = []
    for name, (q, k, v, qp, table, bs) in inputs.items():
        cases.append(kernel_case(name, pd, q, k, v, qp, flush, table=table, bs=bs))
    for kind, names in QUANT_CASES.items():
        trash = 127.0 if kind == "int8" else 448.0  # large, finite codes
        for name in names:
            q, k, v, qp, table, bs = inputs[name]
            (kq, ks), (vq, vs) = quant.quantize_kv(k, kind), quant.quantize_kv(v, kind)
            if table is not None:
                for c, sc in ((kq, ks), (vq, vs)):
                    c[0] = trash
                    sc[0] = 1e2
            cases.append(kernel_case(f"{name}_{kind}", pd, q, kq, vq, qp, flush, table=table,
                                     bs=bs, k_scale=ks, v_scale=vs))

    # Negative controls: the bf16 full-depth decode with each tile's last
    # live split dropped, and the int8 paged decode with scales of 1.
    q, k, v, qp, table, bs = inputs["paged_decode_full"]
    kw = dict(block_table=table, block_size=bs)
    ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), qp, **kw)
    wrong = pd.fused_decode_attention(q, k, v, qp, drop_last_split=True, **kw)
    factor = ((wrong.float() - ref).abs() / bf16_tolerance(ref)).max().item()
    print("control " + json.dumps({"case": "paged_decode_full_drop_last_split",
                                   "err_over_tol": factor}), flush=True)
    if not factor > 10:
        raise AssertionError(
            f"the decode kernel without each tile's last split stays within {factor:.2f}x "
            f"of the tolerance: the splits are not all combined")
    q, k, v, qp, table, bs = inputs["paged_decode"]
    (kq, ks), (vq, vs) = quant.quantize_kv(k, "int8"), quant.quantize_kv(v, "int8")
    kw = dict(block_table=table, block_size=bs)
    ones = torch.ones_like(ks)
    ref = pd.fused_decode_attention_plain(q.float(), kq, vq, qp, k_scale=ks, v_scale=vs, **kw)
    wrong = pd.fused_decode_attention(q, kq, vq, qp, k_scale=ones, v_scale=ones, **kw)
    factor = ((wrong.float() - ref).abs() / bf16_tolerance(ref)).max().item()
    print("control " + json.dumps({"case": "paged_decode_int8_scales_of_1",
                                   "err_over_tol": factor}), flush=True)
    if not factor > 10:
        raise AssertionError(
            f"the int8 kernel with scales of 1 stays within {factor:.2f}x of the "
            f"tolerance: the scales are not read")
    return cases


# The training path's shapes (ResNet-50, batch 64, 224 px): (where, M, K, N),
# both ops at each, with the plain version timed.
FB_SHAPES = (
    ("stage1_conv3", 200_704, 64, 256),
    ("stage1_conv1", 200_704, 256, 64),
    ("stage3_conv1", 12_544, 1024, 256),
    ("stage4_conv3", 3_136, 512, 2048),
)
# Every call of the ResNet-50 forward at batch 64 and 224 px (the port's
# fused bottlenecks, models/resnet.py): (op, M, K, N, launches a forward).
FB_MODEL_SHAPES = (
    ("matmul_stats", 200_704, 64, 64, 1),
    ("matmul_stats", 200_704, 256, 64, 2),
    ("matmul_stats", 200_704, 256, 128, 1),
    ("matmul_stats", 50_176, 512, 128, 3),
    ("matmul_stats", 50_176, 512, 256, 1),
    ("matmul_stats", 12_544, 1024, 256, 5),
    ("matmul_stats", 12_544, 1024, 512, 1),
    ("matmul_stats", 3_136, 2048, 512, 2),
    ("bn_relu_matmul_stats", 200_704, 64, 256, 3),
    ("bn_relu_matmul_stats", 50_176, 128, 512, 4),
    ("bn_relu_matmul_stats", 12_544, 256, 1024, 6),
    ("bn_relu_matmul_stats", 3_136, 512, 2048, 3),
)
# Stage 1's two timed shapes at the microbatch of ACCUM_STEPS=2 (batch 64
# in two halves of 32: M = 100,352), where each microbatch's BN
# statistics come from the kernels: (where, op, M, K, N).
FB_MICRO_SHAPES = (
    ("micro_stage1_conv1", "matmul_stats", 100_352, 256, 64),
    ("micro_stage1_conv3", "bn_relu_matmul_stats", 100_352, 64, 256),
)
# The dropped-partial control's shape: 33 blocks a panel in 6 merge groups.
FB_CONTROL = ("bn_relu_matmul_stats", 12_544, 256, 1024)


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


def fb_stats_limit(terms: torch.Tensor, depth: int) -> torch.Tensor:
    """Per-column limit on |kernel Σ - f64 Σ of the kernel's own y|.

    The kernel's order (``csrc/fused_block_plan.h``): a thread sums its
    column over its warp's 16 rows of each of its block's items in turn
    (at most items_per_block · 16 terms), the block sums its 8 warps'
    rows in order, the last block of a merge group the group's block rows
    (group), the last group of the panel the group rows (groups), all in
    f32. Recursive f32 summation of n terms errs by at most
    (n-1)·2**-24·Σ|term|, and a chain of such sums by at most the sum of
    its levels' n, so the error stays within depth·2**-24·Σ|term| (|y|
    for Σy, y² for Σy²), depth the plan's ``stat_depth``: 223 at
    stage1_conv3 (12 items, 8 warps, 12 + 11), about 1.3e-5 of Σ|term|.
    Leaving one of 33 blocks out (the dropped-partial control at
    ``FB_CONTROL``, depth 3 · 16 + 8 + 6 + 6 = 68) moves Σy² by about
    1/33 of it, some 7,000 times the limit."""
    return depth * 2 ** -24 * terms


def _fb_stats_ratio(s, ss, y, depth):
    """The larger of |Σ - exact| / limit for Σy and Σy² (exact: f64 sums
    of the kernel's own y)."""
    y64 = y.double()
    ratio = 0.0
    for got, exact, terms in ((s, y64.sum(0), y64.abs().sum(0)),
                              (ss, (y64 * y64).sum(0), (y64 * y64).sum(0))):
        d = (got.double() - exact).abs()
        ratio = max(ratio, (d / fb_stats_limit(terms, depth).clamp(min=1e-300)).max().item())
    return ratio


def fb_case(name, fb, op, a, w, flush, *, bn=None, plain=True):
    """One fused-block case: the kernel against its plain version run in
    f32 on the same bf16 inputs, the two limits above, run twice for
    equal bits, its plan, and CUDA-event times of the kernel, the plain
    version (bf16 operands; with ``plain``), the library yardstick
    (torch.matmul, then the two column sums; the elementwise prologue
    first for bn_relu), one bare ``torch.matmul`` of the same operands
    (for bn_relu of a z computed before the timer: a floor for any
    library route) and the bound."""
    m, k = a.shape
    n = w.shape[0]
    if bn is None:
        def kern():
            return fb.matmul_stats(a, w)

        def plain_fn():
            return fb.matmul_stats_plain(a, w)

        z = a
        prologue_bytes = 0
    else:
        mean, var, scale, bias = bn

        def kern():
            return fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w)

        def plain_fn():
            return fb.bn_relu_matmul_stats_plain(a, mean, var, scale, bias, w)

        inv = torch.rsqrt(var + 1e-5) * scale
        z = torch.relu(a.float() * inv + (bias - mean * inv)).to(a.dtype)
        prologue_bytes = 4 * 4 * k
    ref_y = fb.matmul_stats_plain(z.float(), w.float())[0]
    with torch.no_grad():
        y, s, ss = kern()
        y2, s2, ss2 = kern()
    torch.cuda.synchronize()
    if not (torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2)):
        raise AssertionError(f"{name}: a second launch did not repeat the first bit for bit")
    del y2, s2, ss2
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
    del yf, diff, lim, ref_y
    plan = fb.plan_for(a, w, bn is not None)
    s_ratio = _fb_stats_ratio(s, ss, y, plan["stat_depth"])
    if s_ratio > 1.0:
        raise AssertionError(f"{name}: the statistics exceed their limit {s_ratio:.2f}x")

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
            "shape": {"M": m, "K": k, "N": n}, "plan": plan, "repeats_bitwise": True,
            "max_abs_err": err, "y_err_over_limit": y_ratio,
            "stats_err_over_limit": s_ratio,
            "ms": time_ms(kern, flush),
            "plain_ms": time_ms(plain_fn, flush) if plain else "not timed",
            "library_ms": time_ms(library, flush),
            "gemm_ms": time_ms(lambda: torch.matmul(z, w.t()), flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": int(nbytes), "flops": flops,
        }
    return out


def fused_block_phase(fb, flush):
    """Both ops at the four training shapes (the plain version timed), at
    every other shape of ``FB_MODEL_SHAPES``, at stage 1's microbatch
    shapes under ``ACCUM_STEPS=2`` (``FB_MICRO_SHAPES``), a ragged M for each (not a
    multiple of the 128-row tile), and a prologue channel with σ ≪ |μ|;
    the ``fbforward`` line (the model shapes' launch-weighted sums, and
    the unweighted sum of the ``FB_SHAPES`` cases, comparable with an
    older smoke's); then
    a negative control: the kernel leaving each panel's last block out of
    its statistics (``drop_last_partial=True``) at ``FB_CONTROL`` must
    exceed ``fb_stats_limit`` more than tenfold."""
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

    def case(name, op, m, k, n, plain):
        w = weights(n, k)
        if op == "matmul_stats":
            return fb_case(name, fb, op, randn(m, k).to(bf), w, flush, plain=plain)
        a, bn = bn_inputs(m, k)
        return fb_case(name, fb, op, a, w, flush, bn=bn, plain=plain)

    cases = []
    for where, m, k, n in FB_SHAPES:
        for op in ("matmul_stats", "bn_relu_matmul_stats"):
            cases.append(case(f"{op}/{where}", op, m, k, n, True))
            torch.cuda.empty_cache()
    model = []
    for op, m, k, n, per_forward in FB_MODEL_SHAPES:
        c = next((c for c in cases if c["op"] == op and c["shape"] == {"M": m, "K": k, "N": n}),
                 None)
        if c is None:
            c = case(f"{op}/model_{m}x{k}x{n}", op, m, k, n, False)
            cases.append(c)
            torch.cuda.empty_cache()
        model.append((c, per_forward))
    for where, op, m, k, n in FB_MICRO_SHAPES:
        cases.append(case(f"{op}/{where}", op, m, k, n, False))
        torch.cuda.empty_cache()
    m, k, n = 3_136 + 77, 512, 128
    cases.append(case("matmul_stats/ragged_m", "matmul_stats", m, k, n, True))
    cases.append(case("bn_relu_matmul_stats/ragged_m", "bn_relu_matmul_stats", m, k, n, True))
    a, bn = bn_inputs(12_544, 256, wide=3)
    cases.append(fb_case("bn_relu_matmul_stats/sigma_much_less_than_mu", fb, "bn_relu",
                         a, weights(256, 256), flush, bn=bn))
    del a, bn

    sums = {key: sum(c[key] * per for c, per in model)
            for key in ("ms", "library_ms", "gemm_ms", "bound_ms")}
    print("fbforward " + json.dumps({
        "launches": sum(per for _, per in model), "sums_ms": sums,
        # the eight FB_SHAPES cases, which an older smoke times too
        "fb_shapes_ms": sum(c["ms"] for c in cases[:2 * len(FB_SHAPES)]),
        "kernel_over_bound": sums["ms"] / sums["bound_ms"],
        "per_shape": [{"case": c["case"], "launches": per, "ms": c["ms"],
                       "library_ms": c["library_ms"], "gemm_ms": c["gemm_ms"],
                       "bound_ms": c["bound_ms"], "panel": c["plan"]["panel"],
                       "grid": c["plan"]["grid"]} for c, per in model]}), flush=True)

    op, m, k, n = FB_CONTROL
    a, (mean, var, scale, bias) = bn_inputs(m, k)
    w = weights(n, k)
    y, s, ss = fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w, drop_last_partial=True)
    plan = fb.plan_for(a, w, True)
    factor = _fb_stats_ratio(s, ss, y, plan["stat_depth"])
    print("control " + json.dumps({"case": "fused_block_drop_last_partial", "plan": plan,
                                   "err_over_limit": factor}), flush=True)
    if not factor > 10:
        raise AssertionError(f"the fused block without each panel's last block stays within "
                             f"{factor:.2f}x of its limit: a partial is not merged")
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
    the limits above, the backward run twice with equal bits, and
    CUDA-event times of each kernel, its plain
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
    again = (fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc),
             *fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc))
    torch.cuda.synchronize()
    for x, what in ((out, "O"), (lse, "LSE"), (dq, "dQ"), (dk, "dK"), (dv, "dV")):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
        raise AssertionError(f"{name}: the backward does not repeat bit for bit")
    del again
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
        "backward_repeats_bitwise": True,
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


VOCAB, NEW_TOKENS = 32_000, 64
SERVE_ENV = {"SERVE_KV_LAYOUT": "paged", "SERVE_DECODE_KERNEL": "fused", "SERVE_SLOTS": "8"}


def _lm_params(variant="base", device="cuda"):
    """Seeded random lm weights (f32, on ``device``; full-width lm_base
    on the card)."""
    from distributeddeeplearning_tpu_torch.models import convert

    return convert.init_params(variant, VOCAB, torch.Generator(device=device).manual_seed(0))


def _request_mix():
    """16 requests: prompts of 32–1024 tokens, 64 new tokens each, the
    odd ones sampled (temperature 0.8, top-k 40), two sharing a
    256-token prefix (a prefix-cache hit)."""
    from distributeddeeplearning_tpu_torch.serving import Request

    rng = np.random.RandomState(0)
    shared = rng.randint(0, VOCAB, size=256).astype(np.int32)
    reqs = []
    for i in range(16):
        if i in (1, 9):
            tail = rng.randint(0, VOCAB, size=rng.randint(16, 512)).astype(np.int32)
            prompt = np.concatenate([shared, tail])
        else:
            prompt = rng.randint(0, VOCAB, size=rng.randint(32, 1025)).astype(np.int32)
        sampled = i % 2 == 1
        reqs.append(Request(
            prompt=prompt, max_new_tokens=NEW_TOKENS,
            temperature=0.8 if sampled else 0.0,
            top_k=40 if sampled else None, rng=i,
        ))
    return reqs


def _reset_launches(pd):
    pd.launches = 0
    for key in pd.launches_by_store:
        pd.launches_by_store[key] = 0


def serve_mix(pd, card, env, label, params, solo=True, variant="base", device="cuda"):
    """Full-width lm_base behind ``Server.build`` (the ``SERVE_*`` env
    ``env``) answers the 16-request mix. Checks: lengths and vocab
    range; the kernel ran exactly once per layer per forward (``launches
    == 12 × (prefills + decode ticks)``, a speculative engine's verify
    ticks counted as decode ticks); the prefix-cache hit. With ``solo``,
    also: each greedy stream equals the same request served alone, and
    the first request's first-token logits agree with a full-sequence
    plain re-forward of the same model (through a quantized dense cache
    when the KV tier is quantized). Prints the ``label`` line and
    returns ``(summary, server, requests, handles)``. ``variant`` and
    ``device`` let the CPU rehearse it (``variant="tiny", device="cpu"``)."""
    from distributeddeeplearning_tpu_torch import inference
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.serving import ServeConfig, Server

    model = get_model(f"lm_{variant}", num_classes=VOCAB, device=device)
    t0 = time.perf_counter()
    server = Server.build(model, params, ServeConfig.from_env(env), device=device)
    engine = server.engine
    engine.warmup()
    _sync(device)
    setup_s = time.perf_counter() - t0

    reqs = _request_mix()
    _reset_launches(pd)
    prefills0, steps0 = engine.prefill_execs, engine.decode_steps
    t0 = time.perf_counter()
    handles = [server.submit(r) for r in reqs]
    server.drain()
    _sync(device)
    wall = time.perf_counter() - t0
    launches, by_store = pd.launches, dict(pd.launches_by_store)
    prefills = engine.prefill_execs - prefills0
    steps = engine.decode_steps - steps0

    for i, h in enumerate(handles):
        toks = np.asarray(h.new_tokens)
        if h.status != "done" or toks.shape != (NEW_TOKENS,):
            raise AssertionError(f"{label} request {i}: {h.status}, {toks.shape[0]} tokens")
        if toks.min() < 0 or toks.max() >= VOCAB:
            raise AssertionError(f"{label} request {i}: token outside the vocab")
    depth = len(engine.model.blocks)
    want = depth * (prefills + steps) if device == "cuda" else 0  # the CPU runs plain
    if launches != want or (device == "cuda" and launches == 0):
        raise AssertionError(
            f"{label}: launches {launches} != {depth} x ({prefills} prefills + "
            f"{steps} decode ticks)")
    hits = engine.allocator.stats["prefix_hit_requests"]
    if hits < 1:
        raise AssertionError(f"{label}: the shared-prefix request did not hit the prefix cache")

    ttft = sorted(h.ttft_s for h in handles)
    gen = sum(len(h.new_tokens) for h in handles)
    summary = {
        "tokens_per_s": gen / wall, "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)), "wall_s": wall,
        "requests": len(handles), "generated_tokens": gen, "prefills": prefills,
        "decode_steps": steps, "launches": launches,
        "launches_by_store": {k: n for k, n in by_store.items() if n},
        "prefix_hit_requests": hits, "kv_dtype": engine.kv_dtype,
        "weight_dtype": engine.weight_dtype, "setup_s": setup_s, "card": card,
    }
    if solo:
        # Each greedy stream against the same request served alone. The
        # prefix cache is switched off for the solo runs: it now holds
        # each prompt's own blocks, and a hit would change the prefill's
        # shapes, which the batched run (no hit for these prompts) did
        # not have.
        engine.prefix_cache = False
        first_logits = None
        for i, (r, h) in enumerate(zip(reqs, handles)):
            if r.temperature > 0:
                continue
            alone = Server(engine)
            hs = alone.submit(r)
            alone.drain()
            if i == 0:
                first_logits = engine.last_prefill["logits"].float()
            if hs.new_tokens != h.new_tokens:
                raise AssertionError(f"{label} greedy request {i}: batched stream != alone")
        engine.prefix_cache = True

        # First-token logits vs a full-sequence plain re-forward on the
        # card (no cache, plain attention; through a dense cache of the
        # engine's KV tier when it is quantized, so both read the same
        # quantized K/V).
        with torch.no_grad():
            prompt = torch.as_tensor(reqs[0].prompt, dtype=torch.long, device=device)
            cache = None
            if engine.kv_dtype != "bf16":
                cache = inference.dense_cache(engine.model, 1, prompt.shape[0], device,
                                              engine.kv_dtype)
            ref = engine.model(prompt[None], cache)[0, -1].float()
        if not (torch.isfinite(first_logits).all() and first_logits.shape == (VOCAB,)):
            raise AssertionError(f"{label}: first-token logits not finite / wrong shape")
        logit_err = (first_logits - ref).abs().max().item()
        logit_scale = ref.abs().max().item()
        # bf16 stack, two attention lowerings (f32-score kernel vs
        # bf16-score plain softmax). The card read 0.026 against a
        # largest logit of 2.34 (0.011 of it): the limit is 2**-6
        # (0.0156) of it.
        if not logit_err <= 2 ** -6 * logit_scale:
            raise AssertionError(
                f"{label}: first-token logits differ from the re-forward by {logit_err} "
                f"(max |logit| {logit_scale})")
        summary.update(first_logit_max_abs_err=logit_err, first_logit_max_abs=logit_scale)
        summary["first_logits"] = first_logits
    return summary, server, reqs, handles


def _print_line(label, summary):
    print(label + " " + json.dumps({k: v for k, v in summary.items()
                                    if not isinstance(v, torch.Tensor)}), flush=True)


def serving_phase(pd, card):
    summary, server, _, _ = serve_mix(pd, card, SERVE_ENV, "serve", _lm_params())
    _print_line("serve", summary)
    profile_decode(server, VOCAB, card)
    return summary["launches"]


def quant_serving_phase(pd, card, variant="base", device="cuda"):
    """``servequant``: the ``serve`` mix with ``SERVE_KV_DTYPE`` and
    ``SERVE_WEIGHT_DTYPE`` int8, then fp8 (``serve_mix``'s checks, the
    kernel counted under the storage dtype), the pools really in that
    dtype, ``byte_accounting()`` (``kv_bytes_per_token`` = 12 x 2 x 12 x
    (64 + 4) bytes; ``param_bytes`` = the resident tensors' bytes and
    below 0.55 of the bf16 engine's), the first-token logit gap to the
    bf16 model, and a decode-tick profile (on the card). Returns the
    launches by storage dtype."""
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.serving import SlotEngine

    params = _lm_params(variant, device)
    bf16 = SlotEngine(get_model(f"lm_{variant}", num_classes=VOCAB, device=device), params,
                      device=device)
    bf16_param_bytes = bf16.byte_accounting()["param_bytes"]
    m = bf16.model  # layers x (K, V) x heads x (a code per dim + an f32 scale)
    kv_bytes_per_token = len(m.blocks) * 2 * m.num_heads * (m.head_dim * 1 + 4)
    prompt0 = torch.as_tensor(_request_mix()[0].prompt, dtype=torch.long, device=device)
    with torch.no_grad():
        bf16_logits = bf16.model(prompt0[None])[0, -1].float()
    del bf16
    torch.cuda.empty_cache()
    launches = {}
    for kind in ("int8", "fp8"):
        env = dict(SERVE_ENV, SERVE_KV_DTYPE=kind, SERVE_WEIGHT_DTYPE=kind)
        label = f"servequant_{kind}"
        summary, server, _, _ = serve_mix(pd, card, env, label, params, variant=variant,
                                          device=device)
        engine = server.engine
        n = summary["launches_by_store"].get(kind, 0)
        if n != summary["launches"]:
            raise AssertionError(f"{label}: {n} of {summary['launches']} launches on {kind} pools")
        store = torch.int8 if kind == "int8" else torch.float8_e4m3fn
        if engine.kv_dtype != kind or any(x.dtype != store for x in engine._stores[0]):
            raise AssertionError(f"{label}: the pools are not {store} (fell back?)")
        acct = engine.byte_accounting()
        resident = float(sum(t.numel() * t.element_size()
                             for t in engine.model.state_dict().values()))
        if acct["kv_bytes_per_token"] != kv_bytes_per_token:
            raise AssertionError(f"{label}: kv_bytes_per_token {acct['kv_bytes_per_token']}")
        if acct["param_bytes"] != resident or not acct["param_bytes"] < 0.55 * bf16_param_bytes:
            raise AssertionError(
                f"{label}: param_bytes {acct['param_bytes']} (resident {resident}, "
                f"bf16 engine {bf16_param_bytes})")
        gap = (summary.pop("first_logits") - bf16_logits).abs().max().item()
        summary.update(
            kv_bytes_per_token=acct["kv_bytes_per_token"], param_bytes=acct["param_bytes"],
            bf16_param_bytes=bf16_param_bytes,
            param_bytes_over_bf16=acct["param_bytes"] / bf16_param_bytes,
            first_logit_gap_to_bf16=gap,
            first_logit_gap_to_bf16_over_max=gap / bf16_logits.abs().max().item())
        _print_line(label, summary)
        if device == "cuda":
            profile_decode(server, VOCAB, card)
        launches[kind] = n
        del server, engine
        torch.cuda.empty_cache()
    return launches


def spec_serving_phase(pd, card, k=4, variant="base", device="cuda"):
    """``servespec``: the ``serve`` mix with ``SERVE_SPEC_K=4``, drafts
    from the int8 self-draft (its own dense bf16 pool, the plain decode
    path) and from prompt lookup, both paged through the fused kernel.
    Checks: the kernel launched 12 times per prefill and per verify tick
    (the draft launches none), at least one draft accepted, and every
    greedy stream equal to the non-speculative engine's. A flip is
    allowed only at a bf16 near-tie of the plain run: the top-2 gap of
    its logits there at most 2**-7 of the largest logit (a [S, K+1]
    forward may take other cuBLAS algorithms than a [S, 1] one)."""
    params = _lm_params(variant, device)
    base, base_server, reqs, base_handles = serve_mix(
        pd, card, SERVE_ENV, "servespec_base", params, solo=False, variant=variant,
        device=device)
    base_model = base_server.engine.model
    for draft in ("int8", "ngram"):
        label = f"servespec_{draft}"
        env = dict(SERVE_ENV, SERVE_SPEC_K=str(k), SERVE_SPEC_DRAFT=draft)
        summary, server, _, handles = serve_mix(pd, card, env, label, params, solo=False,
                                                variant=variant, device=device)
        st = server.engine.spec_stats
        if st["tokens_accepted"] < 1:
            raise AssertionError(f"{label}: no draft was accepted")
        flips = []
        for i, (r, h, hb) in enumerate(zip(reqs, handles, base_handles)):
            if r.temperature > 0 or h.new_tokens == hb.new_tokens:
                continue
            j = next(n for n, (a, b) in enumerate(zip(h.new_tokens, hb.new_tokens)) if a != b)
            seq = np.concatenate([r.prompt, np.asarray(hb.new_tokens[:j], np.int32)])
            with torch.no_grad():
                logits = base_model(torch.as_tensor(seq, device=device)[None])[0, -1].float()
            top2 = torch.topk(logits, 2).values
            gap = ((top2[0] - top2[1]) / logits.abs().max()).item()
            flips.append({"request": i, "position": j, "top2_gap_over_max": gap})
            if gap > 2 ** -7:
                raise AssertionError(
                    f"{label} greedy request {i}: differs from the non-speculative stream "
                    f"at {j}, where the plain run's top-2 gap is {gap:.4f} of its largest "
                    f"logit (> 2**-7: not a near-tie)")
        summary.update(
            spec_k=k, draft=draft, verify_ticks=st["verify_ticks"],
            accept_rate=st["tokens_accepted"] / max(st["tokens_accepted"]
                                                    + st["tokens_rejected"], 1),
            tokens_per_tick=st["tokens_committed"] / max(st["verify_ticks"], 1),
            tokens_per_slot_tick=st["tokens_committed"] * k / max(
                st["tokens_accepted"] + st["tokens_rejected"], 1),
            draft_s=st["draft_s"], verify_s=st["verify_s"], greedy_flips=flips,
            base_tokens_per_s=base["tokens_per_s"])
        _print_line(label, summary)
        del server
        torch.cuda.empty_cache()
    _print_line("servespec_base", base)


def profile_decode(server, vocab, card, ticks=8):
    """Where a decode tick's time goes: 8 slots at 512-token contexts,
    ``ticks`` steady decode ticks under ``torch.profiler``. Reports the
    tick's host wall, the device time summed over kernels (busy share =
    device / wall), the decode kernel's family (its ``decode_attention``
    instantiations) per tick and the top kernels by device time."""
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
    family = sum(e.device_time_total for e in kernels
                 if "decode_attention" in e.key) / 1e3 / ticks
    print("profile " + json.dumps({
        "tick_wall_ms": wall_ms,
        "decode_attention_ms_per_tick": family if device_ms > 0 else "not measured",
        "tick_device_ms": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "device_ops_per_tick": sum(e.count for e in kernels) / ticks,
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
                 num_physical_batches=4, state_dict=None, accum_steps=1, device="cuda"):
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
                      batch_size_per_device=batch, num_classes=num_classes,
                      accum_steps=accum_steps)
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
                       ("packed attention (ours)", ("packed_",)),
                       ("dw_db (ours)", ("dw_db_",)),
                       ("fused_block (ours)", ("matmul_stats",)),
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
                          accum_steps=1, device="cuda"):
    """One fused and one unfused bf16 step from the same weights on the
    same batch, and whether they agree (with ``accum_steps=2``: one
    accumulated step each, the fused kernels at the microbatch shapes,
    each microbatch's BN statistics their own).

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
            num_classes=num_classes, num_physical_batches=1, state_dict=sd,
            accum_steps=accum_steps, device=device)
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
    res = {"accum_steps": accum_steps,
           "loss_fused": lf, "loss_unfused": lu, "loss_rel": abs(lf - lu) / abs(lu),
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


# Packed-QKV attention cases: (name, B, T, H, d, causal).
FP_CASES = (
    ("vit_b16", 64, 197, 12, 64, False),
    ("vit_l16", 32, 197, 16, 64, False),
    ("maxlen", 8, 512, 12, 64, False),
    ("d128", 4, 257, 4, 128, False),
    ("ragged_causal", 2, 100, 2, 64, True),
)
FP_OPS = ("fused_qkv_fwd", "fused_qkv_bwd")


def fp_bounds(b, t, h, d, causal):
    """Per kernel (bound_ms, bound_by, bytes, flops): qkv in and O out
    (forward); qkv, O and dO in and dqkv out (backward); 4 and 10 flops
    per (query, key) pair per head dim (QKᵀ and PV; QKᵀ again, dOVᵀ, dS·K,
    dSᵀQ and PᵀdO)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    row = b * t * h * d * 2  # bytes of one [B, T, H·d] bf16 tensor
    work = {"fused_qkv_fwd": (4 * row, 4.0 * b * h * pairs * d),
            "fused_qkv_bwd": (8 * row, 10.0 * b * h * pairs * d)}
    out = {}
    for op, (nbytes, flops) in work.items():
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOP_S * 1e3
        out[op] = (max(tb, to), "bytes" if tb >= to else "operations", int(nbytes), flops)
    return out


def fp_stats_limit(q, k, o, do, ref, scale: float) -> torch.Tensor:
    """Per-row limits ``[3, B·H, T]`` on |kernel − f32 plain| for the
    backward's statistics scratch (m, 1/l, Δ), given the same bf16 q, k,
    o and dO.

    A score is scale·Σ_d q_i·k_i, d exact products summed in another
    order: off by at most e = d·2**-24·scale·‖q‖·max‖k‖ (as in
    :func:`flash_lse_limit`); m, the row's largest score, by at most e
    plus its own rounding, 2**-24·|m|. l = Σ exp(s − m) over at most T
    terms: each term moves by at most 2e relative (s and m) and a few
    ulps (exp2f), and their sum in another order by T·2**-24 relative,
    so 1/l moves by at most (2e + (T + 4)·2**-24) of itself. Δ is a sum
    of d exact products: d·2**-24·Σ|dO·o|. Each limit is twice that
    worst case."""
    b, t, h, d = q.shape
    qn = q.float().norm(dim=-1).permute(0, 2, 1).reshape(b * h, t)
    kn = k.float().norm(dim=-1).amax(dim=1).reshape(b * h, 1)
    e = 2 ** -24 * d * scale * qn * kn
    absdot = (do.float() * o.float()).abs().sum(-1).permute(0, 2, 1).reshape(b * h, t)
    return 2 * torch.stack([e + 2 ** -24 * ref[0].abs(),
                            ref[1] * (2 * e + (t + 4) * 2 ** -24),
                            2 ** -24 * d * absdot])


def fp_check(fp, fl, name, b, t, h, d, causal, g):
    """Both packed-attention kernels against their plain versions (f32,
    the same bf16 inputs; the backward's plain version gets the kernel's
    own O, so it holds the backward kernel alone), with the flash limits
    (``flash_limit`` on the same rounding points: p rounded before P·V
    and dV, ds before dQ and dK, each result once; ``flash_terms`` with
    p̂ = exp(s − lse) = p/l). The backward runs twice and must repeat
    bit for bit, and its statistics scratch (m, 1/l, Δ) is held to
    ``fp.backward_row_stats_plain`` within :func:`fp_stats_limit`. At
    ``vit_b16`` a forward that drops each query block's last key tile
    must fail the O limit. Returns ``(errs, control, (qkv, do, out))``,
    errs by output: ``(max abs error, error over limit)``."""
    bf = torch.bfloat16
    qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g).to(bf)
    do = torch.randn(b, t, h * d, device="cuda", generator=g).to(bf)
    sc = d ** -0.5
    out = fp.fused_qkv_forward(qkv, h, causal, sc)
    dqkv, stats = fp.fused_qkv_backward(qkv, out, do, h, causal, sc, return_stats=True)
    again = fp.fused_qkv_backward(qkv, out, do, h, causal, sc)
    torch.cuda.synchronize()
    for x, what in ((out, "O"), (dqkv, "dQKV")):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"{name}: non-finite kernel {what}")
    if not torch.equal(dqkv, again):
        raise AssertionError(f"{name}: the backward does not repeat bit for bit")
    del again
    ref_o = fp.fused_qkv_attention_plain(qkv.float(), h, causal, sc)
    ref_d = fp.fused_qkv_attention_backward_plain(qkv.float(), out.float(), do.float(), h,
                                                  causal, sc)
    q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    o4, do4 = out.view(b, t, h, d), do.view(b, t, h, d)
    ref_s = fp.backward_row_stats_plain(qkv.float(), out.float(), do.float(), h, causal, sc)
    errs = {"stats": _ratio(stats, ref_s, fp_stats_limit(q, k, o4, do4, ref_s, sc))}
    lse = fl.flash_forward_plain(q.float(), k.float(), v.float(), causal, sc)[1]
    t_o, t_dq, t_dk, t_dv = flash_terms(q, k, v, o4, do4, lse, fl.flash_delta(o4, do4),
                                        causal, sc)
    del lse, ref_s
    ref_o4 = ref_o.view(b, t, h, d)
    o_limit = flash_limit(ref_o4, t_o)
    errs["O"] = _ratio(o4, ref_o4, o_limit)
    got_parts, ref_parts = dqkv.view(b, t, 3, h, d), ref_d.view(b, t, 3, h, d)
    for i, (what, terms) in enumerate((("dQ", t_dq), ("dK", t_dk), ("dV", t_dv))):
        errs[what] = _ratio(got_parts[:, :, i], ref_parts[:, :, i],
                            flash_limit(ref_parts[:, :, i], terms))
    for what, (err, ratio) in errs.items():
        if ratio > 1.0:
            raise AssertionError(
                f"{name}: |kernel {what} - plain| exceeds its limit {ratio:.2f}x "
                f"(max abs error {err})")
    control = None
    if name == "vit_b16":
        bad = fp.fused_qkv_forward(qkv, h, causal, sc, drop_last_tile=True)
        control = _ratio(bad.view(b, t, h, d), ref_o4, o_limit)[1]
        if not control > 1.0:
            raise AssertionError(f"{name}: the dropped-tile variant passes ({control:.2f}x)")
    return errs, control, (qkv, do, out)


def fp_case(fp, fl, name, b, t, h, d, causal, flush, g):
    """:func:`fp_check`, then CUDA-event times of each kernel, its plain
    version (bf16 operands, f32 inside), the library yardstick
    (scaled_dot_product_attention on the q, k, v views of the packed
    projection; its backward timed as forward+backward minus forward)
    and the bound."""
    import torch.nn.functional as F

    errs, control, (qkv, do, out) = fp_check(fp, fl, name, b, t, h, d, causal, g)
    sc = d ** -0.5
    q, k, v = qkv.view(b, t, 3, h, d).unbind(2)
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do.view(b, t, h, d)))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=sc)

    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=sc)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    with torch.no_grad():
        times = {
            "fused_qkv_fwd": time_ms(lambda: fp.fused_qkv_forward(qkv, h, causal, sc), flush),
            "fused_qkv_bwd": time_ms(
                lambda: fp.fused_qkv_backward(qkv, out, do, h, causal, sc), flush),
        }
        plain = {
            "fused_qkv_fwd": time_ms(
                lambda: fp.fused_qkv_attention_plain(qkv, h, causal, sc), flush),
            "fused_qkv_bwd": time_ms(
                lambda: fp.fused_qkv_attention_backward_plain(qkv, out, do, h, causal, sc),
                flush),
        }
        sdpa_fwd = time_ms(sdpa, flush)
    sdpa_fb = time_ms(sdpa_fwd_bwd, flush)
    library = {"fused_qkv_fwd": sdpa_fwd, "fused_qkv_bwd": sdpa_fb - sdpa_fwd}
    bounds = fp_bounds(b, t, h, d, causal)
    return {
        "case": name, "shape": {"B": b, "T": t, "H": h, "d": d, "causal": causal},
        "max_abs_err": {w: e[0] for w, e in errs.items()},
        "err_over_limit": {w: e[1] for w, e in errs.items()},
        "negative_control_O_err_over_limit": control,
        "kernels": {op: {"ms": times[op], "plain_ms": plain[op], "library_ms": library[op],
                         "bound_ms": bounds[op][0], "bound_by": bounds[op][1],
                         "bytes": bounds[op][2], "flops": bounds[op][3]}
                    for op in FP_OPS},
    }


def fp_phase(fp, fl, flush):
    g = torch.Generator(device="cuda").manual_seed(1357)
    cases = []
    for case in FP_CASES:
        cases.append(fp_case(fp, fl, *case, flush, g))
        torch.cuda.empty_cache()
    return cases


def _fp_entry(op, cases, launches):
    main_case = next(c for c in cases if c["case"] == "vit_b16")["kernels"][op]
    outputs = {"fused_qkv_fwd": ("O",), "fused_qkv_bwd": ("dQ", "dK", "dV")}[op]
    return {
        "name": op, "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/flash_packed.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/flash_packed.py:"
                    + {"fused_qkv_fwd": "259", "fused_qkv_bwd": "285"}[op],
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"][w] for c in cases for w in outputs),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "timed_case": "vit_b16",
    }


H100_F32_FLOP_S = 67e12  # float32 outside the tensor cores

# dW+db cases: (name, N, K, M, dtype). ViT-B/16 at batch 64: N = 64·197;
# a ragged N (the wgmma kernel's partial last chunk), and K and M that no
# tensor map takes (the mma.sync kernel, rows loaded element by element).
FG_CASES = (
    ("vit_b16_qkv", 12_608, 768, 2304, torch.bfloat16),
    ("vit_b16_proj", 12_608, 768, 768, torch.bfloat16),
    ("vit_b16_fc1", 12_608, 768, 3072, torch.bfloat16),
    ("vit_b16_fc2", 12_608, 3072, 768, torch.bfloat16),
    ("vit_b16_head_f32", 64, 768, 1000, torch.float32),
    ("ragged_n", 1000, 256, 384, torch.bfloat16),
    ("ragged_km", 1000, 250, 390, torch.bfloat16),
)
# The dropped-split control's shape: a plan of four splits of 1,024 rows.
FG_CONTROL = ("split_control", 4096, 256, 256, torch.bfloat16)


def fg_limit(terms: torch.Tensor, n: int) -> torch.Tensor:
    """Per-element limit on |kernel - f32 plain| for dW and db: each is a
    sum of n products that are exact in f32 (bf16 inputs) or rounded once
    (f32 FMA), taken in another order on each side. Recursive f32
    summation errs by at most n·2**-24·Σ|terms|, and a tensor-core
    accumulation that truncates instead of rounding by n·2**-23·Σ|terms|,
    so the two sides differ by less than n·(2**-23 + 2**-24)·Σ|terms| <
    n·2**-22·Σ|terms|, the limit. Real sums err far less (like √n). It
    still catches a lost row chunk: in the ragged case (N = 1,000, a last
    chunk of 8 rows of unit normals) dropping it moves a dW element by
    about √8 = 2.8 against a limit of about 0.15; and any indexing error
    (order 1 of the result)."""
    return n * 2 ** -22 * terms


def fg_case(fg, name, n, k, m, dtype, flush, g):
    """``matmul_dw_db`` against its plain version run in f32 on the same
    inputs, the limit above, run twice for equal bits, its plan (path,
    tile, splits), CUDA-event times of the kernel, the plain version, two
    library yardsticks and the bound. ``library_ms``:
    ``torch.matmul(g.T, x)`` and ``g.float().sum(0)`` (dW rounded to
    the inputs' dtype, and g copied to f32 first); ``library_f32_ms``:
    ``torch.mm(g.T, x, out_dtype=torch.float32)`` and ``g.sum(0,
    dtype=torch.float32)``, the kernel's own function (for bf16 inputs;
    for f32 the plain matmul and sum)."""
    x = torch.randn(n, k, device="cuda", generator=g).to(dtype)
    gr = torch.randn(n, m, device="cuda", generator=g).to(dtype)
    dw, db = fg.matmul_dw_db_cuda(x, gr)
    dw2, db2 = fg.matmul_dw_db_cuda(x, gr)
    torch.cuda.synchronize()
    if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
        raise AssertionError(f"{name}: a second launch did not repeat the first bit for bit")
    del dw2, db2
    if dw.shape != (m, k) or db.shape != (m,) or dw.dtype != torch.float32:
        raise AssertionError(f"{name}: dW {tuple(dw.shape)} {dw.dtype}, db {tuple(db.shape)}")
    if not (torch.isfinite(dw).all() and torch.isfinite(db).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    ref_dw, ref_db = fg.matmul_dw_db_plain(x, gr)
    xa, ga = x.float().abs(), gr.float().abs()
    errs = {"dW": _ratio(dw, ref_dw, fg_limit(ga.t() @ xa, n)),
            "db": _ratio(db, ref_db, fg_limit(ga.sum(0), n))}
    del xa, ga, ref_dw, ref_db
    for what, (err, ratio) in errs.items():
        if ratio > 1.0:
            raise AssertionError(
                f"{name}: |kernel {what} - plain| exceeds its limit {ratio:.2f}x "
                f"(max abs error {err})")

    def library():
        return torch.matmul(gr.t(), x), gr.float().sum(0)

    def library_f32():
        if dtype == torch.float32:
            return torch.mm(gr.t(), x), gr.sum(0)
        return torch.mm(gr.t(), x, out_dtype=torch.float32), gr.sum(0, dtype=torch.float32)

    nbytes = x.element_size() * (n * k + n * m) + 4 * (m * k + m)
    flops = 2.0 * n * k * m
    rate = H100_BF16_FLOP_S if dtype == torch.bfloat16 else H100_F32_FLOP_S
    bound_bytes, bound_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / rate * 1e3
    return {
        "case": name, "shape": {"N": n, "K": k, "M": m, "dtype": str(dtype).split(".")[-1]},
        "plan": fg.plan_for(x, gr), "repeats_bitwise": True,
        "max_abs_err": {w: e[0] for w, e in errs.items()},
        "err_over_limit": {w: e[1] for w, e in errs.items()},
        "ms": time_ms(lambda: fg.matmul_dw_db_cuda(x, gr), flush),
        "plain_ms": time_ms(lambda: fg.matmul_dw_db_plain(x, gr), flush),
        "library_ms": time_ms(library, flush),
        "library_f32_ms": time_ms(library_f32, flush),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "bytes": int(nbytes), "flops": flops,
    }


def fg_phase(fg, flush):
    """Every ``FG_CASES`` case (between them all three kernels), then a
    negative control: the kernel with
    each dW tile's last row split left out of the merge
    (``drop_last_split=True``) must exceed ``fg_limit`` more than
    tenfold, at ``FG_CONTROL`` (a plan of several splits)."""
    g = torch.Generator(device="cuda").manual_seed(9753)
    cases = []
    for case in FG_CASES:
        cases.append(fg_case(fg, *case, flush, g))
        torch.cuda.empty_cache()
    paths = {c["plan"]["path"] for c in cases}
    if paths != {"wgmma", "mma_sync", "f32"}:
        raise AssertionError(f"the dW+db cases took the kernels {sorted(paths)}, not all three")
    _, n, k, m, dtype = FG_CONTROL
    x = torch.randn(n, k, device="cuda", generator=g).to(dtype)
    gr = torch.randn(n, m, device="cuda", generator=g).to(dtype)
    ref_dw, ref_db = fg.matmul_dw_db_plain(x, gr)
    xa, ga = x.float().abs(), gr.float().abs()
    dw, db = fg.matmul_dw_db_cuda(x, gr, drop_last_split=True)
    factor = max(_ratio(dw, ref_dw, fg_limit(ga.t() @ xa, n))[1],
                 _ratio(db, ref_db, fg_limit(ga.sum(0), n))[1])
    print("control " + json.dumps({"case": "dw_db_drop_last_split_" + FG_CONTROL[0],
                                   "plan": fg.plan_for(x, gr), "err_over_limit": factor}),
          flush=True)
    if not factor > 10:
        raise AssertionError(f"dW+db without each tile's last split stays within {factor:.2f}x "
                             f"of its limit: a split is not merged")
    return cases


def _fg_entry(cases, launches):
    main_case = next(c for c in cases if c["case"] == "vit_b16_qkv")
    return {
        "name": "matmul_dw_db", "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/fused_grads.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/fused_grads.py:160",
        "launches": launches,
        "max_abs_err": max(e for c in cases for e in c["max_abs_err"].values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "library_f32_ms": main_case["library_f32_ms"],
        "timed_case": "vit_b16_qkv",
    }


def _vit_setup(attn_impl, fused_dense_grad, *, variant="b", image_size=224, batch=64,
               num_classes=1000, num_physical_batches=4, state_dict=None, device="cuda"):
    """The port's entry points as a user calls them for ViT training:
    config, synthetic images, model (``fused_dense_grad`` as
    ``FUSED_DENSE_GRAD=1`` sets it), optimizer, seeded train state and
    step, on the card (``device="cpu"`` rehearses the flow at a small
    size)."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = TrainConfig(model=f"vit_{variant}16", image_size=image_size,
                      batch_size_per_device=batch, num_classes=num_classes, attn_impl=attn_impl)
    ds = SyntheticImageDataset(global_batch_size=cfg.global_batch_size,
                               image_size=cfg.image_size, num_classes=cfg.num_classes,
                               num_physical_batches=num_physical_batches, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), fused_dense_grad=fused_dense_grad,
                      device=device)
    tx, _ = create_optimizer(cfg, ds.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device, state_dict=state_dict)
    return cfg, ds, model, state, make_train_step(model, tx, cfg, device=device)


def vit_train_phase(fp, fg, card, attn_impl, fused_dense_grad, warmup=3, timed=20,
                    device="cuda", **size):
    """ViT-B/16 (224 px, 1000 classes, batch 64, bf16) on the port's
    synthetic images: ``warmup`` steps, then ``timed`` steps closed by a
    host readback of the loss. Checks finite losses and the launches per
    step: with ``attn_impl="fused"`` on the card each packed-attention
    kernel once per layer (forward, backward), and with fused dense
    grads ``matmul_dw_db`` once per Dense (4 a layer and the head);
    otherwise none."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device

    t0 = time.perf_counter()
    cfg, ds, model, state, step = _vit_setup(attn_impl, fused_dense_grad, device=device,
                                             **size)
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
    fp.launches = fg.launches = 0
    for k in fp.launches_by_op:
        fp.launches_by_op[k] = 0
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    float(m["loss"])  # host readback closes the timed window
    wall = time.perf_counter() - t0
    by_op = dict(fp.launches_by_op, matmul_dw_db=fg.launches)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    on_card = device == "cuda"
    attn = model.depth * timed if on_card and attn_impl == "fused" else 0
    dense = (4 * model.depth + 1) * timed if on_card and fused_dense_grad else 0
    want = {"fused_qkv_fwd": attn, "fused_qkv_bwd": attn, "matmul_dw_db": dense}
    if by_op != want:
        raise AssertionError(f"{attn_impl}: launches {by_op} over {timed} steps, want {want}")
    line = {
        "path": f"{attn_impl}{' + fused dense grads' if fused_dense_grad else ''}",
        "model": cfg.model, "image_size": cfg.image_size, "batch": cfg.global_batch_size,
        "dtype": cfg.compute_dtype, "images_per_s": timed * cfg.global_batch_size / wall,
        "step_ms": wall / timed * 1e3, "loss_first": losses[0], "loss_last": losses[-1],
        "launches_by_op": by_op, "steps": timed,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                        else "not measured"), "setup_s": setup_s, "card": card,
    }
    print("vittrain " + json.dumps(line), flush=True)
    return line, state, step, batches


# The flagged (fused attention + fused dense grads) and yardstick ViT
# steps from the same weights and batch: the limits (derived in
# vit_fused_vs_xla_step's docstring).
VIT_AGREE_LOSS_REL = 1e-3
VIT_AGREE_UPDATE_REL = 0.1
VIT_AGREE_LOGITS_REL = 2 ** -4


def _vit_group(name: str) -> str:
    for grp, marks in (("attention", (".attn.",)), ("mlp", (".mlp.",)), ("head", ("head.",)),
                       ("embeddings", ("patch_embed", "cls_token", "pos_embed"))):
        if any(mk in name for mk in marks):
            return grp
    return "layernorm"


def vit_fused_vs_xla_step(variant="b", image_size=224, batch=64, num_classes=1000,
                          device="cuda"):
    """One flagged step (``attn_impl="fused"``, ``FUSED_DENSE_GRAD=1``) and
    one yardstick step (``"xla"``, stock Dense) in bf16 from the same
    seeded weights on the same batch, and whether they agree. Limits:

    * loss: |L_fused - L_xla| / |L_xla| <= 1e-3;
    * updates, per group (attention, MLP, head, embeddings, LayerNorm):
      ||Δ_fused - Δ_xla|| / ||Δ_xla|| <= 0.1;
    * logits at the initial weights: max |fused - xla| <= 2**-4 of the
      largest |logit|.

    Derivation, written before the first run on the card: the two paths
    round at other places. The xla attention rounds its scores to bf16
    before the softmax (as the JAX package's ``_xla_attention``) and p
    before P·V; the packed kernels keep f32 scores and round p (and ds)
    to bf16. Stock autograd returns each Dense's dW and db in bf16 (the
    product's dtype) before the f32 parameter sees them; the flagged
    path keeps them in f32, a 2**-9 relative difference per element on
    top. So the steps differ by bf16 noise carried through 12 layers,
    as the LM's pallas and xla steps do (``lm_pallas_vs_xla_step``).
    Rehearsed on the CPU with the plain versions in bf16 (``vit_s16``
    and ``vit_b16`` at 64 px, batch 4): loss 1.2e-4 and 3.2e-4, update
    gaps 0.009-0.011, logits 0.008 and 0.011 of the largest; the limits
    are those of the LM comparison, 3-10x those readings."""
    from distributeddeeplearning_tpu_torch.models import convert

    sd = convert.init_vit_params(variant, 16, num_classes,
                                 torch.Generator(device=device).manual_seed(42), image_size)
    out = {}
    for impl, flag in (("xla", False), ("fused", True)):
        cfg, ds, model, state, step = _vit_setup(
            impl, flag, variant=variant, image_size=image_size, batch=batch,
            num_classes=num_classes, num_physical_batches=1, state_dict=sd, device=device)
        images, labels = next(iter(ds.epoch(0)))
        with torch.no_grad():
            logits = model(torch.from_numpy(images).to(device)).float()
        state, m = step(state, (images, labels))
        out[impl] = (float(m["loss"]), logits,
                     {k: v.detach().clone() for k, v in model.state_dict().items()})
        del cfg, ds, model, state, step
    (lx, gx, px), (lf, gf, pf) = out["xla"], out["fused"]
    logits_rel = ((gf - gx).abs().max() / gx.abs().max()).item()
    sums = {}
    for k, ref in sd.items():
        dx, df = px[k].double() - ref.double(), pf[k].double() - ref.double()
        n, d = sums.get(_vit_group(k), (0.0, 0.0))
        sums[_vit_group(k)] = (n + (df - dx).pow(2).sum().item(), d + dx.pow(2).sum().item())
    gaps = {grp: (n / d) ** 0.5 for grp, (n, d) in sums.items()}
    res = {"loss_fused": lf, "loss_xla": lx, "loss_rel": abs(lf - lx) / abs(lx),
           "update_rel_by_group": gaps, "logits_rel": logits_rel,
           "limits": {"loss_rel": VIT_AGREE_LOSS_REL, "update_rel": VIT_AGREE_UPDATE_REL,
                      "logits_rel": VIT_AGREE_LOGITS_REL}}
    res["within_limits"] = (res["loss_rel"] <= VIT_AGREE_LOSS_REL
                            and max(gaps.values()) <= VIT_AGREE_UPDATE_REL
                            and logits_rel <= VIT_AGREE_LOGITS_REL)
    return res


def vit_auto_launches(fp, batch=64, image_size=224, device="cuda"):
    """``attn_impl="auto"`` on the card: launches of ``fused_qkv_fwd`` in
    one forward of ViT-B/16 (T = 197 fits the packed kernel: one a
    layer)."""
    from distributeddeeplearning_tpu_torch.models import convert, get_model

    model = get_model("vit_b16", attn_impl="auto", image_size=image_size, device=device)
    model.load_state_dict(convert.init_vit_params(
        "b", 16, 1000, torch.Generator(device=device).manual_seed(0), image_size))
    images = torch.randn(batch, image_size, image_size, 3, device=device)
    before = fp.launches_by_op["fused_qkv_fwd"]
    with torch.no_grad():
        model(images)
    _sync(device)
    return fp.launches_by_op["fused_qkv_fwd"] - before


# Depthwise conv (csrc/depthwise.cu): a block's output tile (rows,
# columns) and channel tile, as the source sets them; the wgrad's
# summation depth follows from them.
DW_TILE_H, DW_TILE_W, DW_TILE_C = 8, 12, 32

# EfficientNet-B4's stride-1 depthwise layers at 380 px
# (models/efficientnet.py, width 1.4, depth 1.8): (C, H = W, k, layers),
# 28 layers in all.
B4_DW_LAYERS = (
    (48, 190, 3, 1), (24, 190, 3, 1), (192, 95, 3, 3), (336, 48, 5, 3), (672, 24, 3, 5),
    (672, 24, 5, 1), (960, 24, 5, 5), (1632, 12, 5, 7), (1632, 12, 3, 1), (2688, 12, 3, 1),
)

# dw cases: (name, batch, H, W, C, k, dtype). The B4 layers at batch 64
# in bf16 and an f32 one (the TMA stencil, the staged-tile wgrad), ragged
# H and W with C = 130 (the staged-tile kernel: element loads, the last
# channel tile part-filled) and C = 40 (the TMA stencil), k = 7, and k = 9
# (the direct kernels); depthwise.stencil_path and wgrad_path name each
# case's paths.
DW_CASES = tuple((f"b4_{c}x{h}_k{k}", 64, h, h, c, k, torch.bfloat16)
                 for c, h, k, _ in B4_DW_LAYERS) + (
    ("f32_672x24_k5", 8, 24, 24, 672, 5, torch.float32),
    ("ragged_13x11_c130_k7", 4, 13, 11, 130, 7, torch.bfloat16),
    ("ragged_13x11_c130_k3_f32", 4, 13, 11, 130, 3, torch.float32),
    ("ragged_17x9_c40_k7", 3, 17, 9, 40, 7, torch.bfloat16),
    ("direct_13x11_c130_k9", 2, 13, 11, 130, 9, torch.bfloat16),
)
DW_OPS = ("conv", "dgrad", "wgrad")


def dw_limit(ref: torch.Tensor, terms: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Per-element limit on |kernel - plain| for the stencil (forward and
    dgrad), against the plain version in f32 on the same inputs.

    Both sides sum the same n = k² products of exact inputs in f32, the
    kernel with one rounding per fused multiply-add, the plain version
    with one per product and one per sum: each errs by at most
    n·2**-24·Σ|x·w| (first order), so they differ by less than
    n·2**-22·Σ|x·w|. A bf16 output then rounds once more, by at most
    2**-8 of |y|. Derived before the kernel first ran; on the card the
    bf16 cases then read 0.96-0.996 of it (the output rounding, which
    the limit sizes exactly) and the f32 ones 0.04-0.11, while the dgrad
    run with unflipped taps exceeded it 7e4-fold."""
    u = 2 ** -8 if dtype == torch.bfloat16 else 0.0
    return u * ref.abs() + n * 2 ** -22 * terms


def dw_wgrad_depth(plan: dict, b: int, h: int, w: int) -> int:
    """The longest chain of f32 roundings (fused multiply-adds and
    additions) behind one dw element in the wgrad kernels of a
    ``depthwise.wgrad_plan`` for a ``[b, h, w, C]`` input:

    * TMA path: a thread adds its ``run`` columns' products (one fma
      each) to its sums for every output row of its strip, at most
      ``rows`` of them: ``rows · run``; the block then adds its
      ``tw / run`` runs' sums in run order, from zero: ``tw / run``;
      the partial rows' sum adds a strided share of the ``partials``
      rows (``ceil(partials / 32)``), then the 32 shares: 32 more.
    * Staged tile: a thread's 12 columns over each row tile of 8 rows
      (``12 · ceil(h / 8)``), the block's 8 thread rows, then the
      partial rows' sum as above.
    * Direct (other k): a thread row's share of the ``b·h·w``
      positions (every 8th), then the 8 rows."""
    if plan["path"] == "tma":
        tail = -(-plan["partials"] // 32) + 32
        return plan["rows"] * plan["run"] + plan["tw"] // plan["run"] + tail
    if plan["path"] == "tile":
        tail = -(-plan["partials"] // 32) + 32
        return DW_TILE_W * -(-h // DW_TILE_H) + DW_TILE_H + tail
    return -(-b * h * w // DW_TILE_H) + DW_TILE_H


def dw_wgrad_limit(terms: torch.Tensor, depth: int) -> torch.Tensor:
    """Limit on |kernel dw - exact dw| (the plain version in f64 on the
    same inputs): a sum along chains of ``depth`` f32 additions errs by
    at most depth·2**-24·Σ|x·dy| to first order; twice that covers the
    second order. (An f32 sum of B·H·W = 2.3M products has no useful
    worst-case bound, so the reference is f64.) A lost partial row moves
    dw by the sum of its own products: at B4's 190² × 48 layer at batch
    2 (76 partial rows of 5 output rows each) the dropped-partial control
    missed this limit 217-fold on the card."""
    return 2 * depth * 2 ** -24 * terms


def dw_cudnn_wgrad_limit(ref: torch.Tensor, terms: torch.Tensor, dtype) -> torch.Tensor:
    """cuDNN's wgrad against the exact one (its share when the kernel's
    f32 dw is held to cuDNN's): cuDNN's output rounds to the weight's
    dtype (2**-8 of |dw| in bf16), and its f32 sum of B·H·W products
    runs in an order it does not publish: 2**-12·Σ|x·dy| for that. On
    the card cuDNN's bf16 wgrad then read 0.03 of the summed limit at
    B4's 190² × 48 layer and up to 0.8 at the small ragged cases, where
    its output rounding fills it."""
    u = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -24
    return u * ref.abs() + 2 ** -12 * terms


def cudnn_dw_backward(dy, x, weight, mask):
    """cuDNN's grouped-conv backward (``aten.convolution_backward``): dx
    and/or dw, as ``mask`` asks."""
    c, _, k, _ = weight.shape
    return torch.ops.aten.convolution_backward(
        dy, x, weight, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], c, mask)


def dw_bounds(b, h, w, c, k, elem):
    """(bound_ms, bound_by, bytes, flops) of each op: an activation read
    and one written (the wgrad: x and dy read, dw written), the taps, and
    2·k² f32 operations per output element at the card's f32 FMA rate."""
    act = b * h * w * c
    nbytes = 2 * elem * act + 4 * k * k * c
    flops = 2.0 * k * k * act
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_F32_FLOP_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations", int(nbytes), flops


def dw_check(dwm, name, x, dy, taps, got, cudnn):
    """Hold the kernels' ``got = (y, dx, dw)`` to the plain version on
    the same inputs (f32 for the stencil, f64 for the wgrad), and to
    cuDNN's ``cudnn = (y, dx, dw [C, 1, k, k])`` on the same inputs and
    weight within both sides' limits: cuDNN's grouped conv and dgrad
    carry the kernel's own bound (they sum the same products in f32 and
    round once: on the card they gave the kernel's bits on all of B4's
    layers), so twice :func:`dw_limit`; its wgrad adds
    :func:`dw_cudnn_wgrad_limit`. Raises past a limit; returns the
    errors and their ratios."""
    k = int(round(taps.shape[0] ** 0.5))
    b, c, h, w = x.shape
    dt = x.dtype
    xa, dya, ta = x.float().abs(), dy.float().abs(), taps.abs()
    refs = {
        "y": (dwm.stencil_plain(x.float(), taps), dwm.stencil_plain(xa, ta)),
        "dx": (dwm.stencil_plain(dy.float(), taps, flip=True),
               dwm.stencil_plain(dya, ta, flip=True)),
    }
    out = {"max_abs_err": {}, "err_over_limit": {}, "cudnn_err_over_limit": {}}
    for (what, (ref, terms)), mine, lib in zip(refs.items(), got[:2], cudnn[:2]):
        lim = dw_limit(ref, terms, k * k, dt)
        err, ratio = _ratio(mine, ref, lim)
        _, lib_ratio = _ratio(mine, lib, 2 * lim)
        out["max_abs_err"][what], out["err_over_limit"][what] = err, ratio
        out["cudnn_err_over_limit"][what] = lib_ratio
    del refs, xa, dya
    ref = dwm.wgrad_plain(x.double(), dy.double(), k)
    terms = dwm.wgrad_plain(x.double().abs(), dy.double().abs(), k)
    lim = dw_wgrad_limit(terms, dw_wgrad_depth(dwm.wgrad_plan_for(x, dy, k), b, h, w))
    err = (got[2].double() - ref).abs().max().item()
    ratio = ((got[2].double() - ref).abs() / lim.clamp(min=1e-300)).max().item()
    lib_ratio = ((got[2].double() - dwm.weight_taps(cudnn[2]).double()).abs()
                 / (lim + dw_cudnn_wgrad_limit(ref, terms, dt)).clamp(min=1e-300)).max().item()
    out["max_abs_err"]["dw"], out["err_over_limit"]["dw"] = err, ratio
    out["cudnn_err_over_limit"]["dw"] = lib_ratio
    for key in ("err_over_limit", "cudnn_err_over_limit"):
        for what, r in out[key].items():
            if not r <= 1.0:  # NaN fails too
                against = "plain" if key == "err_over_limit" else "cuDNN"
                raise AssertionError(f"{name}: |kernel {what} - {against}| exceeds its limit "
                                     f"{r:.2f}x (max abs error {out['max_abs_err'][what]})")
    return out


def dw_times(dwm, x, dy, taps, flush, plain=True):
    """CUDA-event times of the three kernels, cuDNN's forward, dgrad and
    wgrad (``F.conv2d(groups=C)`` and ``aten.convolution_backward``,
    each output alone) and, with ``plain``, the plain versions (the same
    bf16 inputs, f32 inside)."""
    k = int(round(taps.shape[0] ** 0.5))
    weight = taps.t().reshape(-1, 1, k, k).to(x.dtype)
    c = weight.shape[0]
    with torch.no_grad():
        out = {
            "ms": {"conv": time_ms(lambda: dwm.stencil_cuda(x, taps), flush),
                   "dgrad": time_ms(lambda: dwm.stencil_cuda(dy, taps, flip=True), flush),
                   "wgrad": time_ms(lambda: dwm.wgrad_cuda(x, dy, k), flush)},
            "library_ms": {
                "conv": time_ms(lambda: torch.nn.functional.conv2d(
                    x, weight, padding=k // 2, groups=c), flush),
                "dgrad": time_ms(lambda: cudnn_dw_backward(dy, x, weight,
                                                           [True, False, False]), flush),
                "wgrad": time_ms(lambda: cudnn_dw_backward(dy, x, weight,
                                                           [False, True, False]), flush)},
        }
        if plain:
            out["plain_ms"] = {
                "conv": time_ms(lambda: dwm.stencil_plain(x, taps), flush),
                "dgrad": time_ms(lambda: dwm.stencil_plain(dy, taps, flip=True), flush),
                "wgrad": time_ms(lambda: dwm.wgrad_plain(x, dy, k), flush)}
    return out


def dw_case(dwm, name, b, h, w, c, k, dtype, flush, g):
    """The three kernels against their plain versions and cuDNN
    (:func:`dw_check`), with the times of :func:`dw_times` and the
    bound."""
    def randn():
        return torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last)

    x, dy = randn(), randn()
    # taps that the dtype holds exactly, so cuDNN's weight is the same
    taps = (torch.randn(k * k, c, device="cuda", generator=g) / k).to(dtype).float()
    weight = taps.t().reshape(c, 1, k, k).to(dtype)
    with torch.no_grad():
        got = (dwm.stencil_cuda(x, taps), dwm.stencil_cuda(dy, taps, flip=True),
               dwm.wgrad_cuda(x, dy, k))
        again = (dwm.stencil_cuda(x, taps), dwm.stencil_cuda(dy, taps, flip=True),
                 dwm.wgrad_cuda(x, dy, k))
        lib_y = torch.nn.functional.conv2d(x, weight, padding=k // 2, groups=c)
        lib_dx, lib_dw, _ = cudnn_dw_backward(dy, x, weight, [True, True, False])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b_) for a, b_ in zip(got, again)):
        raise AssertionError(f"{name}: a second forward, dgrad or wgrad did not repeat the "
                             f"first bit for bit")
    del again
    for t, shape, dt in zip(got, ((b, c, h, w),) * 2 + ((k * k, c),),
                            (dtype, dtype, torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or not torch.isfinite(t.float()).all():
            raise AssertionError(f"{name}: kernel output {tuple(t.shape)} {t.dtype}, "
                                 f"want {shape} {dt}, finite")
    line = {"case": name, "shape": {"B": b, "H": h, "W": w, "C": c, "k": k,
                                    "dtype": str(dtype).split(".")[-1]},
            "stencil_path": dwm.stencil_path(b, h, w, c, k, dtype),
            "wgrad_plan": dwm.wgrad_plan_for(x, dy, k), "repeats_bitwise": True}
    line.update(dw_check(dwm, name, x, dy, taps, got, (lib_y, lib_dx, lib_dw)))
    del got, lib_y, lib_dx, lib_dw
    line.update(dw_times(dwm, x, dy, taps, flush))
    bound_ms, bound_by, nbytes, flops = dw_bounds(b, h, w, c, k, x.element_size())
    line.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, flops=flops)
    return line


def dw_phase(dwm, flush):
    """Every ``DW_CASES`` case (each line names the stencil path its shape
    takes, ``depthwise.stencil_path``, and the wgrad's plan), then three
    negative controls: the dgrad run with unflipped taps on an asymmetric
    tap table must exceed its limit (the taps are reversed where they
    must be), on the tile path (the ragged C = 130 case) and on the TMA
    path (B4's 190² × 48 k3 layer at batch 2); and the wgrad with its
    last partial row left out of the sum must exceed its limit more than
    tenfold (every partial is summed) at that layer and batch."""
    g = torch.Generator(device="cuda").manual_seed(2468)
    cases = []
    for case in DW_CASES:
        cases.append(dw_case(dwm, *case, flush, g))
        torch.cuda.empty_cache()
    off = [c["case"] for c in cases if c["case"].startswith("b4_")
           and (c["stencil_path"], c["wgrad_plan"]["path"]) != ("tma", "tma")]
    if off:
        raise AssertionError(f"B4 layers off the TMA stencil or wgrad path: {off}")
    for control, batch in (("ragged_13x11_c130_k7", None), ("b4_48x190_k3", 2)):
        _, b, h, w, c, k, dtype = next(cs for cs in DW_CASES if cs[0] == control)
        b = batch or b
        dy = torch.randn(b, c, h, w, device="cuda", generator=g).to(dtype).contiguous(
            memory_format=torch.channels_last)
        taps = torch.randn(k * k, c, device="cuda", generator=g) / k
        if torch.equal(taps, taps.flip(0)):
            raise AssertionError("the control's tap table is symmetric")
        ref = dwm.stencil_plain(dy.float(), taps, flip=True)
        lim = dw_limit(ref, dwm.stencil_plain(dy.float().abs(), taps.abs(), flip=True), k * k,
                       dtype)
        _, factor = _ratio(dwm.stencil_cuda(dy, taps, flip=False), ref, lim)
        path = dwm.stencil_path(b, h, w, c, k, dtype)
        print("control " + json.dumps({"case": f"dgrad_unflipped_taps_{control}_b{b}",
                                       "stencil_path": path, "err_over_limit": factor}),
              flush=True)
        if not factor > 10:
            raise AssertionError(f"the dgrad with unflipped taps ({path} path) stays within "
                                 f"{factor:.2f}x of its limit: the taps are not reversed")
    _, _, h, w, c, k, dtype = next(cs for cs in DW_CASES if cs[0] == "b4_48x190_k3")
    x, dy = (torch.randn(2, c, h, w, device="cuda", generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last) for _ in range(2))
    plan = dwm.wgrad_plan_for(x, dy, k)
    ref = dwm.wgrad_plain(x.double(), dy.double(), k)
    lim = dw_wgrad_limit(dwm.wgrad_plain(x.double().abs(), dy.double().abs(), k),
                         dw_wgrad_depth(plan, 2, h, w))
    got = dwm.wgrad_cuda(x, dy, k, drop_last_partial=True).double()
    factor = ((got - ref).abs() / lim.clamp(min=1e-300)).max().item()
    print("control " + json.dumps({"case": "wgrad_drop_last_partial_b4_48x190_k3_b2",
                                   "wgrad_plan": plan, "err_over_limit": factor}), flush=True)
    if not factor > 10:
        raise AssertionError(f"the wgrad without its last partial row stays within "
                             f"{factor:.2f}x of its limit: a partial is not summed")
    return cases


def _dw_entry(op, cases, launches, by_op, model_launches):
    """A ``kernels`` line entry of the stencil (``depthwise_conv``: the
    forward, with the dgrad's numbers beside) or the wgrad
    (``depthwise_wgrad``), timed at B4's 190² x 48 k3 layer; the B4
    24² x 960 k5 layer's times beside. ``launches`` counts the hook
    pass, the training pass ``chip_smoke`` drives through the kernels;
    ``model_launches`` the model's own timed steps, where the port's
    EfficientNet (as JAX's) runs cuDNN's grouped conv."""
    timed, second = "b4_48x190_k3", "b4_960x24_k5"
    main_case = next(c for c in cases if c["case"] == timed)
    other = next(c for c in cases if c["case"] == second)
    ops = ("conv", "dgrad") if op == "depthwise_conv" else ("wgrad",)
    outputs = ("y", "dx") if op == "depthwise_conv" else ("dw",)
    entry = {
        "name": op, "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/depthwise.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/depthwise.py:"
                    + ("178" if op == "depthwise_conv" else "208"),
        "launches": launches, "launches_by_op": by_op, "model_path_launches": model_launches,
        "max_abs_err": max(c["max_abs_err"][o] for c in cases for o in outputs),
        "ms": main_case["ms"][ops[0]], "plain_ms": main_case["plain_ms"][ops[0]],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"][ops[0]], "timed_case": timed,
        second: {key: other[key][ops[0]] for key in ("ms", "plain_ms", "library_ms")},
    }
    if op == "depthwise_conv":
        entry["dgrad"] = {case["case"]: {key: case[key]["dgrad"]
                                         for key in ("ms", "plain_ms", "library_ms")}
                          for case in (main_case, other)}
    entry[second]["bound_ms"] = other["bound_ms"]
    return entry


def _effnet_setup(*, variant="b4", image_size=None, batch=64, num_classes=1000,
                  num_physical_batches=4, device="cuda"):
    """The port's entry points as a user calls them for EfficientNet
    training: config, synthetic images, model, optimizer, seeded train
    state and step, on the card (``device="cpu"`` rehearses the flow at a
    small size). ``image_size`` defaults to the variant's resolution."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.models.efficientnet import SCALING
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = TrainConfig(model=f"efficientnet_{variant}",
                      image_size=image_size or SCALING[variant][2],
                      batch_size_per_device=batch, num_classes=num_classes)
    ds = SyntheticImageDataset(global_batch_size=cfg.global_batch_size,
                               image_size=cfg.image_size, num_classes=cfg.num_classes,
                               num_physical_batches=num_physical_batches, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), device=device)
    tx, _ = create_optimizer(cfg, ds.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device)
    return cfg, ds, model, state, make_train_step(model, tx, cfg, device=device)


def effnet_train_phase(dwm, card, warmup=3, timed=20, device="cuda", **size):
    """EfficientNet-B4 (380 px, 1000 classes, batch 64, bf16, drop-path
    and head dropout on) on the port's synthetic images: ``warmup``
    steps, then ``timed`` steps closed by a host readback of the loss.
    Checks finite losses and that the model path launched no depthwise
    kernel (its depthwise convs are cuDNN's, as JAX's are XLA's)."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device

    t0 = time.perf_counter()
    cfg, ds, model, state, step = _effnet_setup(device=device, **size)
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
    _reset_dw(dwm)
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    float(m["loss"])  # host readback closes the timed window
    wall = time.perf_counter() - t0
    launches = dwm.launches
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if launches:
        raise AssertionError(f"the model path launched the depthwise kernels {launches} times")
    line = {
        "model": cfg.model, "image_size": cfg.image_size, "batch": cfg.global_batch_size,
        "dtype": cfg.compute_dtype, "dropout": model.dropout_rate, "survival_prob": 0.8,
        "images_per_s": timed * cfg.global_batch_size / wall,
        "step_ms": wall / timed * 1e3, "loss_first": losses[0], "loss_last": losses[-1],
        "steps": warmup + timed, "depthwise_launches": launches,
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
                        else "not measured"), "setup_s": setup_s,
        "card": card,
    }
    print("effnettrain " + json.dumps(line), flush=True)
    return line, state, step, batches, ds, cfg


def effnet_train_fit(dwm, card, batch=64, min_batch=8, **kw):
    """:func:`effnet_train_phase` at ``batch``, halved while it runs out
    of the card's memory (the resolution stays), each cut printed."""
    while True:
        try:
            return effnet_train_phase(dwm, card, batch=batch, **kw)
        except torch.cuda.OutOfMemoryError:
            if batch // 2 < min_batch:
                raise
        gc.collect()  # the failed attempt's tensors, now unreferenced
        torch.cuda.empty_cache()
        print("effnettrain_cut " + json.dumps({"batch": batch, "to": batch // 2,
                                               "reason": "out of device memory"}), flush=True)
        batch //= 2


def _reset_dw(dwm):
    dwm.launches = 0
    for k in dwm.launches_by_op:
        dwm.launches_by_op[k] = 0


def effnet_hook_pass(dwm, model, cfg, batch, flush, device="cuda"):
    """One training forward and backward of the model with a forward hook
    on each depthwise conv where ``supports`` holds (the 28 stride-1
    layers of B4): the hook runs the port's ``depthwise_conv2d`` on the
    layer's real input and weight and hands its output on in place of
    cuDNN's, so the rest of the forward and the whole backward go through
    the kernels (forward, dgrad, wgrad); a hook on that output keeps the
    layer's real dy. The counters are zeroed before and read after.
    Then, per layer, the kernels on the layer's x, weight and dy are held
    to the plain version and to cuDNN's forward, dgrad and wgrad
    (:func:`dw_check`) and timed beside them. No model flag: the hooks
    are this function's own. On the CPU (a rehearsal) it stops after the
    pass."""
    from distributeddeeplearning_tpu_torch.data.pipeline import normalize_staged_images, to_device
    from distributeddeeplearning_tpu_torch.training.train_step import (
        cross_entropy_loss,
        dropout_seed,
    )

    layers, handles = [], []

    def hook(name):
        def forward_hook(mod, inputs, output):
            x = inputs[0].to(mod.dtype)
            _, c, h, w = x.shape
            if mod.stride != 1 or not dwm.supports(h, w, c, mod.kernel, 1):
                return None
            weight = mod.weight.to(mod.dtype)
            y = dwm.depthwise_conv2d(x, weight)
            rec = {"name": name, "x": x.detach(), "weight": weight.detach(),
                   "y": y.detach(), "y_cudnn": output.detach()}
            y.register_hook(lambda g: rec.__setitem__("dy", g.detach()))
            layers.append(rec)
            return y
        return forward_hook

    for name in model.block_names:
        handles.append(getattr(model, name).dw_conv.register_forward_hook(hook(name)))
    images, labels = to_device(batch, device)
    images = normalize_staged_images(images)
    gen = torch.Generator(device=device).manual_seed(dropout_seed(cfg.seed, 0, 0))
    params = list(model.parameters())
    model.train()
    _sync(device)
    _reset_dw(dwm)
    try:
        loss = cross_entropy_loss(model(images, generator=gen), labels)
        torch.autograd.grad(loss, params)
        _sync(device)
    finally:
        for h in handles:
            h.remove()
    by_op = dict(dwm.launches_by_op)
    n = len(layers)
    want = n if device == "cuda" else 0  # on the CPU the plain versions run
    loss = float(loss.detach())
    if by_op != {k: want for k in by_op} or not np.isfinite(loss):
        raise AssertionError(f"hook pass over {n} layers launched {by_op}, loss {loss}")
    if device != "cuda":
        return {"layers": n, "launches_by_op": by_op, "loss": loss}

    totals = {"ms": dict.fromkeys(DW_OPS, 0.0), "library_ms": dict.fromkeys(DW_OPS, 0.0)}
    bound = 0.0
    worst = {"err_over_limit": {}, "cudnn_err_over_limit": {}}
    per_layer = []
    for rec in layers:
        x, weight, dy = rec.pop("x"), rec.pop("weight"), rec.pop("dy")
        taps = dwm.weight_taps(weight)
        k = weight.shape[-1]
        with torch.no_grad():
            lib_dx, lib_dw, _ = cudnn_dw_backward(dy, x, weight, [True, True, False])
            got = (rec.pop("y"), dwm.stencil_cuda(dy, taps, flip=True),
                   dwm.wgrad_cuda(x, dy, k))
        res = dw_check(dwm, rec["name"], x, dy, taps, got, (rec.pop("y_cudnn"), lib_dx, lib_dw))
        del got, lib_dx, lib_dw
        for key in worst:
            for what, r in res[key].items():
                worst[key][what] = max(worst[key].get(what, 0.0), r)
        b, c, h, w = x.shape
        t = dw_times(dwm, x, dy, taps, flush, plain=False)
        for key in totals:
            for op in DW_OPS:
                totals[key][op] += t[key][op]
        bound += dw_bounds(b, h, w, c, k, x.element_size())[0]
        per_layer.append({"name": rec["name"], "C": c, "H": h, "k": k,
                          "stencil_path": dwm.stencil_path(b, h, w, c, k, x.dtype),
                          "ms": t["ms"], "library_ms": t["library_ms"]})
        del x, weight, dy
    return {"layers": n, "launches_by_op": by_op, "loss": loss,
            "max_err_over_limit": worst["err_over_limit"],
            "max_cudnn_err_over_limit": worst["cudnn_err_over_limit"],
            "kernel_ms_sum": totals["ms"], "cudnn_ms_sum": totals["library_ms"],
            "kernel_ms_total": sum(totals["ms"].values()),
            "cudnn_ms_total": sum(totals["library_ms"].values()),
            "bound_ms_sum_per_op": bound, "per_layer": per_layer}


# The fit phase's resume: the run resumed from its step-15 checkpoint
# against the uninterrupted run, all parameters together
# (||p_resumed - p_full|| / ||p_full - p_init||) and each running
# statistic (max |resumed - full| / max |full|).
FIT_RESUME_PARAM_REL = 1e-2
FIT_RESUME_STATS_REL = 1e-2


def _fit_watch(watch_syncs):
    """A callback for ``fit``: snapshots the state at train begin, stamps
    each step's end on the host clock and, from the end of the first step
    to the end of the run, sets ``torch.cuda.set_sync_debug_mode("warn")``
    (every synchronizing CUDA call then warns)."""
    from distributeddeeplearning_tpu_torch.training.callbacks import Callback

    class FitWatch(Callback):
        def __init__(self):
            self.stamps, self.init = [], None

        def on_train_begin(self, logs=None):
            self.init = {k: v.detach().clone()
                         for k, v in logs["state"].model.state_dict().items()}

        def on_step_end(self, step, logs=None):
            self.stamps.append(time.perf_counter())
            if watch_syncs and len(self.stamps) == 1:
                torch.cuda.set_sync_debug_mode("warn")

        def on_train_end(self, logs=None):
            if watch_syncs:
                torch.cuda.set_sync_debug_mode(0)

    return FitWatch()


def _sync_site(frames):
    """``file:line`` of the innermost frame of the repo (the port or this
    script) in a warning's stack: the line that made the call; None for
    the warning ``torch.cuda.set_sync_debug_mode`` itself raises."""
    if any(f.name == "set_sync_debug_mode" for f in frames):
        return None
    for f in reversed(frames):
        for mark in ("/distributeddeeplearning_tpu_torch/", "/chip_smoke.py"):
            if mark in f.filename:
                return f"{f.filename.split(mark)[-1] or 'chip_smoke.py'}:{f.lineno}"
    return f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"


def _fit_run(counter, cfg, data, model, device, watch_syncs=False, track=True, state=None,
             tx=None):
    """``training.loop.fit`` as a user calls it, on a state built first
    (``create_train_state``: the seeded init, whose set-up reads are not
    the loop's) unless ``state`` and ``tx`` are given, with ``track``
    under ``hostsync.track()`` (every tensor
    materialisation counted), and with synchronizing-call warnings
    caught. Returns the result, the watch callback, the kernels'
    launches by op in this run, the host syncs by label and each
    synchronizing call as the ``file:line`` of the repo's line that
    made it (:func:`_sync_site`)."""
    import contextlib
    import traceback
    import warnings

    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        loop,
    )
    from distributeddeeplearning_tpu_torch.utils import hostsync

    if state is None:
        tx, _ = create_optimizer(cfg, data.steps_per_epoch)
        state = create_train_state(model, cfg, tx, device=device)
    watch = _fit_watch(watch_syncs and torch.device(device).type == "cuda")
    counter.launches = 0
    for k in counter.launches_by_op:
        counter.launches_by_op[k] = 0
    hostsync.accountant().reset()
    syncs = []

    def show(message, category, filename, lineno, file=None, line=None):
        site = _sync_site(traceback.extract_stack()[:-1]) if "synchroniz" in str(message) else None
        if site is not None:
            syncs.append(site)

    with warnings.catch_warnings(), (hostsync.track() if track else contextlib.nullcontext()):
        warnings.simplefilter("always")
        warnings.showwarning = show
        res = loop.fit(model, cfg, data, device=device, tx=tx, state=state,
                       callbacks=[watch], add_default_logger=False)
    return (res, watch, dict(counter.launches_by_op), dict(hostsync.accountant().by_label),
            syncs)


def _fit_tx(cfg, data):
    from distributeddeeplearning_tpu_torch.training import create_optimizer

    return create_optimizer(cfg, data.steps_per_epoch)[0]


def _bare_turn(model, tx, cfg, state, data, device):
    """One epoch of the bare step (``make_train_step`` over
    ``prefetch_to_device``, as the ``train`` phase runs it), closed by a
    host readback of the loss: the state and each step end's host time."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device
    from distributeddeeplearning_tpu_torch.training import make_train_step

    step = make_train_step(model, tx, cfg, device=device)
    stamps = []
    for batch in prefetch_to_device(data.epoch(0), device):
        state, m = step(state, batch)
        stamps.append(time.perf_counter())
    float(m["loss"])
    return state, stamps


def _resnet_fit_setup(*, epochs, steps, accum_steps=1, model_dir=None, every=0,
                      image_size=224, batch=64, num_classes=1000, device="cuda"):
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model

    cfg = TrainConfig(model="resnet50", image_size=image_size, batch_size_per_device=batch,
                      num_classes=num_classes, fake_data_length=steps * batch, epochs=epochs,
                      accum_steps=accum_steps, model_dir=model_dir,
                      checkpoint_every_steps=every, log_every_steps=1)
    data = SyntheticImageDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size,
                                 image_size=image_size, num_classes=num_classes,
                                 num_physical_batches=4, seed=cfg.seed)
    model = get_model(cfg.model, num_classes=num_classes, dtype=cfg.compute_dtype, fused=True,
                      device=device)
    return cfg, data, model


def _check_fit_run(what, res, launches, by_label, want_launches, epochs, saves=0):
    losses = [h["loss"] for h in res.history]
    if len(losses) != epochs or not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: epoch means {losses}")
    if launches != want_launches:
        raise AssertionError(f"{what}: kernel launches {launches}, want {want_launches}")
    want = {"epoch_metrics": epochs}
    if saves:
        want["checkpoint"] = saves
    if by_label != want:
        raise AssertionError(f"{what}: host syncs {by_label}, want {want} (one an epoch, "
                             f"one a checkpoint save)")


def fit_phase(fb, fl, card, bare_step_ms=None, device="cuda", image_size=224, batch=64,
              num_classes=1000, lm_size=None):
    """The training loop (``training.loop.fit``) at full width on the card:

    1. fused ResNet-50 (224 px, batch 64, bf16), one epoch of 12 steps as
       a user runs it. Checks: ``fused_block`` 32 launches a forward,
       finite epoch means, one host sync, and no synchronizing CUDA call
       from the second step on but the loop's own epoch readback
       (``torch.cuda.set_sync_debug_mode("warn")``, each call traced to
       the repo's line that made it; ``utils/hostsync.py`` only). Prints
       the loop's step wall (the median interval between step ends)
       beside ``bare_step_ms``, the ``train`` phase's bare step.
    2. The same for 2 epochs with ``MODEL_DIR`` a temporary directory and
       ``CHECKPOINT_EVERY_STEPS=5`` (saves at 5, 10, 12, 15, 20, 24; the
       newest 3 kept), under ``hostsync.track()``: exactly one host sync
       an epoch and one a save (every ``Tensor.item``/``.cpu``/... of the
       loop counted); the steps' walls with the saves.
    3. The checkpoints past step 15 deleted and ``fit`` run again: it
       resumes mid-epoch 2 (3 of 12 batches replayed) and must end within
       ``FIT_RESUME_*`` of the uninterrupted run; whether its bits are
       equal is printed (cuDNN may pick non-deterministic backward
       algorithms).
    4. One epoch with ``ACCUM_STEPS=2``: 64 launches a dispatch, then one
       fused against one unfused accumulated step within
       ``fused_vs_unfused_step``'s limits.
    5. ``lm_base`` (T 1024, batch 8, vocab 32,000) with
       ``attn_impl="pallas"``: one epoch of 6 steps, each flash kernel
       launched 12 times a forward or backward, one host sync.

    Returns each kernel's launches by op in run 1 (ResNet-50, 12 steps)
    and in the ``lm_base`` run (6 steps). ``device="cpu"`` with small
    ``image_size``/``batch``/``num_classes`` and ``lm_size`` rehearses
    the flow (no kernel launches there)."""
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch import faults

    on_card = torch.device(device).type == "cuda"
    size = dict(image_size=image_size, batch=batch, num_classes=num_classes, device=device)
    steps, every = 12, 5

    # (1) the loop as a user runs it: no checkpoints, no patched methods;
    # synchronizing calls watched from the second step on.
    cfg, data, model = _resnet_fit_setup(epochs=1, steps=steps, **size)
    res, watch, launches, by_label, syncs = _fit_run(fb, cfg, data, model, device,
                                                     watch_syncs=True, track=False)
    want = {k: 16 * steps if on_card else 0 for k in launches}
    _check_fit_run("fit resnet50", res, launches, by_label, want, 1)
    fit_launches = dict(launches)
    stray = [s for s in syncs if s.split(":")[0] != "utils/hostsync.py"]
    if stray:
        raise AssertionError(f"synchronizing CUDA calls in the steady steps: {stray}")
    st = watch.stamps
    steady = [(st[j] - st[j - 1]) * 1e3 for j in range(1, steps)]
    # The loop against the bare step in turns (bare, fit, fit, bare), on
    # the same model and state: each turn one epoch of 12 steps, its step
    # walls the intervals between step ends on the host clock.
    turns = []
    state, tx = res.state, _fit_tx(cfg, data)  # the optimizer is stateless: its state is in state
    for kind in ("bare", "fit", "fit", "bare"):
        if kind == "fit":
            r, w, *_ = _fit_run(fb, cfg, data, model, device, track=False, state=state, tx=tx)
            state, st = r.state, w.stamps
        else:
            state, st = _bare_turn(model, tx, cfg, state, data, device)
        walls = [(st[j] - st[j - 1]) * 1e3 for j in range(1, len(st))]
        turns.append({"kind": kind, "step_ms_median": statistics.median(walls),
                      "step_ms_min": min(walls), "step_ms_max": max(walls)})
    line = {
        "model": "resnet50", "fused": True, "image_size": image_size, "batch": batch,
        "epochs": 1, "steps": steps, "history": res.history, "launches_by_op": launches,
        "launches_per_forward": sum(launches.values()) / steps,
        "sync_calls_by_line": {s: syncs.count(s) for s in sorted(set(syncs))},
        "steady_sync_calls": len(stray),
        "loop_step_ms_median": statistics.median(steady), "loop_step_ms_min": min(steady),
        "loop_step_ms_max": max(steady),
        "dispatch_p50_ms": res.perf["dispatch_p50_ms"],
        "dispatch_p99_ms": res.perf["dispatch_p99_ms"],
        "bare_train_step_ms": bare_step_ms if bare_step_ms is not None else "not measured",
        "turns": turns,
        "fit_step_ms_median_of_turns": statistics.median(
            t["step_ms_median"] for t in turns if t["kind"] == "fit"),
        "bare_step_ms_median_of_turns": statistics.median(
            t["step_ms_median"] for t in turns if t["kind"] == "bare"),
        "images_per_s": res.images_per_sec, "card": card,
    }
    print("fit " + json.dumps(line), flush=True)
    del res, watch, model, data
    if on_card:
        torch.cuda.empty_cache()

    # (2) 2 epochs with step checkpoints, every materialisation counted
    tmp = tempfile.mkdtemp(prefix="ddl-fit-")
    try:
        cfg, data, model = _resnet_fit_setup(epochs=2, steps=steps, model_dir=tmp, every=every,
                                             **size)
        res, watch, launches, by_label, _ = _fit_run(fb, cfg, data, model, device)
        saves = [5, 10, 12, 15, 20, 24]
        want = {k: 16 * 2 * steps if on_card else 0 for k in launches}
        _check_fit_run("fit resnet50 checkpointed", res, launches, by_label, want, 2,
                       len(saves))
        st = watch.stamps
        steps_ms = [(st[j] - st[j - 1]) * 1e3 for j in range(1, 2 * steps)]
        full = {k: v.detach().clone() for k, v in model.state_dict().items()}
        init = watch.init
        print("fitckpt " + json.dumps({
            "epochs": 2, "steps_per_epoch": steps, "checkpoint_every_steps": every,
            "saves_at": saves, "history": res.history, "host_syncs_by_label": by_label,
            "step_ms_median": statistics.median(steps_ms),
            "step_ms_of_saves": [steps_ms[s - 2] for s in saves if s >= 2],
            "run_s": res.perf["dispatch_total_s"] + res.perf["wait_total_s"],
            "images_per_s": res.images_per_sec, "card": card}), flush=True)
        del res, watch, model, data
        if on_card:
            torch.cuda.empty_cache()

        kept = faults.checkpoint_steps(tmp)
        if 15 not in kept:
            raise AssertionError(f"step 15's checkpoint is gone: {kept}")
        for s in kept:
            if s > 15:
                shutil.rmtree(os.path.join(tmp, str(s)))
        cfg, data, model = _resnet_fit_setup(epochs=2, steps=steps, model_dir=tmp, every=every,
                                             **size)
        res, _, launches, by_label, _ = _fit_run(fb, cfg, data, model, device)
        want = {k: 16 * (2 * steps - 15) if on_card else 0 for k in launches}
        _check_fit_run("fit resnet50 resumed", res, launches, by_label, want, 1, 2)
        got = model.state_dict()
        num = den = stats = 0.0
        equal = True
        for k, ref in full.items():
            equal = equal and torch.equal(got[k], ref)
            if "running" in k:
                stats = max(stats, ((got[k] - ref).abs().max() / ref.abs().max()).item())
                continue
            num += (got[k].double() - ref.double()).pow(2).sum().item()
            den += (ref.double() - init[k].double()).pow(2).sum().item()
        resume = {"resumed_from": 15, "epoch_images_first": res.history[0]["epoch_images"],
                  "param_rel": (num / den) ** 0.5, "running_stats_rel": stats,
                  "bits_equal": equal,
                  "limits": {"param_rel": FIT_RESUME_PARAM_REL,
                             "running_stats_rel": FIT_RESUME_STATS_REL}, "card": card}
        print("fitresume " + json.dumps(resume), flush=True)
        if not (resume["param_rel"] <= FIT_RESUME_PARAM_REL
                and stats <= FIT_RESUME_STATS_REL):
            raise AssertionError(f"the resumed run left the uninterrupted one: {resume}")
        del res, model, data, full, init, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()

    cfg, data, model = _resnet_fit_setup(epochs=1, steps=steps, accum_steps=2, **size)
    res, _, launches, by_label, _ = _fit_run(fb, cfg, data, model, device)
    want = {k: 16 * 2 * steps if on_card else 0 for k in launches}
    _check_fit_run("fit resnet50 ACCUM_STEPS=2", res, launches, by_label, want, 1)
    print("fitaccum " + json.dumps({
        "accum_steps": 2, "history": res.history, "launches_by_op": launches,
        "launches_per_dispatch": sum(launches.values()) / steps,
        "dispatch_p50_ms": res.perf["dispatch_p50_ms"], "images_per_s": res.images_per_sec,
        "card": card}), flush=True)
    del res, model, data
    if on_card:
        torch.cuda.empty_cache()
    agree = fused_vs_unfused_step(image_size=image_size, batch=batch, num_classes=num_classes,
                                  accum_steps=2, device=device)
    print("fitaccumagree " + json.dumps(dict(agree, card=card)), flush=True)
    if not agree["within_limits"]:
        raise AssertionError(f"fused and unfused accumulated steps disagree: {agree}")
    if on_card:
        torch.cuda.empty_cache()

    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import get_model

    lm = {"variant": "base", "batch": 8, "seq": 1024, "vocab": 32_000, **(lm_size or {})}
    lm_steps = 6
    cfg = TrainConfig(model=f"lm_{lm['variant']}", batch_size_per_device=lm["batch"],
                      num_classes=lm["vocab"], attn_impl="pallas",
                      fake_data_length=lm_steps * lm["batch"], epochs=1, log_every_steps=1)
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=lm["seq"],
                                 vocab_size=lm["vocab"], num_physical_batches=4, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=lm["seq"], device=device)
    res, _, launches, by_label, _ = _fit_run(fl, cfg, data, model, device)
    want = {k: model.depth * lm_steps if on_card else 0 for k in launches}
    _check_fit_run("fit lm pallas", res, launches, by_label, want, 1)
    print("fitlm " + json.dumps({
        "model": cfg.model, "attn_impl": "pallas", "seq_len": lm["seq"], "batch": lm["batch"],
        "steps": lm_steps, "history": res.history, "launches_by_op": launches,
        "host_syncs_by_label": by_label, "dispatch_p50_ms": res.perf["dispatch_p50_ms"],
        "tokens_per_s": res.images_per_sec * lm["seq"], "card": card}), flush=True)
    fit_launches.update(launches)
    return fit_launches


WARM_GAP_LIMIT = 0.0  # graphed against eager: bitwise (see warmup_phase)


def _warm_fit(cfg, data, model, device, profile_steps=False):
    """``training.loop.fit`` on a fresh seeded state (``AOT_WARMUP`` as
    ``cfg.aot_warmup`` says), with each step end stamped on the host
    clock. ``profile_steps`` runs a CUDA-only ``torch.profiler`` from the
    end of the first step (so the warm-up's eager steps stay out) to the
    end of the run, and counts the device's kernels by name: the
    launches of a captured step happen on replay, where no Python
    counter ticks. Returns the result, the steady step walls (ms), the
    peak memory (GB), the kernels by name a profiled step and the device
    ms a profiled step (on the card)."""
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        loop,
    )
    from distributeddeeplearning_tpu_torch.training.callbacks import Callback

    on_card = torch.device(device).type == "cuda"
    profiling = profile_steps and on_card

    class Profiled(Callback):
        """Profiles the steps after the first."""

        def __init__(self):
            self.prof, self.steps = None, 0

        def on_step_end(self, step, logs=None):
            if self.prof is None and profiling:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
            elif self.prof is not None:
                self.steps += 1

        def on_train_end(self, logs=None):
            if self.prof is not None:
                torch.cuda.synchronize()
                self.prof.stop()

    tx, _ = create_optimizer(cfg, data.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device)
    watch, prof = _fit_watch(False), Profiled()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    res = loop.fit(model, cfg, data, device=device, tx=tx, state=state,
                   callbacks=[watch, prof], add_default_logger=False)
    st = watch.stamps
    walls = [(st[j] - st[j - 1]) * 1e3 for j in range(1, len(st))]
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else "not measured"
    kernels, device_ms = {}, "not measured"
    if prof.prof is not None:
        events = [e for e in prof.prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = {e.key: e.count / prof.steps for e in events}
        device_ms = sum(e.device_time_total for e in events) / 1e3 / prof.steps
    return res, walls, peak, kernels, device_ms


def _state_gap(want, got):
    """Whether two state dicts are bitwise equal, and the largest gap of
    a parameter (relative to its largest value) if not."""
    equal = all(torch.equal(want[k], got[k]) for k in want)
    gap = max(((got[k].double() - want[k].double()).abs().max()
               / want[k].double().abs().max().clamp(min=1e-30)).item()
              for k in want if want[k].is_floating_point())
    return equal, gap


def _ours(kernels, marks):
    """The port's kernels among the profiler's, by name, launches a step."""
    return {k[:100]: v for k, v in kernels.items() if any(m in k for m in marks)}


def warmup_turns(name, make, device, marks, want_per_step, card, counter=None):
    """One model through ``fit`` with ``AOT_WARMUP=0`` and ``=1`` in turns
    (eager, graphed, graphed, eager), then one profiled run of each kind.
    ``make(aot)`` returns ``(cfg, data, model)``. Checks: the graphed
    runs captured graphs and took no eager step; the first graphed run's
    parameters and running statistics equal the first eager run's bit for
    bit (``WARM_GAP_LIMIT``: the same kernels on the same inputs, replayed
    in the same order); under replay the port's kernels named by
    ``marks`` launch ``want_per_step`` times a step (the profiler's count:
    a replay goes through no Python counter). Prints a ``warmup`` line
    and returns it."""
    on_card = torch.device(device).type == "cuda"
    turns, finals = [], {}
    for i, aot in enumerate((False, True, True, False)):
        cfg, data, model = make(aot)
        if counter is not None:
            counter.launches = 0
        res, walls, peak, _, _ = _warm_fit(cfg, data, model, device)
        turns.append({
            "kind": "graphed" if aot else "eager",
            "step_ms_median": statistics.median(walls), "step_ms_min": min(walls),
            "step_ms_max": max(walls), "peak_gb": peak,
            "compile_sec": res.perf.get("compile_sec"),
            "graphs_captured": res.perf.get("graphs_captured", 0),
            "eager_steps": res.perf.get("eager_steps"),
            "python_counter_launches": counter.launches if counter is not None else None,
            "dispatch_p50_ms": res.perf["dispatch_p50_ms"], "history": res.history})
        if aot and not (res.perf["graphs_captured"] >= on_card and res.perf["eager_steps"] == 0):
            raise AssertionError(f"warmup {name}: {res.perf}")
        if i < 2:
            finals[aot] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del res, model, data
        if on_card:
            torch.cuda.empty_cache()
    equal, gap = _state_gap(finals[False], finals[True])
    del finals
    profiled = {}
    for aot in (False, True):
        cfg, data, model = make(aot)
        res, walls, _, kernels, device_ms = _warm_fit(cfg, data, model, device, True)
        profiled["graphed" if aot else "eager"] = {
            "device_ms_per_step": device_ms, "ours_per_step": _ours(kernels, marks),
            "kernels_per_step": sum(kernels.values()) if kernels else "not measured"}
        del res, model, data
        if on_card:
            torch.cuda.empty_cache()
    for kind in ("eager", "graphed"):
        med = statistics.median(t["step_ms_median"] for t in turns if t["kind"] == kind)
        dev_ms = profiled[kind]["device_ms_per_step"]
        profiled[kind]["step_ms_median_of_turns"] = med
        profiled[kind]["busy_share"] = (dev_ms / med if on_card else "not measured")
    line = {"what": name, "turns": turns, "by_kind": profiled, "bitwise_equal": equal,
            "max_param_gap_rel": gap, "limit": WARM_GAP_LIMIT, "card": card}
    print("warmup " + json.dumps(line), flush=True)
    if not (equal or gap <= WARM_GAP_LIMIT):
        raise AssertionError(f"warmup {name}: graphed run left the eager one by {gap}")
    if on_card:
        got = profiled["graphed"]["ours_per_step"]
        for mark, want in want_per_step.items():
            n = sum(v for k, v in got.items() if mark in k)
            if n != want:
                raise AssertionError(f"warmup {name}: {mark} launched {n} times a replayed "
                                     f"step, want {want} ({got})")
    return line


def warmup_phase(card, device="cuda", image_size=224, batch=64, num_classes=1000,
                 lm_size=None, small=None):
    """``AOT_WARMUP`` (``training/warmup.py``: the step captured as CUDA
    graphs) through ``fit`` on the card:

    1. fused ResNet-50 (224 px, batch 64, 12 steps) and ``lm_base``
       ``pallas`` (T 1024, batch 8, 6 steps), each eager, graphed,
       graphed, eager (:func:`warmup_turns`): step medians, busy share,
       peak memory, ``compile_sec``, ``graphs_captured``; graphed against
       eager bit for bit; under replay 32 ``matmul_stats`` launches a
       step (16 a op) and 12 of each flash kernel;
    2. at a small size (``small``: 64 px, batch 8, 10 classes, 3 steps):
       EfficientNet-B0 with dropout, graphed against eager bit for bit
       (the masks follow ``(seed, step, rank)`` on replay: each replay
       reseeds the step's registered generator); ViT-B/16 with
       ``attn_impl="fused"`` and ``FUSED_DENSE_GRAD=1``, graphed
       against eager, rows 4a, 4b and 5 counted under replay (12
       ``packed_fwd``, 12 + 12 ``packed_bwd_*``, 49 ``dw_db``);
    3. the eval step captured beside the train step (``Engine.warmup``
       with ``eval_batch``; fused ResNet-50 at the small size): its
       replay against the eager eval, bit for bit;
    4. fused ResNet-50 with ``GRAD_ACCUM_STEPS=2`` (batch 32, 4 steps):
       two graphs (one a micro-step), graphed against eager bit for bit.

    ``device="cpu"`` with small sizes rehearses the flow (no graph, no
    profile). Returns the replayed launches a step by kernel family."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import (
        SyntheticImageDataset,
        SyntheticTokenDataset,
    )
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import fused_block as fb

    small = {"image_size": 64, "batch": 8, "num_classes": 10, **(small or {})}
    size = dict(image_size=image_size, batch=batch, num_classes=num_classes, device=device)
    replayed = {}

    def resnet(aot, steps=12, **kw):
        cfg, data, model = _resnet_fit_setup(epochs=1, steps=steps, **{**size, **kw})
        return cfg.replace(aot_warmup=aot), data, model

    line = warmup_turns("resnet50 fused", lambda aot: resnet(aot), device, ("matmul_stats",),
                        {"matmul_stats": 32}, card, fb)
    replayed["fused_block"] = line["by_kind"]["graphed"]["ours_per_step"]

    lm = {"variant": "base", "batch": 8, "seq": 1024, "vocab": 32_000, **(lm_size or {})}

    def lm_make(aot, steps=6):
        cfg = TrainConfig(model=f"lm_{lm['variant']}", batch_size_per_device=lm["batch"],
                          num_classes=lm["vocab"], attn_impl="pallas",
                          fake_data_length=steps * lm["batch"], epochs=1, log_every_steps=1,
                          aot_warmup=aot)
        data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                     global_batch_size=cfg.global_batch_size,
                                     seq_len=lm["seq"], vocab_size=lm["vocab"],
                                     num_physical_batches=4, seed=cfg.seed)
        model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=lm["seq"], device=device)
        return cfg, data, model

    line = warmup_turns(f"lm_{lm['variant']} pallas", lm_make, device, ("flash_",),
                        {"flash_fwd": 12, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}, card, fl)
    replayed["flash"] = line["by_kind"]["graphed"]["ours_per_step"]

    def small_make(model_name, aot, steps=3, **kw):
        cfg = TrainConfig(model=model_name, image_size=small["image_size"],
                          batch_size_per_device=small["batch"], num_classes=small["num_classes"],
                          fake_data_length=steps * small["batch"], epochs=1, log_every_steps=1,
                          aot_warmup=aot, **kw)
        data = SyntheticImageDataset(length=cfg.fake_data_length,
                                     global_batch_size=cfg.global_batch_size,
                                     image_size=cfg.image_size, num_classes=cfg.num_classes,
                                     num_physical_batches=steps, seed=cfg.seed)
        extra = {"fused_dense_grad": True} if model_name.startswith("vit_") else {}
        model = get_model(cfg.model, **cfg.model_kwargs(), device=device, **extra)
        return cfg, data, model

    on_card = torch.device(device).type == "cuda"
    for what, make, marks, want in (
            ("efficientnet_b0 dropout", lambda aot: small_make("efficientnet_b0", aot), (), {}),
            ("vit_b16 fused FUSED_DENSE_GRAD=1",
             lambda aot: small_make("vit_b16", aot, attn_impl="fused"), ("packed_", "dw_db"),
             {"packed_fwd": 12, "packed_bwd": 24, "dw_db": 49})):
        finals, lines = [], {}
        for aot in (False, True):
            cfg, data, model = make(aot)
            res, _, _, kernels, _ = _warm_fit(cfg, data, model, device, aot)
            finals.append({k: v.detach().clone() for k, v in model.state_dict().items()})
            lines["graphed" if aot else "eager"] = {
                "history": res.history, "graphs_captured": res.perf.get("graphs_captured", 0),
                "eager_steps": res.perf.get("eager_steps"), "ours_per_step": _ours(kernels, marks)}
            del res, model, data
        equal, gap = _state_gap(*finals)
        out = {"what": what, "size": small, "steps": 3, **lines, "bitwise_equal": equal,
               "max_param_gap_rel": gap, "limit": WARM_GAP_LIMIT, "card": card}
        print("warmup " + json.dumps(out), flush=True)
        if not (equal or gap <= WARM_GAP_LIMIT):
            raise AssertionError(f"warmup {what}: graphed run left the eager one by {gap}")
        if on_card:
            got = lines["graphed"]["ours_per_step"]
            for mark, n_want in want.items():
                n = sum(v for k, v in got.items() if mark in k)
                if n != n_want:
                    raise AssertionError(f"warmup {what}: {mark} launched {n} times a replayed "
                                         f"step, want {n_want} ({got})")
            if want:
                replayed["vit"] = got
            if lines["graphed"]["graphs_captured"] < 1:
                raise AssertionError(f"warmup {what}: no graph captured")

    # The eval step (warmup_engine's eval_batch): captured beside the
    # train step, its replay against the eager eval of the same batch.
    from distributeddeeplearning_tpu_torch.data import to_device
    from distributeddeeplearning_tpu_torch.training import create_optimizer
    from distributeddeeplearning_tpu_torch.training.engines import build_engine
    from distributeddeeplearning_tpu_torch.training.metrics import init_accumulator

    cfg, data, model = _resnet_fit_setup(epochs=1, steps=2, image_size=small["image_size"],
                                         batch=small["batch"],
                                         num_classes=small["num_classes"], device=device)
    eng = build_engine(model, cfg, create_optimizer(cfg, data.steps_per_epoch)[0],
                       device=device)
    eval_batch = to_device(next(iter(data.epoch(0))), device)
    eager = {k: v.clone() for k, v in eng.eval_step(eng.state, eval_batch).items()}
    info = eng.warmup(eval_batch, acc=init_accumulator(device), eval_batch=eval_batch)
    graphed = eng.eval_step(eng.state, eval_batch)
    equal = all(torch.equal(eager[k], graphed[k]) for k in eager)
    print("warmup " + json.dumps({
        "what": "resnet50 fused eval step", "size": small,
        "eager": {k: v.item() for k, v in eager.items()},
        "graphed": {k: v.item() for k, v in graphed.items()}, "bitwise_equal": equal,
        "graphs_captured": info["graphs_captured"],
        "eval_compile_sec": info["eval_compile_sec"], "card": card}), flush=True)
    if not equal or info["graphs_captured"] != 2 * on_card or eng.eval_step.eager_calls:
        raise AssertionError(f"warmup eval step: {eager} against {graphed}, {info}")
    del eng, model, data

    finals, lines = [], {}
    for aot in (False, True):
        cfg, data, model = resnet(aot, steps=4, batch=max(batch // 2, 1))
        cfg = cfg.replace(grad_accum_steps=2)
        res, _, _, _, _ = _warm_fit(cfg, data, model, device)
        finals.append({k: v.detach().clone() for k, v in model.state_dict().items()})
        lines["graphed" if aot else "eager"] = {
            "history": res.history, "graphs_captured": res.perf.get("graphs_captured", 0),
            "eager_steps": res.perf.get("eager_steps")}
        del res, model, data
    equal, gap = _state_gap(*finals)
    print("warmup " + json.dumps({
        "what": "resnet50 fused GRAD_ACCUM_STEPS=2", "batch": max(batch // 2, 1), "steps": 4,
        **lines, "bitwise_equal": equal, "max_param_gap_rel": gap, "limit": WARM_GAP_LIMIT,
        "card": card}), flush=True)
    if not (equal or gap <= WARM_GAP_LIMIT):
        raise AssertionError(f"warmup GRAD_ACCUM_STEPS=2: graphed run left the eager one by {gap}")
    if on_card and lines["graphed"]["graphs_captured"] != 2:
        raise AssertionError(f"warmup GRAD_ACCUM_STEPS=2: {lines['graphed']}")
    if on_card:
        torch.cuda.empty_cache()
    return replayed


FRONTEND_ENV = {"FAKE": "True", "FAKE_DATA_LENGTH": "256", "EPOCHS": "1", "BATCHSIZE": "32",
                "IMAGE_SIZE": "64", "NUM_CLASSES": "10", "VALIDATION": "true"}
FRONTENDS = (
    # (example module, extra env, a line its summary must print)
    ("imagenet_explicit", {}, "Total images/sec"),
    ("imagenet_keras", {"AOT_WARMUP": "1", "DDL_NUM_PROCESSES": "1", "DDL_PROCESS_ID": "0"},
     "throughput:"),
    ("imagenet_estimator", {"AOT_WARMUP": "1"}, "Total images/sec"),
    ("lm_synthetic", {"MODEL": "lm_tiny", "ATTN_IMPL": "pallas", "SEQ_LEN": "128",
                      "VOCAB": "1024", "BATCHSIZE": "8", "FAKE_DATA_LENGTH": "64"},
     "Total images/sec"),
)


def frontends_phase(card, platform=None, extra_env=None, timeout=600):
    """The four example modules of the port
    (``python -m distributeddeeplearning_tpu_torch.examples.<name>``) as
    a user runs them, in subprocesses started together on the card:
    ResNet-50 at 64 px (8 steps of 32 and a validation pass; the
    imagenet examples' model is fixed, as in ``examples/*_tpu.py``)
    through the explicit, Keras-style (``AOT_WARMUP=1``, and a one-rank
    NCCL world formed by ``maybe_initialize`` from ``DDL_COORDINATOR``,
    ``DDL_NUM_PROCESSES=1``, ``DDL_PROCESS_ID=0``) and estimator-style
    (``AOT_WARMUP=1``) front-ends, and ``lm_tiny`` with the flash kernels
    through the explicit one. Each must exit 0 and print its summary;
    the Keras one its rendezvous. ``platform="cpu"`` (``DDL_PLATFORM``)
    with ``extra_env`` rehearses the flow on the CPU."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if not k.startswith("DDL_")}
    base.update(FRONTEND_ENV, **(extra_env or {}))
    if platform:
        base["DDL_PLATFORM"] = platform
    procs = []
    for name, env, _ in FRONTENDS:
        env = dict(base, **env)
        if "DDL_NUM_PROCESSES" in env:
            env["DDL_COORDINATOR"] = f"127.0.0.1:{port}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"distributeddeeplearning_tpu_torch.examples.{name}"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    lines = {}
    for (name, _, mark), p, out in zip(FRONTENDS, procs, outs):
        summary = [x.split("] ", 1)[-1] for x in out.splitlines()
                   if any(m in x for m in ("images/sec", "Total", "throughput", "validation",
                                           "distributed initialized", "warmup(",
                                           "compile_sec", "graphs_captured"))]
        lines[name] = {"returncode": p.returncode, "summary": summary}
        if p.returncode != 0 or mark not in out:
            raise AssertionError(f"example {name} exited {p.returncode}: {out[-4000:]}")
    if "distributed initialized: process 0/1, backend " + ("gloo" if platform == "cpu"
                                                            else "nccl") not in outs[1]:
        raise AssertionError(f"imagenet_keras formed no one-rank world: {outs[1][-4000:]}")
    print("frontends " + json.dumps({"examples": lines, "wall_s": wall, "card": card}),
          flush=True)
    return lines


LAUNCH_STEPS = 6  # steps an epoch of the launched children, 2 epochs
LAUNCH_HANG_TIMEOUT = 20  # seconds of silence drill (b)'s watchdog allows
LAUNCH_ENV = {"FAKE": "True", "EPOCHS": "2", "BATCHSIZE": "64", "IMAGE_SIZE": "224",
              "NUM_CLASSES": "1000", "CHECKPOINT_EVERY_STEPS": "1", "CHECKPOINT_ASYNC": "0"}
# (drill, FAULT_PLAN, launcher flags, the supervisor's rc, the steps
# each attempt reports: a fault fires before its step's report)
LAUNCH_DRILLS = (
    ("kill", "kill:step=8", ["--hang-timeout", "60"], 0, [range(1, 8), range(9, 13)]),
    ("reference", None, ["--hang-timeout", "60"], 0, [range(1, 13)]),
    ("hang", "hang:step=3,secs=600",
     ["--hang-timeout", str(LAUNCH_HANG_TIMEOUT), "--env", "AOT_WARMUP=1"], 0,
     [range(1, 3), range(4, 13)]),
    ("nan", "nan:step=2", ["--hang-timeout", "60"], 121, [range(1, 7)]),
)


def launch_child():
    """One rank of a ``launch`` drill (``chip_smoke.py --launch-child``,
    started by ``python -m distributeddeeplearning_tpu_torch.launch``):
    the rendezvous from ``DDL_*`` (``parallel.distributed``), then fused
    ResNet-50 through ``training.loop.fit`` with the settings the
    launcher and the drill export (sizes, ``MODEL_DIR``,
    ``CHECKPOINT_*``, ``RESUME``, ``FAULT_PLAN``,
    ``COMPILATION_CACHE_DIR``, ``AOT_WARMUP``). It prints a line at each
    set-up stage (the hang watchdog counts output as liveness), a
    ``launchstep`` JSON line at each step end (the step, the fused-block
    launches since the last one, the library cache's hits and misses),
    and at the end the ``launchdone`` line; rank 0 saves the state dict
    it starts from to ``LAUNCH_CHILD_INIT`` (when set) and the final one
    to ``LAUNCH_CHILD_OUT``."""
    print("launchchild stage=imported", flush=True)
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.ops import fused_block as fb
    from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
    from distributeddeeplearning_tpu_torch.training import loop
    from distributeddeeplearning_tpu_torch.training.callbacks import Callback
    from distributeddeeplearning_tpu_torch.training.warmup import cache_stats

    distributed.maybe_initialize()
    device = distributed.default_device()
    print(f"launchchild stage=world rank={collectives.rank()} world={collectives.size()} "
          f"device={device}", flush=True)
    cfg = TrainConfig.from_env(model="resnet50", log_every_steps=1)
    data = SyntheticImageDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size,
                                 image_size=cfg.image_size, num_classes=cfg.num_classes,
                                 num_physical_batches=4, seed=cfg.seed)
    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      fused=True, device=device)
    print("launchchild stage=model", flush=True)

    class Steps(Callback):
        def __init__(self):
            self.last = dict(fb.launches_by_op)

        def on_train_begin(self, logs=None):
            init = os.environ.get("LAUNCH_CHILD_INIT")
            if init and collectives.is_master() and not os.path.exists(init):
                torch.save({k: v.detach().cpu()
                            for k, v in logs["state"].model.state_dict().items()}, init)

        def on_step_end(self, step, logs=None):
            now = dict(fb.launches_by_op)
            by_op = {k: now[k] - self.last[k] for k in now}
            self.last = now
            hits, misses = cache_stats()
            print("launchstep " + json.dumps({
                "step": int(logs["state"].step), "fused_block": sum(by_op.values()),
                "by_op": by_op, "cache_hits": hits, "cache_misses": misses}), flush=True)

    res = loop.fit(model, cfg, data, device=device, callbacks=[Steps()],
                   add_default_logger=False)
    hits, misses = cache_stats()
    print("launchdone " + json.dumps({
        "history": res.history, "cache_hits": hits, "cache_misses": misses,
        "step": int(res.state.step)}), flush=True)
    out = os.environ.get("LAUNCH_CHILD_OUT")
    if out and collectives.is_master():
        torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, out)
    distributed.shutdown()


def _launch_drill(name, plan, flags, root, tmp, env, timeout):
    """Start drill ``name``'s launcher: its run directory, model
    directory, final state file and library cache under ``tmp``."""
    d = os.path.join(tmp, name)
    os.makedirs(d)
    denv = dict(env, MODEL_DIR=os.path.join(d, "model"),
                LAUNCH_CHILD_OUT=os.path.join(d, "final.pt"),
                LAUNCH_CHILD_INIT=os.path.join(d, "init.pt"),
                COMPILATION_CACHE_DIR=os.path.join(d, "cache"))
    if plan:
        denv["FAULT_PLAN"] = plan
    argv = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.launch", "-n", "1",
            "--max-restarts", "1", "--restart-backoff", "0.1", "--obs-dir", os.path.join(d, "obs"), *flags,
            "--timeout", str(timeout), os.path.join(root, "chip_smoke.py"), "--launch-child"]
    log = open(os.path.join(d, "launcher.log"), "w")
    return subprocess.Popen(argv, cwd=root, env=denv, stdout=log, stderr=subprocess.STDOUT), log


def _attempts(out):
    """Per attempt (split at each ``launchchild stage=imported``): its
    ``launchstep`` records and ``launchdone`` record."""
    attempts = []
    for ln in out.splitlines():
        body = ln.split("] ", 1)[-1]
        if body.startswith("launchchild stage=imported"):
            attempts.append({"steps": [], "done": None})
        elif body.startswith("launchstep ") and attempts:
            attempts[-1]["steps"].append(json.loads(body[len("launchstep "):]))
        elif body.startswith("launchdone ") and attempts:
            attempts[-1]["done"] = json.loads(body[len("launchdone "):])
    return attempts


def _obs_records(obs, name):
    path = os.path.join(obs, name)
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(x) for x in fh if x.strip()]


def _flight_reason(path):
    """The ``reason`` a flight dump's first line records."""
    with open(path) as fh:
        return json.loads(fh.readline()).get("reason")


def _restart_seconds(merged):
    """Seconds from each failed attempt's exit (the supervisor's
    ``attempt_exit``) to the end of the next attempt's first step (its
    rank 0's first ``step`` span), from the merged events' wall times:
    what one restart costs, the children's start, kernel loads and
    resume included."""
    out = []
    for e in (r for r in merged if r.get("name") == "attempt_exit" and r.get("wall")):
        nxt = f"p0-r{e['labels']['attempt'] + 1}"
        firsts = [r["wall"] + r.get("dur", 0.0) for r in merged
                  if r.get("name") == "step" and r.get("p") == nxt and r.get("wall")]
        if firsts:
            out.append(min(firsts) - e["wall"])
    return out


def launch_phase(card, platform=None, extra_env=None, timeout=240):
    """The process tier on the card: four launchers of
    ``python -m distributeddeeplearning_tpu_torch.launch -n 1`` started
    together, each supervising a one-rank NCCL world (``DDL_*``) whose
    child (:func:`launch_child`) trains fused ResNet-50 (224 px, batch 64,
    bf16, 1000 classes) through ``fit`` for 2 epochs of
    ``LAUNCH_STEPS`` steps with ``CHECKPOINT_EVERY_STEPS=1`` and
    ``CHECKPOINT_ASYNC=0``, each drill with its own fresh
    ``COMPILATION_CACHE_DIR`` (``LAUNCH_DRILLS``):

    (a) ``kill``: ``FAULT_PLAN=kill:step=8``: the supervisor classifies
        ``signal_SIGKILL`` as retryable, attempt 1 runs with
        ``RESUME=True`` from step 8 (mid-epoch 2), loads the kernel
        library attempt 0 built (cache hits, no miss) and exits 0; its
        final parameters and running statistics within ``FIT_RESUME_*``
        of ``reference``'s (whether the bits are equal is printed);
        ``flight-p0.jsonl`` holds ``fault_kill``; the merged
        ``events.jsonl`` two ``attempt_start``;
    (b) ``hang``: ``FAULT_PLAN=hang:step=3,secs=600`` under a
        ``LAUNCH_HANG_TIMEOUT`` s watchdog with ``AOT_WARMUP=1``: the
        world is ended with 125 once, after the hang, relaunched and
        completes (rcs 125, 0): no attempt is killed while it builds the
        kernel (attempt 0 misses the fresh cache) or captures graphs;
    (c) ``nan``: ``FAULT_PLAN=nan:step=2``: the launcher returns 121 and
        does not restart.

    Every attempt must launch the fused-block kernels 32 times a step
    (a forward). Prints the ``launch`` line (with each restart's wall,
    ``restart_s``, and the hang's time to the watchdog) and returns the
    kill drill's launches by op over both attempts. ``platform="cpu"``
    (``DDL_PLATFORM``, a gloo world) with ``extra_env`` (small sizes)
    rehearses the flow on the CPU, where nothing is launched."""
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    on_card = platform != "cpu"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DDL_", "OBS_"))}
    env.update(LAUNCH_ENV, PYTHONPATH=root, **(extra_env or {}))
    env["FAKE_DATA_LENGTH"] = str(LAUNCH_STEPS * int(env["BATCHSIZE"]))
    if platform:
        env["DDL_PLATFORM"] = platform
    tmp = tempfile.mkdtemp(prefix="ddl-launch-")
    t0 = time.perf_counter()
    try:
        started = [(name, *_launch_drill(name, plan, flags, root, tmp, env, timeout))
                   for name, plan, flags, *_ in LAUNCH_DRILLS]
        rcs = {}
        for name, proc, log in started:
            try:
                rcs[name] = proc.wait(timeout=2 * timeout + 60)
            finally:
                if proc.poll() is None:
                    proc.kill()
                log.close()
        wall = time.perf_counter() - t0
        line, failed = {"wall_s": wall, "card": card, "hang_timeout_s": LAUNCH_HANG_TIMEOUT}, []
        finals, launches = {}, {}
        for name, plan, flags, want_rc, want_steps in LAUNCH_DRILLS:
            d = os.path.join(tmp, name)
            with open(os.path.join(d, "launcher.log")) as fh:
                out = fh.read()
            obs = os.path.join(d, "obs")
            sup = _obs_records(obs, "events-supervisor.jsonl")
            merged = _obs_records(obs, "events.jsonl")
            exits = [r["labels"] for r in sup if r.get("name") == "attempt_exit"]
            attempts = _attempts(out)
            per_step = [sorted({s["fused_block"] for s in a["steps"]}) for a in attempts]
            rec = {
                "fault_plan": plan, "rc": rcs[name],
                "attempt_rcs": [e["rc"] for e in exits],
                "attempt_reasons": [e["reason"] for e in exits],
                "world_sizes": [r["labels"]["world_size"] for r in sup
                                if r.get("name") == "attempt_start"],
                "merged_attempt_starts": sum(r.get("name") == "attempt_start" for r in merged),
                "restart_s": _restart_seconds(merged),
                "resumed_at": [[r["labels"]["epoch"], r["labels"]["step_in_epoch"]]
                               for r in merged if r.get("name") == "resume"],
                "steps_by_attempt": [[s["step"] for s in a["steps"]] for a in attempts],
                "fused_block_per_step_by_attempt": per_step,
                "cache_by_attempt": [[a["steps"][-1]["cache_hits"],
                                      a["steps"][-1]["cache_misses"]] if a["steps"] else None
                                     for a in attempts],
                "watchdog_fired": sum(len([r for r in _obs_records(obs, f)
                                           if r.get("name") == "watchdog_fired"])
                                      for f in os.listdir(obs) if f.startswith("events-launcher"))
                if os.path.isdir(obs) else 0,
                "flight": {f: _flight_reason(os.path.join(obs, f))
                           for f in sorted(os.listdir(obs)) if f.startswith("flight-")}
                if os.path.isdir(obs) else {},
            }
            hung = [r["wall"] for r in merged if r.get("name") == "fault_fired"
                    and (r.get("labels") or {}).get("kind") == "hang"]
            fired = [r["wall"] for r in merged if r.get("name") == "watchdog_fired"]
            if hung and fired:  # the watchdog's reaction, about its timeout
                rec["hang_to_watchdog_s"] = fired[0] - hung[0]
            if attempts and attempts[-1]["done"]:
                rec["history"] = attempts[-1]["done"]["history"]
            if name == "kill":  # the drill's launches by op, both attempts
                for a in attempts:
                    for st in a["steps"]:
                        for op, n in st["by_op"].items():
                            launches[op] = launches.get(op, 0) + n
                rec["launches_by_op"] = launches
            line[name] = rec
            # A forward's 32 a step; under AOT_WARMUP the first step's
            # report holds the warm-up steps and the capture (4 x 32) and
            # a replay ticks no counter.
            graphed = "AOT_WARMUP=1" in flags
            want_launches = ([0, 128] if graphed else [32]) if on_card else [0]
            if (rcs[name] != want_rc or len(exits) != len(want_steps)
                    or rec["steps_by_attempt"] != [list(r) for r in want_steps]
                    or any(p != want_launches for p in per_step)):
                failed.append(f"{name}: {rec}\n{out[-3000:]}")
            final = os.path.join(d, "final.pt")
            if os.path.exists(final):
                finals[name] = torch.load(final, weights_only=True)
        kill, hang, nan = line["kill"], line["hang"], line["nan"]

        def cache(rec, attempt):  # (hits, misses) an attempt reported last
            c = rec["cache_by_attempt"]
            return tuple(c[attempt]) if len(c) > attempt and c[attempt] else None

        # Attempt 1 resumes at step 8 = epoch 1 (0-based), 2 steps in.
        if not (kill["attempt_reasons"][:1] == ["signal_SIGKILL"]
                and kill["resumed_at"] == [[1, 2]]
                and kill["flight"].get("flight-p0.jsonl") == "fault_kill"
                and kill["merged_attempt_starts"] == 2
                and (not on_card or (cache(kill, 1) or (0, 1))[0] >= 1
                     and (cache(kill, 1) or (0, 1))[1] == 0)):
            failed.append(f"kill drill: {kill}")
        # One watchdog kill, after the hang: attempt 0 built the kernel
        # under the watchdog (a miss in its fresh cache) and captured.
        if not (hang["attempt_rcs"] == [125, 0] and hang["watchdog_fired"] == 1
                and hang["attempt_reasons"][:1] == ["world_hung"]
                and (not on_card or (cache(hang, 0) or (0, 0))[1] >= 1)):
            failed.append(f"hang drill: {hang}")
        if not (nan["attempt_rcs"] == [121] and nan["attempt_reasons"] == ["nonfinite_loss"]):
            failed.append(f"nan drill: {nan}")
        init = os.path.join(tmp, "reference", "init.pt")
        if "kill" in finals and "reference" in finals and os.path.exists(init):
            got, ref = finals["kill"], finals["reference"]
            init = torch.load(init, weights_only=True)
            num = den = stats = 0.0
            equal = True
            for k, r in ref.items():
                equal = equal and torch.equal(got[k], r)
                if "running" in k:
                    stats = max(stats, ((got[k] - r).abs().max() / r.abs().max()).item())
                    continue
                if not r.is_floating_point():
                    continue
                num += (got[k].double() - r.double()).pow(2).sum().item()
                den += (r.double() - init[k].double()).pow(2).sum().item()
            line["resume_gap"] = {
                "param_rel": (num / den) ** 0.5, "running_stats_rel": stats, "bits_equal": equal,
                "resumed_at_step": 8, "limits": {"param_rel": FIT_RESUME_PARAM_REL,
                                              "running_stats_rel": FIT_RESUME_STATS_REL}}
            if not ((num / den) ** 0.5 <= FIT_RESUME_PARAM_REL and stats <= FIT_RESUME_STATS_REL):
                failed.append(f"the resumed launch left the uninterrupted one: "
                              f"{line['resume_gap']}")
        else:
            failed.append(f"final states missing: {sorted(finals)}")
        print("launch " + json.dumps(line), flush=True)
        if failed:
            raise AssertionError("launch phase: " + "\n".join(failed))
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def trace_phase(fb, card, device="cuda", image_size=224, batch=64, num_classes=1000):
    """``TRACE_EVERY_N_EPOCHS=1`` (``obs/trace.py``) on a two-epoch
    ``fit`` of fused ResNet-50 (3 steps an epoch) with ``AOT_WARMUP=1``:
    ``trace-epoch0000`` and ``trace-epoch0001`` written, each a Chrome
    trace naming the hand-written kernels that ran (epoch 1: 32
    ``matmul_stats`` launches a replayed step; epoch 0 also holds the
    warm-up's eager steps), the two bus points an epoch, and one labelled
    ``trace_stop`` sync an epoch beside the loop's own."""
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.utils import hostsync

    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="ddl-trace-")
    old = {k: os.environ.get(k) for k in ("TRACE_EVERY_N_EPOCHS", "TRACE_DIR")}
    os.environ.update(TRACE_EVERY_N_EPOCHS="1", TRACE_DIR=tmp)
    try:
        cfg, data, model = _resnet_fit_setup(epochs=2, steps=3, image_size=image_size,
                                             batch=batch, num_classes=num_classes,
                                             device=device)
        hostsync.accountant().reset()
        res, _, _, _, _ = _warm_fit(cfg.replace(aot_warmup=True), data, model, device)
        by_label = dict(hostsync.accountant().by_label)
        points = [(r["name"], r["labels"]["epoch"]) for r in obs.get_bus().ring
                  if r["kind"] == "point" and r["name"] in ("trace_start", "trace_stop")][-4:]
        epochs = {}
        for d in sorted(os.listdir(tmp)):
            files = os.listdir(os.path.join(tmp, d))
            with open(os.path.join(tmp, d, files[0])) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            epochs[d] = {"file": files[0], "bytes": os.path.getsize(os.path.join(tmp, d,
                                                                               files[0])),
                         "kernels": len(kernels),
                         "ours": {k: kernels.count(k) for k in sorted(set(kernels))
                                  if "matmul_stats" in k}}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    line = {"epochs": epochs, "bus_points": points, "host_syncs_by_label": by_label,
            "graphs_captured": res.perf.get("graphs_captured"), "history": res.history,
            "card": card}
    print("trace " + json.dumps(line), flush=True)
    if sorted(epochs) != ["trace-epoch0000", "trace-epoch0001"]:
        raise AssertionError(f"trace: wrote {sorted(epochs)}")
    if points != [("trace_start", 0), ("trace_stop", 0), ("trace_start", 1),
                  ("trace_stop", 1)]:
        raise AssertionError(f"trace: bus points {points}")
    if on_card:
        if sum(epochs["trace-epoch0001"]["ours"].values()) != 32 * 3:
            raise AssertionError(f"trace: epoch 1 names {epochs['trace-epoch0001']['ours']} "
                                 f"launches of the fused kernels, want 96")
        if by_label != {"epoch_metrics": 2, "trace_stop": 2}:
            raise AssertionError(f"trace: host syncs {by_label}")
    return line


BENCH_RUNS = 3


# COMPILATION_CACHE_DIR None: a fresh directory that the protocol's runs share.
BENCH_PROTOCOLS = (("resnet50", {}),
                   ("lm_base", {"BENCH_MODEL": "lm_base", "COMPILATION_CACHE_DIR": None}))


def bench_phase(card, runs=BENCH_RUNS, protocols=BENCH_PROTOCOLS, timeout=600):
    """The port's bench harness as a user runs it, in a subprocess:
    ``runs`` runs of each protocol (the canonical ResNet-50 one and
    ``BENCH_MODEL=lm_base``; ``protocols`` pairs a label with its env).
    Each must exit 0 and print its record with ``detail.platform ==
    "cuda"`` (``"cpu"`` under ``BENCH_DEVICE=cpu``), the step captured
    (``detail.graphs_captured`` 1; 0 on the CPU) and ``host_sync_count
    == 1``; the ``benchwall`` line gives each protocol's median, min and
    max ``value``. A protocol with ``COMPILATION_CACHE_DIR`` shares a
    fresh library cache across its runs: the first run's capture builds
    what it loads (misses, no hit), each later one loads it (hits, no
    miss)."""
    import shutil
    import tempfile

    base = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_") and k != "COMPILATION_CACHE_DIR"}
    records = {}
    caches = []
    for label, extra in protocols:
        env = dict(base, **extra)
        if "COMPILATION_CACHE_DIR" in env and env["COMPILATION_CACHE_DIR"] is None:
            caches.append(tempfile.mkdtemp(prefix="ddl-cache-"))
            env["COMPILATION_CACHE_DIR"] = caches[-1]
        platform = "cpu" if env.get("BENCH_DEVICE") == "cpu" else "cuda"
        for i in range(runs):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "distributeddeeplearning_tpu_torch.bench"],
                                  env=env, capture_output=True, text=True, timeout=timeout)
            wall = time.perf_counter() - t0
            lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"bench {label} run {i} exited {proc.returncode}: "
                                     f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
            rec = json.loads(lines[-1])
            print("bench " + json.dumps(dict(rec, run=i, process_wall_s=wall, card=card)),
                  flush=True)
            detail = rec["detail"]
            if (detail["platform"] != platform or rec["host_sync_count"] != 1
                    or detail.get("graphs_captured") != (1 if platform == "cuda" else 0)):
                raise AssertionError(f"bench {label} record: {rec}")
            if "COMPILATION_CACHE_DIR" in env and platform == "cuda":
                hits, misses = (detail["persistent_cache_hits"],
                                detail["persistent_cache_misses"])
                if not ((hits == 0 and misses >= 1) if i == 0 else (hits >= 1 and misses == 0)):
                    raise AssertionError(f"bench {label} run {i}: library cache {hits} hit(s), "
                                         f"{misses} miss(es)")
            records.setdefault(rec["metric"], []).append(rec["value"])
    wall = {m: {"runs": len(v), "median": statistics.median(v), "min": min(v), "max": max(v),
                "spread_rel": (max(v) - min(v)) / statistics.median(v)}
            for m, v in records.items()}
    print("benchwall " + json.dumps(dict(wall, card=card)), flush=True)
    for d in caches:
        shutil.rmtree(d, ignore_errors=True)
    return wall


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


class _PhaseClock:
    """Seconds each phase took: ``start(name)`` closes the running
    phase (the build first) and opens ``name``."""

    def __init__(self, phases):
        self.t0 = self.last = time.perf_counter()
        self.phases, self.current, self.seconds = phases, "build", {}

    def start(self, name):
        now = time.perf_counter()
        if self.current == "build" or self.current in self.phases:
            self.seconds[self.current] = now - self.last
        self.current, self.last = name, now


PHASES = ("kernels", "serve", "servequant", "servespec", "train", "lmtrain", "vittrain",
          "effnettrain", "fit", "warmup", "frontends", "launch", "trace", "bench")


# A kernels-line entry -> (replayed family, what its kernel names hold,
# device kernels a call).
_REPLAYED = {
    "matmul_stats": ("fused_block", ", false>", 1),
    "bn_relu_matmul_stats": ("fused_block", ", true>", 1),
    "flash_fwd": ("flash", "flash_fwd", 1),
    "flash_bwd_dq": ("flash", "flash_bwd_dq", 1),
    "flash_bwd_dkv": ("flash", "flash_bwd_dkv", 1),
    "fused_qkv_fwd": ("vit", "packed_fwd", 1),
    "fused_qkv_bwd": ("vit", "packed_bwd", 2),
    "matmul_dw_db": ("vit", "dw_db", 1),
}


def _replayed_launches(name, replayed):
    """Calls a replayed step of a kernels-line entry, from the
    ``warmup`` phase's profiler counts (None for a kernel it does not
    replay)."""
    if name not in _REPLAYED or _REPLAYED[name][0] not in replayed:
        return None
    family, mark, per_call = _REPLAYED[name]
    return sum(v for k, v in replayed[family].items() if mark in k) / per_call


def _pd_entry(name, cases, store, launches):
    """A ``kernels`` line entry of the decode kernel for one storage
    dtype: its cases' largest error, the times and bound of its
    ``paged_decode_full`` case."""
    mine = [c for c in cases if c["shape"]["store"] == store]
    main_case = next(c for c in mine if c["case"].startswith("paged_decode_full"))
    return {
        "name": name, "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/paged_decode.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/paged_decode.py:175",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in mine),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"], "timed_case": "paged_decode_full",
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s (default: all)" % ",".join(PHASES))
    ap.add_argument("--launch-child", action="store_true",
                    help="run one rank of a launch drill (the launch phase starts it)")
    args = ap.parse_args(argv)
    if args.launch_child:
        launch_child()
        return 0
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        _die("CUDA is not available; this smoke runs the port on an NVIDIA GPU")
    try:
        from distributeddeeplearning_tpu_torch.ops import _build
        from distributeddeeplearning_tpu_torch.ops import depthwise as dwm
        from distributeddeeplearning_tpu_torch.ops import flash as fl
        from distributeddeeplearning_tpu_torch.ops import flash_packed as fp
        from distributeddeeplearning_tpu_torch.ops import fused_block as fb
        from distributeddeeplearning_tpu_torch.ops import fused_grads as fg
        from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    except ImportError as e:
        _die(f"the port is not importable from here ({e}); run from the repo root")

    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    clock = _PhaseClock(phases)
    # One nvcc per source, all started together.
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    names = ("paged_decode", "fused_block", "flash", "flash_packed", "fused_grads", "depthwise")
    with ThreadPoolExecutor(len(names)) as pool:
        secs = list(pool.map(timed_build, names))
    for name, sec in zip(names, secs):
        print(f"build {name} {sec:.1f}s", flush=True)
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):
                print(f"ptxas {name}:", line.strip(), flush=True)

    entries = []
    pd_cases = fb_cases = flash_cases = fp_cases = fg_cases = dw_cases = None
    clock.start("kernels")
    if "kernels" in phases:
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        pd_cases = kernel_phase(pd, flush)
        fb_cases = fused_block_phase(fb, flush)
        flash_cases = flash_phase(fl, flush)
        fp_cases = fp_phase(fp, fl, flush)
        fg_cases = fg_phase(fg, flush)
        dw_cases = dw_phase(dwm, flush)
        for c in pd_cases + fb_cases + flash_cases + fp_cases + fg_cases + dw_cases:
            print("case " + json.dumps(c), flush=True)
        del flush
        torch.cuda.empty_cache()

    clock.start("serve")
    if "serve" in phases:
        launches = serving_phase(pd, card)
        torch.cuda.empty_cache()
        if pd_cases is not None:
            entries.append(_pd_entry("paged_decode_attention", pd_cases, "bfloat16", launches))

    clock.start("servequant")
    if "servequant" in phases:
        by_store = quant_serving_phase(pd, card)
        torch.cuda.empty_cache()
        if pd_cases is not None:
            entries += [
                _pd_entry("paged_decode_attention_int8", pd_cases, "int8", by_store["int8"]),
                _pd_entry("paged_decode_attention_fp8", pd_cases, "float8_e4m3fn",
                          by_store["fp8"]),
            ]

    clock.start("servespec")
    if "servespec" in phases:
        spec_serving_phase(pd, card)
        torch.cuda.empty_cache()

    bare_step_ms = None
    clock.start("train")
    if "train" in phases:
        fused_line, state, step, batches = train_phase(fb, card, fused=True)
        bare_step_ms = fused_line["step_ms"]
        by_op = fused_line["launches_by_op"]
        profile_train(state, step, batches, card, fused_line["step_ms"],
                      "fused resnet50 train step, batch 64, 224 px, bf16",
                      ("matmul_stats",))
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

    clock.start("lmtrain")
    if "lmtrain" in phases:
        line, state, step, batches = lm_train_phase(fl, card, "pallas")
        by_op = line["launches_by_op"]
        profile_train(state, step, batches, card, line["step_ms"],
                      "lm_base train step (attn_impl=pallas), batch 8, T 1024, bf16",
                      ("flash_",))
        del state, step, batches
        torch.cuda.empty_cache()
        line, state, step, batches = lm_train_phase(fl, card, "xla")
        profile_train(state, step, batches, card, line["step_ms"],
                      "lm_base train step (attn_impl=xla), batch 8, T 1024, bf16", ("flash_",))
        del state, step, batches
        torch.cuda.empty_cache()
        agree = lm_pallas_vs_xla_step()
        print("lmagree " + json.dumps(dict(agree, card=card)), flush=True)
        if not agree["within_limits"]:
            raise AssertionError(f"pallas and xla LM steps disagree: {agree}")
        if flash_cases is not None:
            entries += [_flash_entry(op, flash_cases, by_op[op]) for op in FLASH_OPS]

    clock.start("vittrain")
    if "vittrain" in phases:
        line, state, step, batches = vit_train_phase(fp, fg, card, "fused", True)
        by_op = line["launches_by_op"]
        profile_train(state, step, batches, card, line["step_ms"],
                      "vit_b16 train step (attn_impl=fused, FUSED_DENSE_GRAD=1), batch 64, "
                      "224 px, bf16", ("packed_", "dw_db_"))
        del state, step, batches
        torch.cuda.empty_cache()
        line, state, step, batches = vit_train_phase(fp, fg, card, "xla", False)
        profile_train(state, step, batches, card, line["step_ms"],
                      "vit_b16 train step (attn_impl=xla, stock Dense), batch 64, 224 px, bf16",
                      ("packed_", "dw_db_"))
        del state, step, batches
        torch.cuda.empty_cache()
        agree = vit_fused_vs_xla_step()
        print("vitagree " + json.dumps(dict(agree, card=card)), flush=True)
        if not agree["within_limits"]:
            raise AssertionError(f"fused and xla ViT steps disagree: {agree}")
        auto = vit_auto_launches(fp)
        print("vitauto " + json.dumps({"fused_qkv_fwd_launches_per_forward": auto}), flush=True)
        if auto != 12:
            raise AssertionError(f"attn_impl='auto' launched fused_qkv_fwd {auto} times, want 12")
        torch.cuda.empty_cache()
        if fp_cases is not None:
            entries += [_fp_entry(op, fp_cases, by_op[op]) for op in FP_OPS]
            entries.append(_fg_entry(fg_cases, by_op["matmul_dw_db"]))

    clock.start("effnettrain")
    if "effnettrain" in phases:
        line, state, step, batches, ds, cfg = effnet_train_fit(dwm, card)
        profile_train(state, step, batches, card, line["step_ms"],
                      f"efficientnet_b4 train step, batch {line['batch']}, 380 px, bf16",
                      ("dwconv_",))
        del step, batches
        torch.cuda.empty_cache()
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        hooked = effnet_hook_pass(dwm, state.model, cfg, next(iter(ds.epoch(1))), flush)
        del state, ds, flush
        torch.cuda.empty_cache()
        print("effnetdw " + json.dumps(dict(hooked, card=card)), flush=True)
        if hooked["layers"] != 28:
            raise AssertionError(f"the hook pass found {hooked['layers']} depthwise layers "
                                 f"that the kernels support, want 28")
        if dw_cases is not None:
            by_op = hooked["launches_by_op"]
            entries += [
                _dw_entry("depthwise_conv", dw_cases,
                          by_op["depthwise_conv"] + by_op["depthwise_dgrad"],
                          {k: by_op[k] for k in ("depthwise_conv", "depthwise_dgrad")},
                          line["depthwise_launches"]),
                _dw_entry("depthwise_wgrad", dw_cases, by_op["depthwise_wgrad"],
                          {"depthwise_wgrad": by_op["depthwise_wgrad"]},
                          line["depthwise_launches"]),
            ]

    clock.start("fit")
    if "fit" in phases:
        fit_launches = fit_phase(fb, fl, card, bare_step_ms)
        for e in entries:  # the same kernels' launches on the loop's path
            if e["name"] in fit_launches:
                e["fit_launches"] = fit_launches[e["name"]]
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("warmup")
    if "warmup" in phases:
        replayed = warmup_phase(card)
        for e in entries:  # the same kernels' launches a step under graph replay
            n = _replayed_launches(e["name"], replayed)
            if n is not None:
                e["replay_launches_per_step"] = n
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("frontends")
    if "frontends" in phases:
        frontends_phase(card)

    clock.start("launch")
    if "launch" in phases:
        launched = launch_phase(card)
        for e in entries:  # the same kernels' launches in the launched drill
            if e["name"] in launched:
                e["launch_launches"] = launched[e["name"]]

    clock.start("trace")
    if "trace" in phases:
        trace_phase(fb, card)
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("bench")
    if "bench" in phases:
        bench_phase(card)

    clock.start("end")
    print("phases " + json.dumps(dict(clock.seconds, total=time.perf_counter() - clock.t0)),
          flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
