#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--phases kernels,serve,servequant,servespec,servegraph,train,
                                    lmtrain,vittrain,effnettrain,fit,warmup,frontends,
                                    launch,trace,bench,realdata,knobs,fleet,mesh,generic]

(all phases by default). Any failure raises and the script exits
non-zero.

1. Device: print ``nvidia-smi --query-gpu=name,power.limit`` and pin
   float32 matmuls and convolutions to full precision (no TF32).
2. Build every kernel from ``csrc/`` with ``nvcc`` for ``sm_90a``, one
   ``nvcc`` per source, all started together (the native IO tier's host
   library, ``csrc/ddl_native.cpp``, with them, by the host compiler);
   print ptxas's registers, spills and any wgmma serialization it
   reports. The ``kernels`` phase checks each library as soon as its
   build ends; every build ends before the next phase.
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
   with its last partial row left out of the sum must fail); and the
   generic routes (``generic_kernel_phase``): ``csrc/flash_generic.cu``
   at ``lm_base_train`` in f32 and ViT-H/16's head dim 80 in bf16, packed
   attention on that route at ViT-B/16 in f32, ``csrc/fused_block_f32.cu``
   at stage 1's two shapes, and decode at ``lm_large``'s head dim 96 on
   bf16, int8 and fp8 stores, each with a negative control.
4. ``serve``: full-width ``lm_base`` with seeded random weights behind
   ``Server.build`` (paged KV, fused kernel, 8 slots, the engine's
   program set captured as CUDA graphs at warmup) answers 16 requests.
   Checks: lengths and vocab range, the kernel ran exactly once per
   layer per forward (``launches == 12 × (prefills + decode_steps)``,
   counted as each captured member's launches times its replays), the
   program set closed, each greedy stream equals the same request served
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
7. ``servegraph``: the closed program sets at full width (bf16 and int8:
   9 members in 18 graphs, each sampling member with its greedy-only
   variant; ``SERVE_SPEC_K=4`` with the int8 self-draft: 19 in 29), their
   capture seconds and graph-pool bytes, no capture after warmup, every
   stream of the mix graphed equal bit for bit to the same members run
   uncaptured; bf16 eager then graphed (tick wall, device ms
   a tick, greedy and with half the slots sampling, busy share, TTFT,
   tokens/s); the decode kernel at 12 launches
   a tick and a prefill by the profiler's kernel names; the live plane
   and adaptive admission (``slo_breach`` → derate → ``slo_recover`` →
   restore), every request's trace reconstructed, the report's
   sections; and ``python -m distributeddeeplearning_tpu_torch.serve_bench``
   (continuous, paged, fused, ``lm_base``), its record printed. See
   :func:`servegraph_phase`.
8. ``train``: ResNet-50 (224 px, 1000 classes, batch 64, bf16) through
   the port's entry points on seeded synthetic data, ``fused=True``:
   3 warm-up and 20 timed steps, finite losses, and the fused kernels
   launched exactly 32 times per forward; a profile of 5 steady steps;
   the same protocol with ``fused=False`` (cuDNN 1x1 convs) as the
   yardstick of the whole step; and one fused against one unfused step
   from the same weights and batch, within stated limits.
9. ``lmtrain``: full-width ``lm_base`` (vocab 32,000, T = 1024, batch 8,
   bf16) through the same entry points on seeded synthetic tokens with
   ``attn_impl="pallas"``: 3 warm-up and 20 timed steps, finite losses,
   each flash kernel launched 12 times per forward (``flash_fwd``) or
   backward (``flash_bwd_dq``, ``flash_bwd_dkv``); a profile of 5 steady
   steps; the same protocol, and profile, with ``attn_impl="xla"`` (plain
   masked softmax) as the yardstick of the whole step; and one pallas against
   one xla step from the same weights and batch, within stated limits.
10. ``vittrain``: ViT-B/16 (224 px, 1000 classes, batch 64, bf16)
   through the same entry points on seeded synthetic images with
   ``attn_impl="fused"`` and fused dense grads: 3 warm-up and 20 timed
   steps, finite losses, exactly 12 launches per step of each packed
   attention kernel and 49 of ``matmul_dw_db``; a profile of 5 steady
   steps; the same protocol, and profile, with ``attn_impl="xla"`` and
   stock Dense layers as the yardstick; one flagged against one yardstick step from
   the same weights and batch, within stated limits; and ``"auto"``
   taking the packed kernel once per layer of a forward on the card.
11. ``effnettrain``: EfficientNet-B4 (380 px, 1000 classes, batch 64,
   bf16, drop-path and head dropout on) through the same entry points
   on seeded synthetic images: 3 warm-up and 10 timed steps, finite
   losses, no depthwise kernel launched by the model (its depthwise
   convs are cuDNN's, as JAX's are XLA's); a profile of 3 steady steps;
   then the hook pass: one training forward and backward with the 28
   stride-1 depthwise layers handed to the kernels by forward hooks
   (28 launches of each of forward, dgrad and wgrad), each layer's
   kernels held to the plain version and to cuDNN on its real x, weight
   and dy, and timed beside cuDNN (the ``effnetdw`` line). Batch 64 is
   halved, and the cut printed, if it does not fit the card.
12. ``fit``: the training loop (``training.loop.fit``) at full width:
   fused ResNet-50 for an epoch as a user runs it (32 launches a
   forward, one host sync, no synchronizing CUDA call in the steady
   steps but the epoch readback, under
   ``torch.cuda.set_sync_debug_mode("warn")``), then against the bare
   step (bare, then fit); 2 epochs with
   ``CHECKPOINT_EVERY_STEPS=5`` under ``hostsync.track()`` (one sync an
   epoch and one a save); a resume from the step-15 checkpoint held to
   the uninterrupted run (``FIT_RESUME_*``); an epoch with
   ``ACCUM_STEPS=2`` (64 launches a dispatch) and one fused against one
   unfused accumulated step; ``lm_base`` pallas through ``fit`` (12
   launches a pass of each flash kernel). See :func:`fit_phase`.
13. ``warmup``: ``AOT_WARMUP`` (the step captured as CUDA graphs)
   through ``fit``: fused ResNet-50 and ``lm_base`` ``pallas``, eager
   then graphed, each run's step medians, busy share, peak
   memory, ``compile_sec`` and ``graphs_captured``, graphed against
   eager bit for bit, the kernels counted under replay by the
   profiler's names; EfficientNet-B0 with dropout and ViT-B/16 flagged
   at 64 px, and ``GRAD_ACCUM_STEPS=2``, graphed against eager. See
   :func:`warmup_phase`.
14. ``frontends``: the four example modules
   (``distributeddeeplearning_tpu_torch.examples``) as subprocesses,
   one in a one-rank NCCL world from ``DDL_*``. See
   :func:`frontends_phase`.
15. ``launch``: the process tier: four launchers of ``python -m
   distributeddeeplearning_tpu_torch.launch -n 1 --max-restarts 1`` at
   once, each child training fused ResNet-50 (224 px, batch 64) through
   ``fit`` in a one-rank NCCL world: (a) ``FAULT_PLAN=kill:step=8``,
   restarted with resume (mid-epoch 2, library cache hits), held to
   (the fourth) an uninterrupted launch within ``FIT_RESUME_*``; (b) a
   hang ended by the watchdog (125) once, then completed; (c) a NaN
   loss, 121 and no restart; 32 fused-block launches a step in every
   attempt. See :func:`launch_phase`. (``--launch-child`` runs one rank
   of a drill.)
16. ``trace``: ``TRACE_EVERY_N_EPOCHS=1`` on a graphed two-epoch ``fit``:
   a Chrome trace an epoch naming the fused kernels. See
   :func:`trace_phase`.
17. ``bench``: ``python -m distributeddeeplearning_tpu_torch.bench`` in a
   subprocess, one run of the canonical ResNet-50 protocol and two
   of ``BENCH_MODEL=lm_base``, each timing the captured step: each
   record printed (``platform`` cuda, ``graphs_captured`` 1,
   ``host_sync_count`` 1; ``lm_base``'s runs share a fresh
   ``COMPILATION_CACHE_DIR``: misses in the first, hits after), and a
   ``benchwall`` line with each protocol's median, min and max.
18. ``realdata``: the real-data plane (``FAKE=False``, ``DATA_DIR``):
   the native IO library loaded (PIL and TensorFlow presence printed);
   fused ResNet-50 through ``fit`` from 1,280 seeded 224 px record
   shards (``PREFETCH_HOST_BATCHES=2``, ``AOT_WARMUP=1``, 20 steps) beside
   synthetic images at the same config, the ``data.*`` gauges, 32
   fused-block kernels a replayed step, and a resume from the step-10
   checkpoint's stream cursor bit for bit the uninterrupted run;
   ``stream_bench`` at full width (``lm_base`` pallas pretrain on token
   shards, restore bitwise, serve through the paged fused engine equal
   to ``generate``); the TFRecord tier's write, verified index and read;
   where PIL imports, ``real_data_bench`` prepare, host and e2e. See
   :func:`realdata_phase`.
19. ``knobs``: the model and optimizer knobs. ``moetrain``:
   ``lm_moe_base`` (8 experts, top-2, cf 1.25; T 1024, batch 8, bf16,
   ``pallas``, AdamW with ``DECOUPLED_WEIGHT_DECAY=0.1``) through
   ``fit``, REMAT off and on, eager then graphed: step walls, busy share,
   peak memory, graphed bit for bit against eager, the flash kernels a
   replayed step (12 each; the forward's 24 under REMAT), the wrappers'
   counts in the eager run, the load-balance loss and dropped share, and
   dense ``lm_base`` graphed at the same config for tokens/s.
   ``moeresume``: an AdamW ``fit`` resumed from a step-3 checkpoint, bit
   for bit. ``moeserve``: ``lm_moe_base`` behind the paged, fused,
   captured engine over the ``serve`` mix, greedy streams equal to
   ``generate``'s, then the decode tick's profile. ``vitknobs``: flagged
   ViT-B/16 with dropout 0.1 and REMAT, eager and graphed bit for bit,
   24 + 24 + 49 packed/dW+db kernels a replayed step, beside the run
   without the knobs. ``resnetknobs``: fused ResNet-50 with the s2d
   stem and bf16 statistics beside the default, 32 fused-block kernels a
   replayed step. Then the ``moe_audit`` twin's table at ``lm_small``.
   See :func:`knobs_phase`.
20. ``fleet``: the serving fleet (routes, drain, faults, disaggregated
   pools, the storm, the brownout ladder, the bench twins). See
   :func:`fleet_phase`.
21. ``mesh``: the mesh engines in one world of two ranks sharing the
   card (``MESH_SCENARIOS``: pjit ``tp`` and ``fsdp``, ring attention,
   GPipe and 1F1B, sync-BN ResNet-50, ViT-B/16, and ``lm_moe_base``
   with its experts over ``expert``, under ``tp`` and under ``fsdp``):
   each rank's f32 first step held to one rank's, the kernels' launches
   a step a rank, and under expert parallelism the replicated
   parameters bitwise equal across the expert ranks. See
   :func:`mesh_phase`.
22. ``generic``: the inputs the fast kernels refuse, at full width
   through the entry points: f32 ``lm_base`` ``pallas`` through ``fit``
   and its first step against ``xla``, f32 ViT-B/16 ``auto``, ViT-H/16
   bf16 ``pallas``, f32 fused ResNet-50 through ``fit`` and its first
   step against the unfused one, ``lm_large`` served (bf16 captured;
   f32 against ``generate``), each route's launches counted. See
   :func:`generic_phase`.
23. The ``kernels`` JSON line (every kernel whose phases ran; rows 1–5
   also with their launches a step under graph replay, and on the
   knobs' paths), then the contract's last line ``{"ok": true,
   "device": {...}}``.

Exits with code 2 and prints no result when CUDA is absent or the port
is not importable (the script on its own, outside the repository).
"""

from __future__ import annotations

import copy
import dataclasses
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
H100_F32_FLOP_S = 67e12  # float32 outside the tensor cores
N_TIMED = 25  # timed launches per measurement (median reported)
# The plain versions' yardstick times: up to 13 ms a launch (a B4
# depthwise layer), so 7 launches each, to keep the kernels phase short.
N_TIMED_PLAIN = 7
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


def time_ms(fn, flush: torch.Tensor, n: int = N_TIMED) -> float:
    """Median device time of ``fn`` over ``n`` launches, each with a
    cold L2 (a 256 MB write between launches, outside the timed span),
    as a serving step finds the next layer's K/V. Before each span the
    device spins for SPIN_CYCLES (``torch.cuda._sleep``), so the host has
    queued ``fn``'s work before the device reaches the first event: the
    span is device time even where the host's side of ``fn`` (autograd,
    a wrapper's checks) takes longer than the device's."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
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
            lambda: pd.fused_decode_attention_plain(q, k, v, q_pos, **kw), flush, N_TIMED_PLAIN),
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
            "plain_ms": time_ms(plain_fn, flush, N_TIMED_PLAIN) if plain else "not timed",
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
    # what the mesh phase's lm_base engines hand the kernel on a rank:
    # tp's 6 of 12 heads, fsdp's data shard of 4 rows, pp's microbatch of 2
    ("mesh_tp_heads", 8, 6, 1024, 1024, 64, True, 1.0),
    ("mesh_fsdp_rows", 4, 12, 1024, 1024, 64, True, 1.0),
    ("mesh_pp_micro", 2, 12, 1024, 1024, 64, True, 1.0),
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


def flash_terms(q, k, v, o, do, lse, delta, causal: bool, scale: float, amp: float = 2 ** 8):
    """Σ|terms| of each element of (O, dQ, dK, dV), f32 (see
    :func:`flash_limit`). For dQ and dK each |ds| carries ``amp`` times
    its f32 cancellation bound: ds = p·(dp − Δ)·scale, where dp (the
    kernel's MMA) and Δ (a torch sum) are d-term f32 sums taken in
    other orders than the plain version's, each off by at most
    d·2**-24·Σ|do_i·v_i| (Σ|do_i·o_i| for Δ); where dp ≈ Δ that is all
    of ds. Under the 2**-7 of the limit, ``amp`` 2**8 allows twice the
    bound (:func:`flash_f32_limit` passes its own)."""
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
    ads += p * (amp * scale * d * 2 ** -24) * cancel
    del cancel
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs()),
            torch.einsum("bhqk,bkhd->bqhd", ads, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ads, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


def _ratio(got, ref, lim) -> Tuple[float, float]:
    diff = (got.float() - ref.float()).abs()
    return diff.max().item(), (diff / lim.clamp(min=torch.finfo(torch.float32).tiny)).max().item()


def flash_bounds(b, h, tq, tk, d, causal, elem=2, peak=H100_BF16_FLOP_S):
    """Per kernel (bound_ms, bound_by, bytes, flops): bytes of each input
    read once and each output written once (``elem`` bytes an element);
    4/6/8 flops per (q, k) pair per head dim (QKᵀ and PV; + dOVᵀ and
    dS·K; + dSᵀQ and PᵀdO) at ``peak`` flop/s (bf16 tensor cores; f32:
    :data:`H100_F32_FLOP_S`)."""
    pairs = tq * (tq + 1) // 2 if causal else tq * tk
    nq, nk = b * tq * h * d, b * tk * h * d
    rows = b * h * tq
    work = {
        "flash_fwd": (elem * (2 * nq + 2 * nk) + 4 * rows, 4.0 * b * h * pairs * d),
        "flash_bwd_dq": (elem * (3 * nq + 2 * nk) + 8 * rows, 6.0 * b * h * pairs * d),
        "flash_bwd_dkv": (elem * (2 * nq + 4 * nk) + 8 * rows, 8.0 * b * h * pairs * d),
    }
    out = {}
    for op, (nbytes, flops) in work.items():
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
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
            "flash_fwd": time_ms(lambda: fl.flash_forward_plain(q, k, v, causal, sc), flush,
                                 N_TIMED_PLAIN),
            "flash_bwd_dq": time_ms(
                lambda: fl.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sc), flush,
                N_TIMED_PLAIN),
            "flash_bwd_dkv": time_ms(
                lambda: fl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sc), flush,
                N_TIMED_PLAIN),
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


def install_uncaptured(engine):
    """Install every member of ``engine``'s closed program set as its
    uncaptured functions (``ProgramSpec.uncaptured``: what the capture
    recorded, run eagerly), the twin of the graphed engine that
    bit-for-bit checks hold it to. Returns the programs it replaced; put
    them back with ``engine.programs.update``."""
    previous = dict(engine.programs)
    engine.programs.update({ps.name: ps.uncaptured() for ps in engine.program_specs()})
    return previous


def _reset_launches(pd):
    pd.launches = 0
    for key in pd.launches_by_store:
        pd.launches_by_store[key] = 0


def serve_mix(pd, card, env, label, params, solo=True, variant="base", device="cuda"):
    """Full-width lm_base behind ``Server.build`` (the ``SERVE_*`` env
    ``env``) answers the 16-request mix on its captured program set.
    Checks: lengths and vocab range; the kernel ran exactly once per
    layer per forward (``launches == 12 × (prefills + decode ticks)``,
    a speculative engine's verify ticks counted as decode ticks; the
    launches are the captured members' recorded launches times their
    replays); the program set closed (``compile_count ==
    programs_expected`` after the mix); the prefix-cache hit. With ``solo``,
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
    replayed0 = engine.replayed_launches_by_store()
    prefills0, steps0 = engine.prefill_execs, engine.decode_steps
    t0 = time.perf_counter()
    handles = [server.submit(r) for r in reqs]
    server.drain()
    _sync(device)
    wall = time.perf_counter() - t0
    # The captured members launch the kernel on replay, where the
    # wrapper's count does not tick: each member's launches recorded at
    # capture times its replays (held to the profiler's kernel names in
    # the servegraph phase), plus any launch made outside a graph.
    by_store = dict(pd.launches_by_store)
    for key, n in engine.replayed_launches_by_store().items():
        by_store[key] = by_store.get(key, 0) + n - replayed0.get(key, 0)
    launches = sum(by_store.values())
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
    if engine.compile_count != engine.programs_expected:
        raise AssertionError(f"{label}: compile_count {engine.compile_count} != "
                             f"programs_expected {engine.programs_expected}")
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
        "launches_replayed": launches - pd.launches,
        "launches_by_store": {k: n for k, n in by_store.items() if n},
        "compile_count": engine.compile_count,
        "programs_expected": engine.programs_expected,
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
            if engine.kv_dtype != "bf16" or engine.model.moe_experts:
                # an MoE model decodes without dropping tokens: so does a
                # forward through a cache
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


# The live-plane drill's objective: no real prefill meets it, so it
# breaches as soon as TTFTs land in its window.
SLO_BREACH_SPEC = "serve.ttft:p99 < 0.01ms over 2s"
# The serve harness in the smoke checks its protocol, not a serving
# number: its model is f32 (the script's), its prompts and max_len the
# longtail profile's (at most 96 + 32 tokens), not the full-width program
# set the servegraph tiers run.
SERVE_HARNESS_ENV = {"SERVE_KV_LAYOUT": "paged", "SERVE_DECODE_KERNEL": "fused",
                     "BENCH_MODEL": "lm_base", "SERVE_PROFILE": "longtail"}


def _fresh_prefix_cache(engine):
    """An empty prefix cache for an idle paged engine, so that two runs
    of the mix take the same prefix hits (and so the same shapes)."""
    from distributeddeeplearning_tpu_torch.serving import BlockAllocator

    if engine.active_slots:
        raise AssertionError("the engine still holds requests")
    engine.allocator = BlockAllocator(engine.num_blocks, engine.block_size)


def _serve_turn(server, reqs, device):
    """One run of the mix on ``server``'s engine as installed: its
    streams, tokens/s, TTFT p50/p99 and the median wall of the ticks
    that decoded without a prefill."""
    engine = server.engine
    _fresh_prefix_cache(engine)
    ticks = []
    t0 = time.perf_counter()
    handles = [server.submit(r) for r in reqs]
    while True:
        p0, d0 = engine.prefill_execs, server.stats["decode_steps"]
        ts = time.perf_counter()
        busy = server.step()
        if engine.prefill_execs == p0 and server.stats["decode_steps"] > d0:
            ticks.append((time.perf_counter() - ts) * 1e3)
        if not busy:
            break
    _sync(device)
    wall = time.perf_counter() - t0
    ttft = [h.ttft_s for h in handles]
    return [list(h.new_tokens) for h in handles], {
        "tokens_per_s": sum(len(h.new_tokens) for h in handles) / wall,
        "ttft_p50_ms": 1e3 * float(np.percentile(ttft, 50)),
        "ttft_p99_ms": 1e3 * float(np.percentile(ttft, 99)),
        "tick_wall_median_ms": statistics.median(ticks) if ticks else None,
        "decode_only_ticks": len(ticks), "wall_s": wall,
    }


def _graph_tier(label, env, params, variant, device):
    """A tier's engine behind ``Server.build``: its closed program set
    captured at warmup (count, seconds, pool bytes), the mix served on
    the graphs and then on the same members uncaptured, every stream
    equal bit for bit, and no capture after warmup. Returns ``(line,
    server)``."""
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.serving import ServeConfig, Server

    model = get_model(f"lm_{variant}", num_classes=VOCAB, device=device)
    server = Server.build(model, params, ServeConfig.from_env(env), device=device)
    engine = server.engine
    t0 = time.perf_counter()
    engine.warmup()
    _sync(device)
    warm_s = time.perf_counter() - t0
    line = {"programs_expected": engine.programs_expected,
            "compile_count": engine.compile_count,
            "graphs_captured": engine.graphs_captured, "compile_sec": engine.compile_sec,
            "warmup_s": warm_s, "graph_pool_bytes": engine.graph_pool_bytes}
    graphs = sum(len(ps.variants) for ps in engine.program_specs()) if device == "cuda" else 0
    if engine.compile_count != engine.programs_expected or engine.graphs_captured != graphs:
        raise AssertionError(f"{label}: {engine.compile_count} programs in "
                             f"{engine.graphs_captured} graphs captured, want "
                             f"{engine.programs_expected} in {graphs}")
    reqs = _request_mix()
    graphed, line["graphed"] = _serve_turn(server, reqs, device)
    captured = install_uncaptured(engine)
    eager, line["eager"] = _serve_turn(server, reqs, device)
    engine.programs.update(captured)
    diff = [i for i, (a, b) in enumerate(zip(graphed, eager)) if a != b]
    line["streams_bitwise_equal"] = not diff
    if diff:
        raise AssertionError(f"{label}: graphed streams differ from the uncaptured "
                             f"programs' in requests {diff}")
    if engine.compile_count != line["compile_count"]:
        raise AssertionError(f"{label}: captured again after warmup")
    return line, server


def _host_breakdown(server, vocab, ticks=20):
    """Where a graphed decode tick's wall goes, 8 slots at 512-token
    contexts, medians of ``ticks`` calls each: the scheduler's tick
    (``server.step``), the engine's (``decode_step``), the decode
    member's input fill (one host-to-device copy) and its replay with the
    readback alone (the device time plus launch and sync latency). The
    differences are the scheduler's and the engine's host work."""
    from distributeddeeplearning_tpu_torch.serving import Request

    engine = server.engine
    _fresh_prefix_cache(engine)
    rng = np.random.RandomState(3)
    handles = [server.submit(Request(prompt=rng.randint(0, vocab, size=512).astype(np.int32),
                                     max_new_tokens=4 * ticks))
               for _ in range(engine.num_slots)]
    for _ in range(engine.num_slots + 2):  # admit all, warm up
        server.step()
    torch.cuda.synchronize()

    def median_ms(fn):
        walls = []
        for _ in range(ticks):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    inputs = engine._inputs["decode"]
    values = {k: v.copy() for k, v in inputs.host.items()}
    program = engine.programs["decode"][True]  # greedy requests: the greedy-only graph
    line = {"server_step_ms": median_ms(server.step),
            "engine_decode_step_ms": median_ms(engine.decode_step),
            "inputs_load_ms": median_ms(lambda: inputs.load(**values)),
            "replay_readback_ms": median_ms(lambda: program()[0].cpu())}
    line["scheduler_host_ms"] = line["server_step_ms"] - line["engine_decode_step_ms"]
    line["engine_host_ms"] = (line["engine_decode_step_ms"] - line["inputs_load_ms"]
                              - line["replay_readback_ms"])
    for h in handles:  # the extra engine ticks left the handles behind
        h.cancel()
    server.step()
    return line


def _profile_prefill(engine, vocab, card, depth, attempts=3):
    """A 512-token prefill under ``torch.profiler`` on a free slot: the
    decode kernel's launches by kernel name (``depth``, 12 on lm_base)
    beside the captured member's replayed launches. The profiler can
    drop records (once, 9 of 12, in about 75 profiled prefills; 60 in a
    row saw 12), never invent them, so up to ``attempts`` prefills are
    profiled until one sees ``depth``; every attempt's count is
    reported."""
    from torch.profiler import ProfilerActivity, profile

    from distributeddeeplearning_tpu_torch.serving import ReqSpec

    rng = np.random.RandomState(2)
    seen, replayed_each = [], []
    while len(seen) < attempts and depth not in seen:
        _fresh_prefix_cache(engine)
        prompt = rng.randint(0, vocab, size=512).astype(np.int32)
        replayed = engine.replayed_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.prefill(0, ReqSpec(prompt=prompt, max_new_tokens=4))
            torch.cuda.synchronize()
        engine.release(0)
        seen.append(sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "decode_attention" in e.key))
        replayed_each.append(engine.replayed_launches() - replayed)
    return {"decode_attention_launches": seen[-1], "by_attempt": seen,
            "replayed_launches": replayed_each, "card": card}


def _live_plane_drill(server, reqs, obs_dir):
    """The mix on ``server``'s graphed engine under the live plane:
    ``OBS_DIR`` set, ``SLO_SPEC`` a TTFT objective no prefill meets,
    ``SERVE_ADMISSION_POLICY=adaptive`` (two prefills a tick, so the
    derate shows), the plane pumped in a thread as ``serve_bench``'s
    ``start_live_plane`` does. Recovery as the JAX live-plane test drives
    it: traffic stops, the short window drains, idle ticks let the
    policy read the recovered rollup. Checks the merged stream's
    ``slo_breach`` → ``serve.admission_derate`` → ``slo_recover`` →
    ``serve.admission_restore`` order and the prefills gauge, every
    request's critical path (no orphan, gap within tolerance) and the
    report's SLO and trace sections."""
    import threading

    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.obs import report, traces
    from distributeddeeplearning_tpu_torch.obs.rollup import LivePlane
    from distributeddeeplearning_tpu_torch.obs.slo import SloEngine
    from distributeddeeplearning_tpu_torch.serving import (
        AdaptiveAdmissionPolicy,
        ServeConfig,
        Server,
    )

    saved = {k: os.environ.get(k) for k in ("OBS_DIR", "SLO_SPEC")}
    os.environ.update(OBS_DIR=obs_dir, SLO_SPEC=SLO_BREACH_SPEC)
    bus = obs.configure(obs_dir, run_id="servegraph")
    stop = threading.Event()
    try:
        cfg = ServeConfig.from_env(dict(SERVE_ENV, SERVE_ADMISSION_POLICY="adaptive",
                                        SERVE_PREFILLS_PER_STEP="2"))
        policy = cfg.build_admission_policy()
        if not isinstance(policy, AdaptiveAdmissionPolicy):
            raise AssertionError(f"SERVE_ADMISSION_POLICY=adaptive built {policy!r}")
        drill = Server(server.engine, queue_depth=cfg.queue_depth,
                       prefills_per_step=cfg.prefills_per_step, admission_policy=policy)
        slo = SloEngine.from_env()
        plane = LivePlane(obs_dir, slo_engine=slo)

        def pump():
            while not stop.is_set():
                plane.poll(now=time.time())
                stop.wait(0.2)
            plane.poll(now=time.time())

        thread = threading.Thread(target=pump, daemon=True)
        thread.start()
        _fresh_prefix_cache(server.engine)
        handles = [drill.submit(r) for r in reqs]
        derated = False
        while drill.step():
            bus.flush()
            derated = derated or policy.derated
        deadline = time.time() + 20.0
        while (policy.derated or not derated) and time.time() < deadline:
            time.sleep(0.1)
            bus.flush()
            drill.step()  # an idle tick: the policy reads the latest rollup
            derated = derated or policy.derated
        stop.set()
        thread.join(timeout=10)
        bus.flush()
        if policy.derated or not derated:
            raise AssertionError(f"live plane: derated={derated} and still derated="
                                 f"{policy.derated} after the recovery window")
        merged = report.merge_run_dir(obs_dir)
        events = [json.loads(ln) for ln in open(merged)]
        seq = [e["name"] for e in events if e.get("kind") != "meta" and e["name"] in (
            "slo_breach", "serve.admission_derate", "slo_recover", "serve.admission_restore")]
        gauges = [e["value"] for e in events if e.get("kind") == "gauge"
                  and e["name"] == "serve.admission_prefills"]
        want = ["slo_breach", "serve.admission_derate", "slo_recover",
                "serve.admission_restore"]
        if seq != want or gauges != [1.0, 2.0]:
            raise AssertionError(f"live plane: sequence {seq}, prefills gauge {gauges}")
        recon = traces.reconstruct(events)
        mine = [r for r in recon["requests"] if r["req"] in {h.id for h in handles}]
        if (len(mine) != len(handles) or recon["orphan_count"]
                or any(not r["within_tolerance"] for r in mine)):
            raise AssertionError(
                f"traces: {len(mine)} of {len(handles)} requests reconstructed, "
                f"{recon['orphan_count']} orphans, gaps {[r['gap_s'] for r in mine]}")
        text = report.render(report.summarize(report.load([obs_dir])))
        for section in ("SLO (breach/recover timeline", "traces (request critical paths"):
            if section not in text:
                raise AssertionError(f"report lacks its {section!r} section")
        if drill.stats["completed"] != len(handles):
            raise AssertionError(f"live plane: {drill.stats['completed']} of "
                                 f"{len(handles)} requests completed")
        return {
            "sequence": seq, "admission_prefills_gauge": gauges,
            "requests_reconstructed": len(mine), "orphans": recon["orphan_count"],
            "gap_s_max": max(r["gap_s"] for r in mine),
            "gap_tolerance_s_min": min(r["gap_tolerance_s"] for r in mine),
            "report_sections": True,
        }
    finally:
        stop.set()
        obs.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_harness(card, env=None, timeout=600):
    """``python -m distributeddeeplearning_tpu_torch.serve_bench`` in a
    subprocess (continuous mode, paged, fused, ``lm_base``): its record
    line and exit code."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve_bench"],
        env=dict(os.environ, **(env or SERVE_HARNESS_ENV)), capture_output=True, text=True,
        timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    records = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"metric"')]
    if not records:
        raise AssertionError(f"serve_bench printed no record (rc {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    record = json.loads(records[-1])
    detail = record.get("detail", {})
    if "error" in record or detail.get("compiles_during_measure") != 0 or (
            detail.get("compile_count") != detail.get("programs_expected")):
        raise AssertionError(f"serve_bench: {records[-1]}\n{proc.stderr[-3000:]}")
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "record": record,
            "card": card}


def servegraph_phase(pd, card, variant="base", device="cuda", obs_dir=None,
                     harness_env=None):
    """``servegraph``: the engine's closed program set as CUDA graphs at
    full width (``lm_base``, ``SERVE_ENV``, the 16-request mix).

    * Per tier (bf16; int8 KV and weights; ``SERVE_SPEC_K=4`` with the
      int8 self-draft): ``compile_count == programs_expected`` (9, 9, 19
      with the default ladder), ``compile_sec``, the graph pool's bytes,
      every stream of the mix graphed equal bit for bit to the same
      members uncaptured, and no capture after warmup (``_graph_tier``).
    * bf16 eager then graphed (one turn each: the graphed mix is served
      again in ``fleet``): the mix's tick-wall
      median, TTFT p50/p99 and tokens/s, and two profiled steady decodes
      (``profile_decode``: device ms a tick, busy share; all slots greedy,
      the greedy-only graphs, then half sampling); where a graphed
      tick's host time goes (``_host_breakdown``); the decode
      kernel at 12 launches a tick and 12 a prefill by the profiler's
      kernel names, equal to the captured members' replayed launches.
    * The live plane and adaptive admission (``_live_plane_drill``),
      the trace reconstruction and the report's sections.
    * The serve harness (``_run_harness``), its record printed.

    Prints the ``servegraph`` line; on the CPU (``device="cpu"``) the
    programs are uncaptured and the device numbers are not measured."""
    import shutil
    import tempfile

    on_card = device == "cuda"
    params = _lm_params(variant, device)
    depth = 12 if variant == "base" else None
    line = {"card": card}
    bf16, server = _graph_tier("servegraph_bf16", SERVE_ENV, params, variant, device)
    engine = server.engine
    reqs = _request_mix()
    programs = dict(engine.programs)
    turns = []
    for mode in ("eager", "graphed"):
        if mode == "eager":
            install_uncaptured(engine)
        else:
            engine.programs.update(programs)
        _, turn = _serve_turn(server, reqs, device)
        if on_card:
            # All-greedy slots replay the greedy-only variants; half the
            # slots sampling (the mix's top-k 40) replay the sampler's.
            for key, sampled in (("profile", False), ("profile_sampled", True)):
                _fresh_prefix_cache(engine)
                turn[key] = profile_decode(server, VOCAB, card, sampled=sampled,
                                           label=f"servegraph_{mode}_{key}")
        turns.append(dict(turn, mode=mode))
    engine.programs.update(programs)
    bf16["turns"] = turns
    if on_card:
        bf16["host_breakdown"] = _host_breakdown(server, VOCAB)
        prefill = _profile_prefill(engine, VOCAB, card, depth)
        ticks = [t[key] for t in turns if t["mode"] == "graphed"
                 for key in ("profile", "profile_sampled")]
        per_tick = {t["decode_attention_launches_per_tick"] for t in ticks}
        replay_tick = {t["replayed_launches_per_tick"] for t in ticks}
        # Profiler records can be lost, not invented: each profile reads
        # at most depth, and one of them exactly depth; the replayed
        # counts are exact.
        if (depth not in per_tick or max(per_tick) > depth or replay_tick != {depth}
                or prefill["decode_attention_launches"] != depth
                or set(prefill["replayed_launches"]) != {depth}):
            raise AssertionError(f"servegraph: B6 under replay, {per_tick} / {replay_tick} "
                                 f"a tick and {prefill} a prefill, want {depth}")
        bf16["b6_under_replay"] = {"per_tick_by_name": sorted(per_tick),
                                   "per_prefill_by_name": prefill["by_attempt"]}
    line["bf16"] = bf16
    obs_dir = obs_dir or tempfile.mkdtemp(prefix="servegraph-obs-")
    # 16 new tokens a request: the trace plane credits a request 1/active
    # of each shared tick, so most of its decode wall is unattributed, and
    # short streams keep that gap under the tolerance's 0.5 s floor.
    drill_reqs = [dataclasses.replace(r, max_new_tokens=16) for r in reqs]
    try:
        line["live_plane"] = _live_plane_drill(server, drill_reqs, obs_dir)
    finally:
        shutil.rmtree(obs_dir, ignore_errors=True)
    del server, engine, programs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    for tier, env in (("int8", dict(SERVE_ENV, SERVE_KV_DTYPE="int8",
                                    SERVE_WEIGHT_DTYPE="int8")),
                      ("spec_int8", dict(SERVE_ENV, SERVE_SPEC_K="4",
                                         SERVE_SPEC_DRAFT="int8"))):
        line[tier], server = _graph_tier(f"servegraph_{tier}", env, params, variant, device)
        del server
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    want = {"bf16": 9, "int8": 9, "spec_int8": 19} if variant == "base" else {}
    for tier, n in want.items():
        if line[tier]["compile_count"] != n:
            raise AssertionError(f"servegraph {tier}: {line[tier]['compile_count']} "
                                 f"programs, want {n}")
        # Decode, 8 prefills and the verify in two variants each.
        if on_card and line[tier]["graphs_captured"] != {"spec_int8": 29}.get(tier, 18):
            raise AssertionError(f"servegraph {tier}: {line[tier]['graphs_captured']} "
                                 "graphs")
    if on_card or harness_env is not None:
        line["harness"] = _run_harness(card, harness_env)
        print("serve_bench " + json.dumps(line["harness"]["record"]), flush=True)
    print("servegraph " + json.dumps(line), flush=True)
    return line


def profile_decode(server, vocab, card, ticks=8, label="profile", sampled=False):
    """Where a decode tick's time goes: 8 slots at 512-token contexts,
    greedy (or with ``sampled`` every other slot at temperature 0.8 and
    top-k 40, the mix's sampled requests), ``ticks`` steady decode ticks
    under ``torch.profiler``. Reports the
    tick's host wall, the device time summed over kernels (busy share =
    device / wall), the decode kernel's family (its ``decode_attention``
    instantiations) per tick, by time and by kernel count, the launches
    the engine's captured members replayed per tick, and the top kernels
    by device time. Prints the ``label`` line and returns it."""
    from torch.profiler import ProfilerActivity, profile

    from distributeddeeplearning_tpu_torch.serving import Request

    engine = server.engine
    rng = np.random.RandomState(1)
    for i in range(engine.num_slots):
        knobs = dict(temperature=0.8, top_k=40, rng=i) if sampled and i % 2 else {}
        server.submit(Request(
            prompt=rng.randint(0, vocab, size=512).astype(np.int32),
            max_new_tokens=3 * ticks, **knobs))
    for _ in range(engine.num_slots + 2):  # admit all, warm up
        server.step()
    torch.cuda.synchronize()
    sampled_slots = int((engine._temps > 0).sum())
    replayed = engine.replayed_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            server.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    replayed = engine.replayed_launches() - replayed
    server.drain()
    # Device-side kernel and copy events only: CPU ops carry the device
    # time of what they launched too, and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.device_time_total for e in kernels) / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:6]
    family = [e for e in kernels if "decode_attention" in e.key]
    family_ms = sum(e.device_time_total for e in family) / 1e3 / ticks
    line = {
        "tick_wall_ms": wall_ms,
        "decode_attention_ms_per_tick": family_ms if device_ms > 0 else "not measured",
        "decode_attention_launches_per_tick": sum(e.count for e in family) / ticks,
        "replayed_launches_per_tick": replayed / ticks,
        "tick_device_ms": device_ms if device_ms > 0 else "not measured",
        "device_busy_share": device_ms / wall_ms if device_ms > 0 else "not measured",
        "device_ops_per_tick": sum(e.count for e in kernels) / ticks,
        "top_kernels_ms_per_tick": {
            e.key[:80]: e.device_time_total / 1e3 / ticks for e in top},
        "slots": engine.num_slots, "context": 512, "sampled_slots": sampled_slots,
        "card": card,
    }
    print(label + " " + json.dumps(line), flush=True)
    return line


# Fused vs unfused bf16 step from the same weights and batch: the limits
# (derived in fused_vs_unfused_step's docstring).
AGREE_LOSS_REL = 1e-3
AGREE_UPDATE_REL = 0.35
AGREE_STATS_REL = 1e-2


def _train_setup(fused, *, depth=50, image_size=224, batch=64, num_classes=1000,
                 num_physical_batches=4, state_dict=None, accum_steps=1, device="cuda",
                 compute_dtype="bfloat16"):
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
                      accum_steps=accum_steps, compute_dtype=compute_dtype)
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
                          accum_steps=1, device="cuda", compute_dtype="bfloat16", limits=None):
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
    0.05-0.15, running statistics ~2e-3. ``compute_dtype`` and ``limits``
    (``loss_rel``, ``update_rel``, ``running_stats_rel``) run the same
    comparison in another dtype (``F32_RESNET_LIMITS``)."""
    from distributeddeeplearning_tpu_torch.models import convert

    lim = limits or {"loss_rel": AGREE_LOSS_REL, "update_rel": AGREE_UPDATE_REL,
                     "running_stats_rel": AGREE_STATS_REL}

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
            accum_steps=accum_steps, device=device, compute_dtype=compute_dtype)
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
    res = {"accum_steps": accum_steps, "dtype": compute_dtype,
           "loss_fused": lf, "loss_unfused": lu, "loss_rel": abs(lf - lu) / abs(lu),
           "update_rel_by_group": gaps, "running_stats_rel": stats, "limits": lim}
    res["within_limits"] = (res["loss_rel"] <= lim["loss_rel"]
                            and max(gaps.values()) <= lim["update_rel"]
                            and stats <= lim["running_stats_rel"])
    return res


def moe_remat_vs_xla_step(variant="tiny", experts=4, batch=8, seq=256, vocab=32_000,
                          device="cuda"):
    """One bf16 SGD step of ``lm_moe_<variant>`` with ``pallas`` attention
    and REMAT against one with ``xla`` attention and stored activations,
    from the same seeded weights on the same batch, within
    :func:`lm_pallas_vs_xla_step`'s limits (``LM_AGREE_*``): the two
    attentions round at other places, REMAT recomputes the same ops."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    sd = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(42),
                             seq, experts)
    ds = SyntheticTokenDataset(length=batch, global_batch_size=batch, seq_len=seq,
                               vocab_size=vocab, num_physical_batches=1)
    tokens, labels = next(iter(ds.epoch(0)))
    out = {}
    for impl, remat in (("xla", False), ("pallas", True)):
        cfg = TrainConfig(model=f"lm_moe_{variant}", batch_size_per_device=batch,
                          num_classes=vocab, attn_impl=impl, remat=remat, moe_experts=experts)
        model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=seq, device=device)
        tx, _ = create_optimizer(cfg, 10)
        state = create_train_state(model, cfg, tx, device=device, state_dict=sd)
        state, m = make_train_step(model, tx, cfg, device=device)(state, (tokens, labels))
        out[impl] = (float(m["loss"]), {k: v.detach().clone() for k, v in
                                        model.state_dict().items()})
    (lx, px), (lp, pp) = out["xla"], out["pallas"]
    sums = {}
    for k, ref in sd.items():
        dx, dp = px[k].double() - ref.double(), pp[k].double() - ref.double()
        n, d = sums.get(_lm_group(k), (0.0, 0.0))
        sums[_lm_group(k)] = (n + (dp - dx).pow(2).sum().item(), d + dx.pow(2).sum().item())
    gaps = {grp: (n / d) ** 0.5 for grp, (n, d) in sums.items()}
    res = {"loss_xla": lx, "loss_pallas_remat": lp, "loss_rel": abs(lp - lx) / abs(lx),
           "update_rel_by_group": gaps,
           "limits": {"loss_rel": LM_AGREE_LOSS_REL, "update_rel": LM_AGREE_UPDATE_REL}}
    res["within_limits"] = (res["loss_rel"] <= LM_AGREE_LOSS_REL
                            and max(gaps.values()) <= LM_AGREE_UPDATE_REL)
    return res


# The pallas and xla lm_base steps from the same weights and batch: the
# limits (derived in lm_pallas_vs_xla_step's docstring).
LM_AGREE_LOSS_REL = 1e-3
LM_AGREE_UPDATE_REL = 0.1
LM_AGREE_LOGITS_REL = 2 ** -4


def _lm_setup(attn_impl, *, variant="base", batch=8, seq=1024, vocab=32_000,
              num_physical_batches=4, state_dict=None, device="cuda",
              compute_dtype="bfloat16"):
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
                      attn_impl=attn_impl, compute_dtype=compute_dtype)
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
    if ".moe." in name:
        return "moe"
    if "embed" in name:
        return "embeddings"
    return "layernorm"


def lm_pallas_vs_xla_step(variant="base", batch=8, seq=1024, vocab=32_000, device="cuda",
                          compute_dtype="bfloat16", limits=None):
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
    update gaps 0.01-0.05, logits 0.01-0.03. ``compute_dtype`` and
    ``limits`` (``loss_rel``, ``update_rel``, ``logits_rel``) run the same
    comparison in another dtype (``F32_LM_LIMITS``)."""
    from distributeddeeplearning_tpu_torch.models import convert

    lim = limits or {"loss_rel": LM_AGREE_LOSS_REL, "update_rel": LM_AGREE_UPDATE_REL,
                     "logits_rel": LM_AGREE_LOGITS_REL}

    sd = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(42),
                             seq)
    out = {}
    for impl in ("xla", "pallas"):
        cfg, ds, model, state, step = _lm_setup(
            impl, variant=variant, batch=batch, seq=seq, vocab=vocab,
            num_physical_batches=1, state_dict=sd, device=device, compute_dtype=compute_dtype)
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
    res = {"dtype": compute_dtype, "loss_pallas": lp, "loss_xla": lx,
           "loss_rel": abs(lp - lx) / abs(lx), "update_rel_by_group": gaps,
           "logits_rel": logits_rel, "limits": lim}
    res["within_limits"] = (res["loss_rel"] <= lim["loss_rel"]
                            and max(gaps.values()) <= lim["update_rel"]
                            and logits_rel <= lim["logits_rel"])
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


def fp_bounds(b, t, h, d, causal, elem=2, peak=H100_BF16_FLOP_S):
    """Per kernel (bound_ms, bound_by, bytes, flops): qkv in and O out
    (forward); qkv, O and dO in and dqkv out (backward), ``elem`` bytes
    an element; 4 and 10 flops per (query, key) pair per head dim (QKᵀ
    and PV; QKᵀ again, dOVᵀ, dS·K, dSᵀQ and PᵀdO) at ``peak`` flop/s."""
    pairs = t * (t + 1) // 2 if causal else t * t
    row = b * t * h * d * elem  # bytes of one [B, T, H·d] tensor
    work = {"fused_qkv_fwd": (4 * row, 4.0 * b * h * pairs * d),
            "fused_qkv_bwd": (8 * row, 10.0 * b * h * pairs * d)}
    out = {}
    for op, (nbytes, flops) in work.items():
        tb, to = nbytes / H100_BYTES_PER_S * 1e3, flops / peak * 1e3
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
                lambda: fp.fused_qkv_attention_plain(qkv, h, causal, sc), flush, N_TIMED_PLAIN),
            "fused_qkv_bwd": time_ms(
                lambda: fp.fused_qkv_attention_backward_plain(qkv, out, do, h, causal, sc),
                flush, N_TIMED_PLAIN),
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
        "plain_ms": time_ms(lambda: fg.matmul_dw_db_plain(x, gr), flush, N_TIMED_PLAIN),
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
               num_classes=1000, num_physical_batches=4, state_dict=None, device="cuda",
               compute_dtype="bfloat16"):
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
                      batch_size_per_device=batch, num_classes=num_classes, attn_impl=attn_impl,
                      compute_dtype=compute_dtype)
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
                "conv": time_ms(lambda: dwm.stencil_plain(x, taps), flush, N_TIMED_PLAIN),
                "dgrad": time_ms(lambda: dwm.stencil_plain(dy, taps, flip=True), flush,
                                 N_TIMED_PLAIN),
                "wgrad": time_ms(lambda: dwm.wgrad_plain(x, dy, k), flush, N_TIMED_PLAIN)}
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
                      image_size=224, batch=64, num_classes=1000, device="cuda",
                      compute_dtype="bfloat16", **model_kw):
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model

    cfg = TrainConfig(model="resnet50", image_size=image_size, batch_size_per_device=batch,
                      num_classes=num_classes, fake_data_length=steps * batch, epochs=epochs,
                      accum_steps=accum_steps, model_dir=model_dir,
                      checkpoint_every_steps=every, log_every_steps=1,
                      compute_dtype=compute_dtype)
    data = SyntheticImageDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size,
                                 image_size=image_size, num_classes=num_classes,
                                 num_physical_batches=4, seed=cfg.seed)
    model = get_model(cfg.model, num_classes=num_classes, dtype=cfg.compute_dtype, fused=True,
                      device=device, **model_kw)
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
    # The loop against the bare step, one turn each, on the same model and
    # state: each turn one epoch of 12 steps, its step walls the intervals
    # between step ends on the host clock.
    turns = []
    state, tx = res.state, _fit_tx(cfg, data)  # the optimizer is stateless: its state is in state
    for kind in ("bare", "fit"):
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


def _replayed_ok(n, want, steps):
    """Whether ``n``, a kernel's profiled launches a replayed step or
    tick (a mean over ``steps``), reads ``want``. A replayed graph
    launches the same kernels every replay, so the profile's total is
    ``want·steps``, or one short: the profiler lost one kernel record
    in a profile in three full smokes on one H100 (119 of 120 flash
    forwards in 5 steps, 95 of 96 decode kernels in 8 ticks, 607 of 608
    fused-block kernels in 19 steps), never more than one. A kernel
    missing from the graph misses on every replay."""
    total = round(n * steps)
    return want * steps - 1 <= total <= want * steps


def _check_launches(what, got, want, steps):
    """``got``, the port's kernels a replayed step by name (a mean over
    ``steps`` profiled steps), against ``want`` (mark -> launches a
    step), by :func:`_replayed_ok`."""
    for mark, n_want in want.items():
        n = sum(v for k, v in got.items() if mark in k)
        if not _replayed_ok(n, n_want, steps):
            raise AssertionError(f"{what}: {mark} launched {n} times a replayed step "
                                 f"({steps} profiled), want {n_want} ({got})")


def _warm_fit(cfg, data, model, device, profile_steps=False):
    """``training.loop.fit`` on a fresh seeded state (``AOT_WARMUP`` as
    ``cfg.aot_warmup`` says), with each step end stamped on the host
    clock. ``profile_steps`` runs a CUDA-only ``torch.profiler`` from the
    end of the first step (so the warm-up's eager steps stay out) to the
    end of the run, and counts the device's kernels by name: the
    launches of a captured step happen on replay, where no Python
    counter ticks. Returns the result, the steady step walls (ms), the
    peak memory (GB), the kernels by name a profiled step and the device
    ms a profiled step (on the card). Profiled,
    ``res.perf["synced_step_ms"]`` is the profiled steps' mean wall
    between a synchronize after the first step and one at the end (a
    graphed loop's host runs ahead of the device, so its step stamps
    time the enqueue)."""
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
            self.prof, self.steps, self.span = None, 0, None

        def on_step_end(self, step, logs=None):
            if self.prof is None and profiling:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.span = time.perf_counter()
            elif self.prof is not None:
                self.steps += 1

        def on_train_end(self, logs=None):
            if self.prof is not None:
                torch.cuda.synchronize()
                self.span = time.perf_counter() - self.span
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
        res.perf["synced_step_ms"] = prof.span * 1e3 / prof.steps
        res.perf["profiled_steps"] = prof.steps
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
    """One model through ``fit`` with ``AOT_WARMUP=0`` and ``=1`` (eager,
    then graphed: one turn each, as the graphed steps are timed again in
    ``bench`` and ``knobs``), then one profiled run of each kind.
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
    for aot in (False, True):
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
            "kernels_per_step": sum(kernels.values()) if kernels else "not measured",
            "profiled_steps": res.perf.get("profiled_steps")}
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
        _check_launches(f"warmup {name}", profiled["graphed"]["ours_per_step"],
                        want_per_step, profiled["graphed"]["profiled_steps"])
    return line


def warmup_phase(card, device="cuda", image_size=224, batch=64, num_classes=1000,
                 lm_size=None, small=None):
    """``AOT_WARMUP`` (``training/warmup.py``: the step captured as CUDA
    graphs) through ``fit`` on the card:

    1. fused ResNet-50 (224 px, batch 64, 12 steps) and ``lm_base``
       ``pallas`` (T 1024, batch 8, 6 steps), each eager then graphed
       (:func:`warmup_turns`): step medians, busy share,
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
                "eager_steps": res.perf.get("eager_steps"), "ours_per_step": _ours(kernels, marks),
                "profiled_steps": res.perf.get("profiled_steps")}
            del res, model, data
        equal, gap = _state_gap(*finals)
        out = {"what": what, "size": small, "steps": 3, **lines, "bitwise_equal": equal,
               "max_param_gap_rel": gap, "limit": WARM_GAP_LIMIT, "card": card}
        print("warmup " + json.dumps(out), flush=True)
        if not (equal or gap <= WARM_GAP_LIMIT):
            raise AssertionError(f"warmup {what}: graphed run left the eager one by {gap}")
        if on_card:
            got = lines["graphed"]["ours_per_step"]
            _check_launches(f"warmup {what}", got, want, lines["graphed"]["profiled_steps"])
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


BENCH_RUNS = 2  # enough for the cache check (misses, then hits); a third run cost 39 s


# COMPILATION_CACHE_DIR None: a fresh directory that the protocol's runs
# share. A third item sets the protocol's runs: ResNet-50 takes one (its
# step runs at full width in train, fit and warmup; a second run cost 25 s).
BENCH_PROTOCOLS = (("resnet50", {}, 1),
                   ("lm_base", {"BENCH_MODEL": "lm_base", "COMPILATION_CACHE_DIR": None}))


def bench_phase(card, runs=BENCH_RUNS, protocols=BENCH_PROTOCOLS, timeout=600):
    """The port's bench harness as a user runs it, in a subprocess:
    ``runs`` runs of each protocol (the canonical ResNet-50 one and
    ``BENCH_MODEL=lm_base``; ``protocols`` pairs a label with its env,
    and a third item overrides ``runs``).
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
    for label, extra, *own_runs in protocols:
        env = dict(base, **extra)
        if "COMPILATION_CACHE_DIR" in env and env["COMPILATION_CACHE_DIR"] is None:
            caches.append(tempfile.mkdtemp(prefix="ddl-cache-"))
            env["COMPILATION_CACHE_DIR"] = caches[-1]
        platform = "cpu" if env.get("BENCH_DEVICE") == "cpu" else "cuda"
        for i in range(own_runs[0] if own_runs else runs):
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


REALDATA_RECORDS = 1280  # 20 steps of batch 64: 1,280 x 224 x 224 x 3 bytes (193 MB)
REALDATA_EVERY = 5  # step checkpoints (with the data cursor) at 5, 10, 15, 20
REALDATA_RESUME_AT = 10
# The token-stream leg: stream_bench at full width (lm_base pallas, T
# 1024, batch 8, vocab 32,000; 6 steps, a checkpoint every 2).
REALDATA_STREAM_ENV = {"BENCH_MODEL": "lm_base", "STREAM_RECORDS": "48",
                       "STREAM_SEQ_LEN": "1024", "STREAM_VOCAB": "32000",
                       "STREAM_SHARD_RECORDS": "16", "STREAM_SHUFFLE_BLOCK": "16",
                       "STREAM_BATCH": "8", "STREAM_EPOCHS": "1",
                       "SERVE_KV_LAYOUT": "paged", "SERVE_DECODE_KERNEL": "fused"}
REALDATA_TFRECORDS = (4, 512, 110_000)  # shards, records a shard, payload bytes (JPEG-sized)


def _importable(name):
    """Whether ``import name`` works here (checked before any use)."""
    import importlib.util

    return importlib.util.find_spec(name) is not None


def _write_record_stream(root, records, image_size, num_classes, chunk=128):
    """Seeded uint8 records through the port's writer, in chunks (no
    full-size int64 temporary)."""
    from distributeddeeplearning_tpu_torch.data.stream import write_record_shards

    def chunks():
        for i in range(0, records, chunk):
            rng = np.random.RandomState(1000 + i)
            n = min(chunk, records - i)
            yield (rng.randint(0, 256, size=(n, image_size, image_size, 3), dtype=np.uint8),
                   rng.randint(0, num_classes, size=(n,)).astype(np.int32))

    t0 = time.perf_counter()
    meta = write_record_shards(root, chunks(), image_size=image_size, num_classes=num_classes,
                               shard_records=256)
    return meta, time.perf_counter() - t0


def _realdata_fit(cfg, data, device, profile=False):
    """``fit`` of fused ResNet-50 on ``data`` as ``_warm_fit`` runs it,
    with the ``data.*`` gauges of the run read back off the event bus.
    Returns ``(res, walls, kernels, device_ms, gauges, model)``."""
    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.models import get_model

    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      fused=True, device=device)
    t0 = time.monotonic()
    res, walls, _, kernels, device_ms = _warm_fit(cfg, data, model, device, profile)
    gauges = {}
    for e in list(obs.get_bus().ring):  # the bus fit configured; spans carry "dur"
        if e["t"] >= t0 and e["name"].startswith("data."):
            gauges.setdefault(e["name"], []).append(e.get("value", e.get("dur")))
    summary = {k: {"n": len(v), "median": statistics.median(v), "max": max(v)}
               for k, v in gauges.items() if v and None not in v}
    return res, walls, kernels, device_ms, summary, model


def realdata_phase(fb, fl, pd, card, harness=None, device="cuda",
                   image_size=224, batch=64, num_classes=1000, records=REALDATA_RECORDS,
                   stream_env=None, tfrecords=REALDATA_TFRECORDS, jpeg_images=256):
    """The real-data plane on the card (``FAKE=False``, ``DATA_DIR``):

    0. the native IO library (``csrc/ddl_native.cpp``, built with the
       kernels) must be loaded: its pure-Python path may not stand in;
       whether PIL and TensorFlow import here is printed first.
    1. ``records`` seeded uint8 records (224 px) written with the port's
       ``write_record_shards``; fused ResNet-50 (batch 64) trained on
       them through ``fit`` with ``DATA_DIR``, ``PREFETCH_HOST_BATCHES=2``,
       ``INPUT_STAGING=uint8`` and ``AOT_WARMUP=1`` (one epoch of 20
       steps, the steps after the first profiled: busy share, the
       fused-block kernels a replayed step, want 32); then the same
       config on synthetic images (the step wall beside it, in the same
       call); the ``data.*`` gauges of the run. Then with
       ``CHECKPOINT_EVERY_STEPS=5``: each manifest carries the stream
       cursor, and a resume from step 10 (the newer keys deleted) seeks
       the stream and ends bit for bit equal to the uninterrupted run.
    2. ``python -m distributeddeeplearning_tpu_torch.stream_bench`` in
       process at full width (``REALDATA_STREAM_ENV``: ``lm_base``
       pallas, T 1024, batch 8): pretrain on token shards, checkpoint
       with the cursor, restore from disk (bitwise), serve through the
       paged ``fused`` engine (f32, as the JAX script's); the streams
       must equal ``generate``. Flash launches (rows 3a-3c) and decode
       launches (row 6a) counted; tokens/s beside ``harness`` (the bench
       phase's ``lm_base`` median, when it ran).
    3. The TFRecord tier: ``tfrecords`` = (shards, records, payload
       bytes) written, indexed with CRCs verified and read back by the
       native library (MB/s each), every payload checked; the native
       reader's framing and indexing (``NativeTFRecordImageNetDataset``
       over the set, no decode).
    4. Where PIL imports: ``real_data_bench`` ``prepare`` (``jpeg_images``
       JPEGs), ``host`` (ImageFolder on threads and on processes, the
       native TFRecord reader, tf.data where TensorFlow imports) and
       ``e2e`` (ImageFolder into fused ResNet-50).

    Returns the kernels' Python-counted launches by op and by run
    (``fit``, ``resume``, ``e2e``, ``stream``, ``serve``), each counted
    from 0 just before that run; a graphed run counts only its eager
    warm-up (the replayed count is the profiler's, on the ``realdata``
    line).
    ``device="cpu"`` with small sizes rehearses the flow."""
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch import faults, native
    from distributeddeeplearning_tpu_torch import stream_bench
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset, make_dataset

    on_card = torch.device(device).type == "cuda"
    has_pil, has_tf = _importable("PIL"), _importable("tensorflow")
    pil_version = __import__("PIL").__version__ if has_pil else None
    print("realdata libs " + json.dumps({
        "PIL": pil_version or False, "tensorflow": has_tf,
        "native_io": native.native_available(),
        "native_io_error": native.load_error(), "card": card}), flush=True)
    if not native.native_available():
        raise AssertionError(f"the native IO library did not load: {native.load_error()}")
    if not has_pil:
        print("realdata jpeg: not run (PIL not installed)", flush=True)
    launches = {}

    def reset():
        for mod in (fb, fl):
            mod.launches = 0
            for k in mod.launches_by_op:
                mod.launches_by_op[k] = 0
        _reset_launches(pd)

    def tally(run, *mods):
        for mod in mods:
            for k, v in mod.launches_by_op.items():
                launches.setdefault(k, {})[run] = v

    tmp = tempfile.mkdtemp(prefix="ddl-realdata-")
    try:
        # (1) record stream -> fused ResNet-50
        root = os.path.join(tmp, "records")
        meta, write_s = _write_record_stream(root, records, image_size, num_classes)
        steps = records // batch
        base = TrainConfig.from_env({
            "FAKE": "False", "DATA_DIR": root, "PREFETCH_HOST_BATCHES": "2",
            "AOT_WARMUP": "1", "INPUT_STAGING": "uint8", "MODEL": "resnet50",
            "IMAGE_SIZE": str(image_size), "BATCHSIZE": str(batch),
            "NUM_CLASSES": str(num_classes), "EPOCHS": "1"}).replace(log_every_steps=1)
        reset()
        data = make_dataset(base)
        if type(data).__name__ != "RecordStreamDataset" or data.steps_per_epoch != steps:
            raise AssertionError(f"make_dataset gave {type(data).__name__}, "
                                 f"{data.steps_per_epoch} steps")
        res, walls, kernels, device_ms, gauges, model = _realdata_fit(base, data, device, True)
        tally("fit", fb)
        real_launches = dict(fb.launches_by_op)
        replayed = sum(v for k, v in kernels.items() if "matmul_stats" in k)
        history = [{k: h[k] for k in ("loss", "accuracy", "epoch_images")}
                   for h in res.history]
        losses = [h["loss"] for h in res.history]
        if not (all(np.isfinite(losses)) and res.history[0]["epoch_images"] == records):
            raise AssertionError(f"realdata fit: {res.history}")
        if on_card and (not _replayed_ok(replayed, 32, res.perf["profiled_steps"])
                        or not res.perf.get("graphs_captured")
                        or min(real_launches.values()) == 0):
            raise AssertionError(f"realdata fit: {replayed} fused-block kernels a replayed "
                                 f"step (want 32), perf {res.perf}, launches {real_launches}")
        if "data.wait" not in gauges or "data.bytes_per_s" not in gauges:
            raise AssertionError(f"realdata fit: no data.* gauges ({sorted(gauges)})")
        del model, res
        synth = SyntheticImageDataset(length=records, global_batch_size=batch,
                                      image_size=image_size, num_classes=num_classes,
                                      num_physical_batches=4, seed=base.seed, dtype=np.uint8)
        swalls = _realdata_fit(base.replace(fake=True), synth, device)[1]
        if on_card:
            torch.cuda.empty_cache()
        step_ms = statistics.median(walls)
        line = {
            "model": "resnet50", "fused": True, "image_size": image_size, "batch": batch,
            "records": records, "stream_bytes": meta["total_records"] * (
                image_size * image_size * 3 + 4), "write_s": write_s, "steps": steps,
            "input_staging": "uint8", "prefetch_host_batches": 2, "aot_warmup": True,
            "history": history,
            "step_ms_median": step_ms, "step_ms_min": min(walls), "step_ms_max": max(walls),
            "synthetic_step_ms_median": statistics.median(swalls),
            "device_ms_per_step": device_ms,
            "busy_share": device_ms / step_ms if on_card else "not measured",
            "replayed_fused_block_per_step": replayed if on_card else "not measured",
            "launches_by_op": real_launches, "data_gauges": gauges,
            "images_per_s": batch * 1e3 / step_ms, "card": card}
        print("realdata " + json.dumps(line), flush=True)

        # the cursor resume: checkpoints every 5 steps, rolled back to 10
        ck = os.path.join(tmp, "ckpt")
        cfg = base.replace(model_dir=ck, checkpoint_every_steps=REALDATA_EVERY)
        full, *_, model = _realdata_fit(cfg, make_dataset(cfg), device)
        want = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del full, model
        kept = faults.checkpoint_steps(ck)
        cursors = {}
        for s in kept:
            with open(os.path.join(ck, str(s), "manifest.json")) as f:
                cursors[s] = json.load(f).get("data_cursor")
        if REALDATA_RESUME_AT not in kept or any(
                (c or {}).get("offset") != s % steps for s, c in cursors.items()):
            raise AssertionError(f"realdata checkpoints {kept}: cursors {cursors}")
        for s in kept:
            if s > REALDATA_RESUME_AT:
                shutil.rmtree(os.path.join(ck, str(s)))
        reset()
        resumed, _, _, _, rgauges, model = _realdata_fit(cfg, make_dataset(cfg), device)
        tally("resume", fb)
        equal, gap = _state_gap(want, model.state_dict())
        resume = {"resumed_from": REALDATA_RESUME_AT, "kept": kept,
                  "cursor": cursors[REALDATA_RESUME_AT],
                  "epoch_images": resumed.history[0]["epoch_images"],
                  "resume_skip_batches": rgauges.get("data.resume_skip_batches"),
                  "launches_by_op": dict(fb.launches_by_op),
                  "bitwise_equal": equal, "max_param_gap_rel": gap, "card": card}
        print("realdataresume " + json.dumps(resume), flush=True)
        if not equal or resume["epoch_images"] != (steps - REALDATA_RESUME_AT) * batch:
            raise AssertionError(f"the cursor resume left the uninterrupted run: {resume}")
        del resumed, model, want
        shutil.rmtree(root, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()

        # (2) token stream -> lm_base, restored and served
        env = dict(REALDATA_STREAM_ENV, **(stream_env or {}),
                   BENCH_DEVICE=torch.device(device).type)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset()
        try:
            record, ok, info = stream_bench.run()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        tally("stream", fl)
        flash = dict(fl.launches_by_op)
        decode = info["serve_launches_by_store"]
        d = record["detail"]
        lm_line = {"record": record, "flash_launches_by_op": flash,
                   "decode_launches_by_store": decode,
                   "harness_lm_tokens_per_s": harness if harness is not None
                   else "not measured", "card": card}
        print("realdatastream " + json.dumps(lm_line), flush=True)
        if not ok or not (d["restore_roundtrip"] and d["serve_match"]):
            raise AssertionError(f"stream pretrain -> restore -> serve gates: {record}")
        if on_card and (min(flash.values()) == 0 or not decode.get("f32")):
            raise AssertionError(f"realdatastream: flash {flash}, decode {decode}")
        launches["paged_decode_attention"] = {"serve": decode.get("f32", 0)}  # row 6a, f32
        if on_card:
            torch.cuda.empty_cache()

        # (3) the TFRecord tier
        from distributeddeeplearning_tpu_torch.data.imagenet import (
            NativeTFRecordImageNetDataset,
        )
        from distributeddeeplearning_tpu_torch.native.example_proto import encode_example

        n_shards, per_shard, nbytes = tfrecords
        tfr = os.path.join(tmp, "tfrecords")
        os.makedirs(tfr)
        rng = np.random.RandomState(7)
        payloads = [encode_example({"image/encoded": rng.bytes(nbytes),
                                    "image/class/label": [i % 1000]})
                    for i in range(per_shard)]
        total = n_shards * sum(map(len, payloads))
        paths = [os.path.join(tfr, f"imagenet-{i:05d}-of-{n_shards:05d}")
                 for i in range(n_shards)]
        t0 = time.perf_counter()
        for p in paths:
            native.write_tfrecord(p, payloads)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        index = [native.index_tfrecord(p, verify=True) for p in paths]
        index_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [native.read_tfrecord(p, verify=False) for p in paths]
        read_s = time.perf_counter() - t0
        if any(b != payloads for b in back) or any(len(o) != per_shard for o, _ in index):
            raise AssertionError("the TFRecord set did not read back")
        t0 = time.perf_counter()
        ds = NativeTFRecordImageNetDataset(os.path.join(tfr, "imagenet-*"),
                                           global_batch_size=batch, verify=True)
        open_s = time.perf_counter() - t0
        if len(ds) != n_shards * per_shard or ds.steps_per_epoch != len(ds) // batch:
            raise AssertionError(f"native reader over the set: {len(ds)} records")
        print("realdatatfrecord " + json.dumps({
            "shards": n_shards, "records": n_shards * per_shard, "bytes": total,
            "write_mb_per_s": total / write_s / 1e6, "index_verify_mb_per_s":
            total / index_s / 1e6, "read_mb_per_s": total / read_s / 1e6,
            "reader_open_s": open_s, "reader_records": len(ds), "warm_page_cache": True,
            "card": card}), flush=True)
        del back, payloads
        shutil.rmtree(tfr, ignore_errors=True)

        # (4) the JPEG paths
        if has_pil:
            from distributeddeeplearning_tpu_torch import real_data_bench as rdb

            jroot = os.path.join(tmp, "jpeg")
            prep = rdb.prepare(jroot, jpeg_images, image_size)
            hb = max(batch // 2, 1)
            host = {f"{mode}": rdb.host(jroot, 4, hb, 8, mode, image_size)
                    for mode in ("thread", "process")}
            reset()
            e2e = rdb.e2e(jroot, batch, max(jpeg_images // batch - 2, 1), image_size,
                          device=device)
            tally("e2e", fb)
            print("realdatajpeg " + json.dumps({
                "prepare": prep, "host_img_per_s": host, "host_batch": hb,
                "e2e_img_per_s": e2e, "e2e_batch": batch, "tensorflow": has_tf,
                "card": card}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


KNOB_STEPS = 5  # steps a fit of the knobs phase (the first is the graphed run's warm-up)
KNOB_MARKS = {"flash": ("flash_",), "vit": ("packed_", "dw_db"), "resnet": ("matmul_stats",)}


def _knob_turn(what, cfg, data, model, device, counter=None):
    """One ``fit`` of the knobs phase, profiled from its second step:
    the step's synchronized wall (``step_ms``; the host stamps' median
    beside it), busy share (device ms a profiled step over it), peak
    memory, the capture's figures, the losses, the port's
    kernels a step by the profiler's names and, eager, the wrappers'
    Python counts. Returns ``(line, state dict)``."""
    if counter is not None:
        counter.launches = 0
    res, walls, peak, kernels, device_ms = _warm_fit(cfg, data, model, device, True)
    step_ms = res.perf.get("synced_step_ms", statistics.median(walls))
    line = {"what": what, "kind": "graphed" if cfg.aot_warmup else "eager",
            "step_ms": step_ms, "step_stamp_ms_median": statistics.median(walls),
            "device_ms_per_step": device_ms,
            "busy_share": device_ms / step_ms if isinstance(device_ms, float) else "not measured",
            "peak_gb": peak, "graphs_captured": res.perf.get("graphs_captured", 0),
            "eager_steps": res.perf.get("eager_steps"), "compile_sec": res.perf.get("compile_sec"),
            "losses": [h["loss"] for h in res.history],
            "python_counter_launches": counter.launches if counter is not None else None,
            "profiled_steps": res.perf.get("profiled_steps")}
    line["ours_per_step"] = _ours(kernels, KNOB_MARKS.get(what.split()[0], ()))
    if cfg.aot_warmup and torch.device(device).type == "cuda" and (
            res.perf.get("graphs_captured", 0) < 1 or res.perf.get("eager_steps")):
        raise AssertionError(f"knobs {what}: the graphed run did not replay ({res.perf})")
    if not all(np.isfinite(line["losses"])):
        raise AssertionError(f"knobs {what}: non-finite loss {line['losses']}")
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return line, final


def _lm_knob_setup(variant, *, moe=True, remat=False, aot=False, steps=KNOB_STEPS, batch=8,
                   seq=1024, vocab=VOCAB, device="cuda", epochs=1, **extra):
    """``lm_moe_<variant>`` (or dense ``lm_<variant>``) under AdamW
    (``DECOUPLED_WEIGHT_DECAY=0.1``, ``WEIGHT_DECAY=0``), ``pallas``
    attention, bf16, on seeded synthetic tokens."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import get_model

    cfg = TrainConfig(model=f"lm_moe_{variant}" if moe else f"lm_{variant}",
                      batch_size_per_device=batch, num_classes=vocab, attn_impl="pallas",
                      optimizer="adamw", decoupled_weight_decay=0.1, weight_decay=0.0,
                      remat=remat, fake_data_length=steps * batch, log_every_steps=1,
                      aot_warmup=aot, epochs=epochs, **extra)
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=seq,
                                 vocab_size=vocab, num_physical_batches=4, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=seq, device=device)
    return cfg, data, model


def moe_routing_stats(model, tokens):
    """One training forward of ``tokens`` (no grad): the load-balance
    loss summed over the MoE layers (``train_step.sown_aux_loss``) and
    the share of (token, choice) pairs the capacity dropped."""
    from distributeddeeplearning_tpu_torch.models.moe import MoEMlpBlock
    from distributeddeeplearning_tpu_torch.training import sown_aux_loss

    seen = []
    blocks = [m for m in model.modules() if isinstance(m, MoEMlpBlock)]
    hooks = [b.register_forward_pre_hook(lambda m, a: seen.append((m, a[0]))) for b in blocks]
    model.train()
    with torch.no_grad():
        model(tokens)
        aux = float(sown_aux_loss(model))
        kept = pairs = 0
        for m, x in seen:
            dispatch, _, _ = m.route(x, m.capacity(x.shape[1]))
            kept += float(dispatch.sum())
            pairs += x.shape[0] * x.shape[1] * min(m.num_selected, m.num_experts)
    for h in hooks:
        h.remove()
    return {"aux_loss": aux, "dropped_share": 1.0 - kept / pairs, "moe_layers": len(blocks)}


def moetrain_phase(fl, card, device="cuda", variant="base", batch=8, seq=1024, vocab=VOCAB,
                   steps=KNOB_STEPS):
    """``lm_moe_<variant>`` (8 experts, top-2, cf 1.25) under AdamW
    through ``fit``, REMAT off and on, eager then graphed
    (``AOT_WARMUP=1``): step walls, busy share, peak memory; graphed
    bit for bit against eager; under replay 12 launches a step of each
    flash kernel, the forward's 24 under REMAT (the recompute runs it
    again); the load-balance loss and dropped share after training;
    dense ``lm_<variant>`` graphed at the same config as the yardstick
    of tokens/s. Prints ``moetrain`` lines; returns the replayed
    launches a step under REMAT by op."""
    on_card = torch.device(device).type == "cuda"
    out, remat_launches = {}, {}
    for remat in (False, True):
        finals, lines = [], {}
        for aot in (False, True):
            cfg, data, model = _lm_knob_setup(variant, remat=remat, aot=aot, steps=steps,
                                              batch=batch, seq=seq, vocab=vocab, device=device)
            line, final = _knob_turn(f"flash lm_moe_{variant} remat={int(remat)}", cfg, data,
                                     model, device, None if aot else fl)
            lines[line["kind"]] = line
            finals.append(final)
            if aot and not remat:
                tokens = torch.as_tensor(next(iter(data.epoch(0)))[0], device=device)
                out["routing"] = moe_routing_stats(model, tokens)
            del model, data
            if on_card:
                torch.cuda.empty_cache()
        equal, gap = _state_gap(*finals)
        del finals
        rec = {"remat": remat, **lines, "graphed_bitwise_equal_eager": equal,
               "max_param_gap_rel": gap,
               "tokens_per_s_graphed": batch * seq * 1e3 / lines["graphed"]["step_ms"],
               "card": card}
        print("moetrain " + json.dumps(rec), flush=True)
        if not (equal or gap <= WARM_GAP_LIMIT):
            raise AssertionError(f"moetrain remat={remat}: graphed left eager by {gap}")
        fwd = 24 if remat else 12
        want = {"flash_fwd": fwd, "flash_bwd_dq": 12, "flash_bwd_dkv": 12}
        if on_card:
            _check_launches(f"moetrain remat={remat}", lines["graphed"]["ours_per_step"], want,
                            lines["graphed"]["profiled_steps"])
            eager = lines["eager"]["python_counter_launches"]
            if eager != (fwd + 24) * steps:
                raise AssertionError(f"moetrain remat={remat}: the wrappers counted {eager} "
                                     f"launches in {steps} eager steps, want {(fwd + 24) * steps}")
        out[remat] = rec
        if remat:
            remat_launches = {op: sum(v for k, v in lines["graphed"]["ours_per_step"].items()
                                      if op in k) for op in want}
    cfg, data, model = _lm_knob_setup(variant, moe=False, aot=True, steps=steps, batch=batch,
                                      seq=seq, vocab=vocab, device=device)
    dense, _ = _knob_turn(f"flash lm_{variant} dense", cfg, data, model, device)
    del model, data
    tps = batch * seq * 1e3 / dense["step_ms"]
    summary = {"what": f"lm_moe_{variant} vs dense lm_{variant} (AdamW, pallas, graphed)",
               "dense": dense, "dense_tokens_per_s": tps,
               "moe_tokens_per_s": out[False]["tokens_per_s_graphed"],
               "moe_vs_dense": out[False]["tokens_per_s_graphed"] / tps,
               "moe_remat_tokens_per_s": out[True]["tokens_per_s_graphed"],
               **out["routing"], "card": card}
    print("moetrain " + json.dumps(summary), flush=True)
    if not (np.isfinite(summary["aux_loss"]) and summary["aux_loss"] > 0):
        raise AssertionError(f"moetrain: aux loss {summary['aux_loss']}")
    if on_card:
        torch.cuda.empty_cache()
    return remat_launches


def moeresume_phase(card, device="cuda", variant="tiny", batch=8, seq=256, vocab=VOCAB):
    """``fit`` with AdamW (``lm_moe_<variant>``, REMAT, graphed), 2 epochs
    of 4 steps, checkpointed every 3 steps; the step-3 checkpoint's
    optimizer state carries ``count``, ``mu`` and ``nu``; a resume from
    it ends bit for bit the uninterrupted run (parameters and both
    moments)."""
    import shutil
    import tempfile

    from distributeddeeplearning_tpu_torch import faults
    from distributeddeeplearning_tpu_torch.training import loop

    tmp = tempfile.mkdtemp(prefix="ddl-moeresume-")

    def run(**kw):
        cfg, data, model = _lm_knob_setup(variant, remat=True, aot=True, steps=4, batch=batch,
                                          seq=seq, vocab=vocab, device=device, epochs=2, **kw)
        return loop.fit(model, cfg, data, device=device, add_default_logger=False)

    try:
        t0 = time.perf_counter()
        ref = run()
        kw = dict(model_dir=os.path.join(tmp, "ckpt"), checkpoint_every_steps=3,
                  checkpoint_async=False, checkpoint_keep=10)
        run(**kw)
        saved = torch.load(os.path.join(tmp, "ckpt", "3", "state.pt"), weights_only=False,
                           map_location="cpu")
        names = sorted(saved["opt"])
        for s in faults.checkpoint_steps(kw["model_dir"]):
            if s > 3:
                shutil.rmtree(os.path.join(kw["model_dir"], str(s)))
        resumed = run(**kw)
        want, got = ref.state.model.state_dict(), resumed.state.model.state_dict()
        equal = all(torch.equal(want[k], got[k]) for k in want) and all(
            torch.equal(a, b) for n in ("mu", "nu")
            for a, b in zip(ref.state.opt_state[n], resumed.state.opt_state[n]))
        line = {"what": f"lm_moe_{variant} AdamW fit, resume from step 3 of 8",
                "opt_state_names": names, "saved_count": saved["opt"]["count"],
                "steps": resumed.state.step, "bitwise_equal": equal,
                "graphs_captured": resumed.perf.get("graphs_captured", 0),
                "seconds": time.perf_counter() - t0, "card": card}
        print("moeresume " + json.dumps(line), flush=True)
        if not equal or names != ["count", "mu", "nu"] or resumed.state.step != 8:
            raise AssertionError(f"moeresume: {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def moeserve_phase(pd, card, variant="base", device="cuda"):
    """``lm_moe_<variant>`` bf16 behind ``Server.build`` (paged, ``fused``,
    the captured program set) answers the ``serve`` mix (``serve_mix``'s
    checks: 12 decode-kernel launches a forward, the program set closed,
    batched streams equal each request served alone, the first token's
    logits against a no-drop re-forward); each greedy stream equals
    ``inference.generate``'s on the same model but at a bf16 near-tie
    (the two decode attentions round at other places; the flips are
    printed), and the same engine in f32 serves the greedy requests
    equal to ``generate`` token for token; then the decode tick's
    profile. Returns the decode kernel's launches (bf16)."""
    from distributeddeeplearning_tpu_torch import inference
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import Request, ServeConfig, Server

    params = convert.init_params(variant, VOCAB, torch.Generator(device=device).manual_seed(0),
                                 moe_experts=8)
    summary, server, reqs, handles = serve_mix(pd, card, SERVE_ENV, "moeserve", params,
                                               variant=f"moe_{variant}", device=device)
    engine = server.engine
    # The two lowerings' gap, measured on this run's first-token logits
    # (the engine's prefill against a no-drop re-forward, serve_mix), as
    # a share of the largest logit. Two logits that each move by at most
    # ``lowering`` can swap only where their gap is within twice it.
    lowering = summary["first_logit_max_abs_err"] / summary["first_logit_max_abs"]
    flips = []
    for i, (r, h) in enumerate(zip(reqs, handles)):
        if r.temperature > 0:
            continue
        want = inference.generate(engine.model, r.prompt[None],
                                  max_new_tokens=NEW_TOKENS)[0, len(r.prompt):].tolist()
        got = [int(t) for t in h.new_tokens]
        if got == want:
            continue
        # A flip is allowed only at a bf16 near-tie, read at the first
        # token where the streams part, on the common prefix: in
        # generate's logits (a no-drop forward through a dense cache)
        # the engine's token is the runner-up, within 2·lowering of
        # generate's choice; in the engine's own logits (its prefill of
        # that prefix, served alone) generate's choice is within
        # 2·lowering of the top. (Routing amplifies the lowerings' bf16
        # noise: an expert choice near a tie moves a token's whole FFN
        # output.)
        j = next(n for n, (a, b) in enumerate(zip(got, want)) if a != b)
        prefix = np.concatenate([r.prompt, np.asarray(want[:j], np.int32)])
        seq = torch.as_tensor(prefix, dtype=torch.long, device=device)
        with torch.no_grad():
            cache = inference.dense_cache(engine.model, 1, seq.shape[0], device)
            ref = engine.model(seq[None], cache)[0, -1].float()
        engine.prefix_cache = False
        alone = Server(engine)
        alone.submit(Request(prompt=prefix, max_new_tokens=1))
        alone.drain()
        engine.prefix_cache = True
        ours = engine.last_prefill["logits"].float()
        flip = {"request": i, "position": j,
                "runner_up_rank": int((ref > ref[got[j]]).sum()),
                "generate_gap_over_max": ((ref[want[j]] - ref[got[j]])
                                          / ref.abs().max()).item(),
                "engine_gap_over_max": ((ours.max() - ours[want[j]])
                                        / ours.abs().max()).item()}
        flip["near_tie"] = (flip["runner_up_rank"] <= 1
                            and flip["generate_gap_over_max"] <= 2 * lowering
                            and flip["engine_gap_over_max"] <= 2 * lowering)
        flips.append(flip)
    summary.update(greedy_flips=flips, greedy_requests=sum(r.temperature == 0 for r in reqs),
                   flip_limit_over_max=2 * lowering,
                   launches_per_forward=summary["launches"] / max(
                       summary["prefills"] + summary["decode_steps"], 1))
    _print_line("moeserve", summary)
    far = [f for f in flips if not f["near_tie"]]
    if far:
        raise AssertionError(f"moeserve: greedy streams differ from generate away from a "
                             f"bf16 near-tie (limit {2 * lowering} of the largest logit): {far}")
    # The same engine in f32 (an f32 KV store through the same kernel):
    # f32 round-off flips no greedy token, so each stream must equal
    # generate's exactly.
    model32 = get_model(f"lm_moe_{variant}", num_classes=VOCAB, dtype=torch.float32,
                        device=device)
    server32 = Server.build(model32, params, ServeConfig.from_env(SERVE_ENV), device=device)
    del params
    server32.engine.warmup()
    greedy = [r for r in reqs if r.temperature == 0]
    _reset_launches(pd)
    replayed0 = server32.engine.replayed_launches()
    hs = [server32.submit(r) for r in greedy]
    server32.drain()
    launches32 = pd.launches + server32.engine.replayed_launches() - replayed0
    equal32 = [[int(t) for t in h.new_tokens] == inference.generate(
        server32.engine.model, r.prompt[None], max_new_tokens=NEW_TOKENS)[
        0, len(r.prompt):].tolist() for r, h in zip(greedy, hs)]
    line32 = {"requests": len(greedy), "greedy_equal_generate": equal32,
              "kv_store": str(server32.engine._stores[0][0].dtype).replace("torch.", ""),
              "launches": launches32, "prefills": len(greedy), "card": card}
    print("moeserve_f32 " + json.dumps(line32), flush=True)
    del server32, model32
    if not all(equal32):
        raise AssertionError(f"moeserve f32: streams differ from generate: {equal32}")
    if torch.device(device).type == "cuda":
        ticks, depth = 8, len(engine.model.blocks)
        prof = profile_decode(server, VOCAB, card, ticks=ticks, label="moeserve_profile")
        if not (_replayed_ok(prof["decode_attention_launches_per_tick"], depth, ticks)
                and prof["replayed_launches_per_tick"] == depth):
            raise AssertionError(f"moeserve: {prof['decode_attention_launches_per_tick']} "
                                 f"decode kernels a tick by name, "
                                 f"{prof['replayed_launches_per_tick']} replayed, want {depth}")
    return summary["launches"]


def vitknobs_phase(fp, card, device="cuda", image_size=224, batch=64, num_classes=1000,
                   steps=KNOB_STEPS):
    """Flagged ViT-B/16 (``fused`` attention, ``FUSED_DENSE_GRAD=1``) with
    dropout 0.1 and REMAT through ``fit``: eager, then graphed (bit for
    bit the eager run; under replay 24 ``packed_fwd``, 24 ``packed_bwd``
    kernels and 49 ``dw_db`` a step), then graphed without the knobs (the
    step walls and peak memory beside them). Returns the replayed
    launches a step with the knobs by kernels-line name."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
    from distributeddeeplearning_tpu_torch.models import get_model

    on_card = torch.device(device).type == "cuda"

    def make(knobs, aot):
        cfg = TrainConfig(model="vit_b16", attn_impl="fused", image_size=image_size,
                          batch_size_per_device=batch, num_classes=num_classes,
                          fake_data_length=steps * batch, epochs=1, log_every_steps=1,
                          aot_warmup=aot, remat=knobs)
        data = SyntheticImageDataset(length=cfg.fake_data_length,
                                     global_batch_size=cfg.global_batch_size,
                                     image_size=image_size, num_classes=num_classes,
                                     num_physical_batches=4, seed=cfg.seed)
        model = get_model(cfg.model, **cfg.model_kwargs(), device=device, fused_dense_grad=True,
                          dropout=0.1 if knobs else 0.0)
        return cfg, data, model

    lines, finals = {}, []
    for knobs, aot in ((True, False), (True, True), (False, True)):
        cfg, data, model = make(knobs, aot)
        line, final = _knob_turn(f"vit vit_b16 knobs={int(knobs)}", cfg, data, model, device,
                                 None if aot else fp)
        lines[f"{line['kind']}{'' if knobs else '_no_knobs'}"] = line
        if knobs:
            finals.append(final)
        del model, data, final
        if on_card:
            torch.cuda.empty_cache()
    equal, gap = _state_gap(*finals)
    del finals
    rec = {"what": "vit_b16 fused FUSED_DENSE_GRAD=1 dropout=0.1 REMAT=1", **lines,
           "graphed_bitwise_equal_eager": equal, "max_param_gap_rel": gap,
           "step_ms_vs_no_knobs": (lines["graphed"]["step_ms"]
                                   / lines["graphed_no_knobs"]["step_ms"]),
           "card": card}
    print("vitknobs " + json.dumps(rec), flush=True)
    if not (equal or gap <= WARM_GAP_LIMIT):
        raise AssertionError(f"vitknobs: graphed left eager by {gap}")
    if on_card:
        for key, fwd in (("graphed", 24), ("graphed_no_knobs", 12)):
            _check_launches(f"vitknobs {key}", lines[key]["ours_per_step"],
                            {"packed_fwd": fwd, "packed_bwd": 24, "dw_db": 49},
                            lines[key]["profiled_steps"])
    got = lines["graphed"]["ours_per_step"]
    count = lambda mark: sum(v for k, v in got.items() if mark in k)  # noqa: E731
    return {"fused_qkv_fwd": count("packed_fwd"), "fused_qkv_bwd": count("packed_bwd") / 2,
            "matmul_dw_db": count("dw_db")}


def resnetknobs_phase(fb, card, device="cuda", image_size=224, batch=64, num_classes=1000,
                      steps=KNOB_STEPS + 2):
    """Fused ResNet-50 with the s2d stem and bf16 BatchNorm statistics
    through a graphed ``fit``, then with the default stem and statistics:
    finite losses, 32 fused-block kernels a replayed step in both (the
    in-block statistics stay f32), the step walls side by side. Returns
    the replayed launches a step with the knobs by kernels-line name."""
    on_card = torch.device(device).type == "cuda"
    lines = {}
    for knobs in (True, False):
        cfg, data, model = _resnet_fit_setup(
            epochs=1, steps=steps, image_size=image_size, batch=batch,
            num_classes=num_classes, device=device, s2d_stem=knobs,
            stats_dtype="bfloat16" if knobs else "float32")
        cfg = cfg.replace(aot_warmup=True)
        line, _ = _knob_turn(f"resnet resnet50 s2d={int(knobs)}", cfg, data, model, device)
        lines["knobs" if knobs else "default"] = line
        del model, data
        if on_card:
            torch.cuda.empty_cache()
            _check_launches(f"resnetknobs s2d={knobs}", line["ours_per_step"],
                            {"matmul_stats": 32}, line["profiled_steps"])
    rec = {"what": "resnet50 fused, s2d_stem + stats_dtype=bfloat16 vs default (graphed)",
           **lines, "step_ms_vs_default": (lines["knobs"]["step_ms"]
                                           / lines["default"]["step_ms"]),
           "card": card}
    print("resnetknobs " + json.dumps(rec), flush=True)
    got = lines["knobs"]["ours_per_step"]
    return {"matmul_stats": sum(v for k, v in got.items() if ", false>" in k),
            "bn_relu_matmul_stats": sum(v for k, v in got.items() if ", true>" in k)}


def knobs_phase(fl, fp, fb, pd, card, device="cuda", small=None):
    """The model and optimizer knobs on the card (``moetrain``,
    ``moeresume``, ``moeserve``, ``vitknobs``, ``resnetknobs`` and the
    ``moe_audit`` twin's table at ``lm_small``). ``small`` (a dict of
    sizes) rehearses it on the CPU. Returns the replayed launches a step
    on these paths by kernels-line name."""
    from distributeddeeplearning_tpu_torch import moe_audit

    s = small or {}
    launches = {}
    launches.update(moetrain_phase(fl, card, device, **s.get("moetrain", {})))
    gc.collect()
    moeresume_phase(card, device, **s.get("moeresume", {}))
    gc.collect()
    launches["paged_decode_attention"] = moeserve_phase(pd, card, device=device,
                                                        **s.get("moeserve", {}))
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    launches.update(vitknobs_phase(fp, card, device, **s.get("vitknobs", {})))
    gc.collect()
    launches.update(resnetknobs_phase(fb, card, device, **s.get("resnetknobs", {})))
    gc.collect()
    moe_audit.audit(**{"steps": 5, **s.get("moe_audit", {})}, device=device)
    return launches


# The fleet phase: full-width lm_base in bf16 (the engine route in f32),
# paged, fused, captured, 8 slots a replica, 512-token contexts (one
# prefill bucket of 512: two members, four graphs a replica).
FLEET_MAX_LEN = 512
FLEET_SHAPES = ((448, 32), (320, 48), (480, 32), (384, 64))
FLEET_REQUESTS = 48
# The one-against-two fleet serves a longer backlog, six requests a slot
# as the fleet bench's protocol has (48 on 2 x 4 slots): its fairness
# window must span several turns of every slot, and at 48 requests on
# 16 slots it spanned about one. Its first FLEET_REQUESTS requests are
# the other parts' backlog.
FLEET_FAIR_REQUESTS = 96
FLEET_TENANTS = "gold:3,silver:2,bronze:1"
FLEET_FAIRNESS_TOL = 0.15  # the fleet bench's SERVE_FLEET_FAIRNESS_TOL
# The storm's peak memory may exceed the undisturbed run's by this share
# (rebuilt engines release the old stores, graphs and pool first), and
# what stays allocated after it the allocation before it by 32 MiB.
FLEET_STORM_MEM_SLACK = 0.05
FLEET_BENCHES = ("fleet_bench", "disagg_bench", "chaos_bench")
# The storm: ``storm_plan(2, seed=217, spread=160)`` puts slow (tick 26),
# corrupt (58), hang (142) and crash (151) on replica 0 and the flap
# (101) on replica 1, slow first: a slow window that opens while its
# replica rebuilds expires unseen. Replica 0 may fault three times (the
# corrupt replay's heal, the hang, the crash), so the storm allows three
# restarts a replica, and the flap crashes four times, one more than
# that: its breaker opens and replica 0 carries the rest.
FLEET_STORM = dict(seed=217, spread=160)
FLEET_STORM_RESTARTS, FLEET_STORM_FLAPS = 3, 4


class _FleetLaunches:
    """Decode-kernel launches replayed by every fleet engine while
    active: each engine's captured launches times its replays, read
    when its router closes or the engine is released (a rebuilt
    replica's old engine), by patching ``Router.close`` and
    ``SlotEngine.close`` for the block; and each closed router's
    ``handoff_ms`` (the ``serve.handoff_ms`` values)."""

    def __init__(self):
        self.total = 0
        self.handoff_ms = []
        self._seen = set()

    def _take(self, engine):
        if engine is not None and id(engine) not in self._seen and engine.programs:
            self._seen.add(id(engine))
            self.total += engine.replayed_launches()

    def __enter__(self):
        from distributeddeeplearning_tpu_torch.serving import Router, SlotEngine

        self._patched = (Router.close, SlotEngine.close)
        router_close, engine_close = self._patched
        counter = self

        def close_router(router):
            for r in router.replicas:
                counter._take(r.engine)
            router_close(router)
            counter.handoff_ms += list(router.handoff_ms)

        def close_engine(engine):
            counter._take(engine)
            engine_close(engine)

        Router.close, SlotEngine.close = close_router, close_engine
        return self

    def __exit__(self, *exc):
        from distributeddeeplearning_tpu_torch.serving import Router, SlotEngine

        Router.close, SlotEngine.close = self._patched
        return False


def _settled_allocated():
    """Bytes allocated once the device is idle, garbage collected and the
    caching allocator has processed the frees it deferred while other
    threads' streams or captures were in flight (``empty_cache``)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _fleet_requests(n, vocab, shapes):
    """The seeded multi-tenant backlog (``loadgen.build_tenant_requests``,
    closed, greedy), its first prompt cut below one KV block: the benches'
    warm pass re-sends ``reqs[0]``, and a prefix-cache hit on it would
    prefill a suffix at other shapes than a fresh prefill."""
    from distributeddeeplearning_tpu_torch.serving.fleet.router import parse_tenant_weights
    from distributeddeeplearning_tpu_torch.serving.loadgen import build_tenant_requests

    tenants = sorted(parse_tenant_weights(FLEET_TENANTS))
    reqs = build_tenant_requests(tenants, n, 0.0, 0, vocab, list(shapes))
    reqs[0]["prompt"] = reqs[0]["prompt"][:8]
    return reqs, tenants


def _fleet_configs(num_slots=8):
    from distributeddeeplearning_tpu_torch.serving import FleetConfig, ServeConfig
    from distributeddeeplearning_tpu_torch.serving.fleet.router import parse_tenant_weights

    scfg = ServeConfig(num_slots=num_slots, buckets=(FLEET_MAX_LEN,), kv_layout="paged",
                       block_size=16, decode_kernel="fused")
    fcfg = FleetConfig(replicas=2, tenant_weights=parse_tenant_weights(FLEET_TENANTS))
    return scfg, fcfg


def _wait_ready(router, timeout=600):
    t0 = time.perf_counter()
    while not all(r.state == "ready" for r in router.replicas):
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError("fleet warm-up timed out")
        if any(r.state == "faulted" for r in router.replicas):
            bad = [r for r in router.replicas if r.state == "faulted"]
            raise AssertionError(f"replica {bad[0].rid} faulted while warming: {bad[0].fault!r}")
        time.sleep(0.01)


def _fleet_engine_route(card, variant, device, vocab, max_new):
    """``generate(engine=server)`` at B = 1 against ``generate`` on the
    same f32 weights (the engine paged through the kernel, ``generate``
    on its dense plain path), and ``on_token`` against the result."""
    from distributeddeeplearning_tpu_torch import inference
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import ServeConfig, Server

    params = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(3),
                                 FLEET_MAX_LEN)
    model = get_model(f"lm_{variant}", num_classes=vocab, max_seq_len=FLEET_MAX_LEN,
                      dtype=torch.float32, device=device)
    ref = copy.deepcopy(model)
    ref.load_state_dict(params)
    ref.eval()
    scfg, _ = _fleet_configs()
    server = Server.build(model, params, scfg, device=device, max_len=FLEET_MAX_LEN)
    prompt = np.random.RandomState(5).randint(0, vocab, size=(1, 448)).astype(np.int32)
    streamed = []
    t0 = time.perf_counter()
    got = inference.generate(None, prompt, max_new_tokens=max_new, engine=server,
                             on_token=lambda row, tok: streamed.append((row, tok)))
    wall = time.perf_counter() - t0
    want = inference.generate(ref, prompt, max_new_tokens=max_new).cpu()
    line = {"equal_to_generate": bool(torch.equal(got, want)),
            "on_token_exact": [t for _, t in streamed] == got[0, 448:].tolist()
            and all(r == 0 for r, _ in streamed),
            "tokens": len(streamed), "wall_s": wall, "dtype": "float32",
            "compile_count": server.engine.compile_count,
            "programs_expected": server.engine.programs_expected, "card": card}
    print("fleetroute " + json.dumps(line), flush=True)
    if not (line["equal_to_generate"] and line["on_token_exact"]):
        first = next((j for j in range(max_new) if got[0, 448 + j] != want[0, 448 + j]), None)
        raise AssertionError(f"fleetroute: engine route differs from generate at new token "
                             f"{first} (on_token exact: {line['on_token_exact']})")
    server.engine.close()


def _fleet_import_inplace(model, params, scfg, reqs, card, device, ticks=16):
    """Slot transfer into a captured engine: a stream exported after a
    few ticks is imported by two engines, one replaying its captured
    members and one running the same members uncaptured. The import
    writes the existing stores in place (their addresses do not move),
    and both continue bit for bit as the exporting engine does."""
    from distributeddeeplearning_tpu_torch.serving import ReqSpec, SlotEngine

    def engine():
        e = SlotEngine(copy.deepcopy(model), params, max_len=FLEET_MAX_LEN, device=device,
                       **scfg.engine_kwargs())
        e.warmup()
        return e

    def decode(e, slot, n):
        return [t for _ in range(n) for s, t, _ in e.decode_step() if s == slot]

    r = reqs[1]
    src = engine()
    src.prefill(0, ReqSpec(prompt=r["prompt"], max_new_tokens=r["max_new"]))
    decode(src, 0, 3)
    t0 = time.perf_counter()
    state = src.export_slot(0)
    export_ms = (time.perf_counter() - t0) * 1e3
    runs, moved, import_ms = [], [], []
    for captured in (True, False):
        dst = engine()
        if not captured:
            install_uncaptured(dst)
        ptrs = [t.data_ptr() for t in dst._named_stores().values()]
        t0 = time.perf_counter()
        dst.import_slot(0, state)
        import_ms.append((time.perf_counter() - t0) * 1e3)
        moved.append([t.data_ptr() for t in dst._named_stores().values()] != ptrs)
        runs.append(decode(dst, 0, ticks))
        dst.close()
    want = decode(src, 0, ticks)
    payload_mb = sum(t.numel() * t.element_size() for t in state["payload"].values()) / 2**20
    line = {"blocks": len(state["payload"]["block0.k"]), "payload_mib": payload_mb,
            "export_ms": export_ms, "import_ms": import_ms, "stores_moved": moved,
            "replayed_equal_uncaptured": runs[0] == runs[1],
            "equal_to_source": runs[0] == want, "ticks": ticks, "card": card}
    src.close()
    print("fleetimport " + json.dumps(line), flush=True)
    if any(moved) or not (line["replayed_equal_uncaptured"] and line["equal_to_source"]):
        raise AssertionError(f"fleetimport: {line}")


def _fleet_disturbed(model, params, reqs, scfg, fcfg, want, action, device):
    """Two threaded replicas serve ``reqs``; once a quarter of the
    tokens are out and replica 0 holds running streams, ``action``
    (``drain`` or ``fault``) hits replica 0. Every stream must complete
    equal to ``want``, spliced bitwise; a faulted replica then rejoins
    (a rebuilt engine) and serves again."""
    from distributeddeeplearning_tpu_torch.serving import Replica, Request, Router

    router = Router(config=dataclasses.replace(fcfg, replicas=2))
    for k in range(2):
        router.add_replica(Replica(k, model, params, scfg, max_len=FLEET_MAX_LEN,
                                   device=device), start=True, threaded=True)
    _wait_ready(router)
    handles = [router.submit(Request(prompt=r["prompt"], max_new_tokens=r["max_new"]),
                             tenant=r["tenant"]) for r in reqs]
    total = sum(r["max_new"] for r in reqs)
    fired_at, moved = None, 0
    t0 = time.perf_counter()
    while router.step():
        out = sum(len(fh.new_tokens) for fh in handles)
        r0 = router._replica(0)
        if fired_at is None and out >= total // 4 and r0.server.active_count:
            fired_at = out
            if action == "drain":
                moved = router.drain_replica(0)
            else:
                moved = router.fail_replica(0, RuntimeError("smoke-injected fault"))
        if time.perf_counter() - t0 > 300:
            raise TimeoutError(f"fleet {action}: drain timed out")
        time.sleep(0.0005)
    wall = time.perf_counter() - t0
    streams = [list(fh.new_tokens) for fh in handles]
    line = {"action": action, "fired_at_tokens": fired_at, "rerouted": moved,
            "completed": sum(fh.finish_reason in ("eos", "length") for fh in handles),
            "requests": len(handles), "equal_to_baseline": streams == want,
            "splices_consistent": all(fh.restart_consistent for fh in handles),
            "requeued": router.stats["requeued"], "wall_s": wall,
            "replica0": router._replica(0).state}
    if action == "fault":
        router.rejoin_replica(0)
        _wait_ready(router)
        h = router.submit(Request(prompt=reqs[1]["prompt"], max_new_tokens=reqs[1]["max_new"]))
        router.drain(timeout=300)
        line["rejoined_equal"] = list(h.new_tokens) == want[1]
    line["closed"] = all(r.engine.compile_count == r.engine.programs_expected
                         for r in router.replicas)
    router.close()
    if not (fired_at is not None and line["completed"] == len(handles)
            and line["equal_to_baseline"] and line["splices_consistent"] and line["closed"]
            and line.get("rejoined_equal", True)):
        raise AssertionError(f"fleet {action} mid-load: {line}")
    return line


def _fleet_spec_brownout(model, params, reqs, scfg, want, device, k=4):
    """A ``SERVE_SPEC_K=4`` int8-draft replica under the ladder
    ``spec_off,max_new:8`` (an injected burn signal): the ladder steps
    down (speculation suspended, new requests capped at 8 tokens), the
    requests served there equal the plain replica's greedy streams cut
    at 8, and it steps back up with speculation resumed."""
    from distributeddeeplearning_tpu_torch.serving import (
        BrownoutLadder,
        Replica,
        Request,
        Router,
        parse_brownout_stages,
    )

    spec_cfg = dataclasses.replace(scfg, spec_k=k, spec_draft="int8")
    rep = Replica(0, model, params, spec_cfg, max_len=FLEET_MAX_LEN, device=device)
    router = Router(config=dataclasses.replace(_fleet_configs()[1], replicas=1))
    router.add_replica(rep, start=True, threaded=False)
    burning = {"on": True}
    ladder = BrownoutLadder(
        parse_brownout_stages("spec_off,max_new:8"),
        reader=lambda: {"slo": [{"objective": "smoke", "stat": "p99",
                                 "metric": "serve.ttft", "burning": burning["on"]}]},
        refresh_s=0.0, escalate_ticks=2, recover_ticks=4)
    router.brownout = ladder
    for _ in range(64):
        router.step()
        if ladder.level == 2:
            break
    suspended = rep.engine.spec_suspended
    picked = [i for i, r in enumerate(reqs)
              if len(r["prompt"]) + r["max_new"] + k <= FLEET_MAX_LEN][:8]
    handles = [router.submit(Request(prompt=reqs[i]["prompt"], max_new_tokens=reqs[i]["max_new"]))
               for i in picked]
    router.drain(timeout=300)
    capped = [list(h.new_tokens) for h in handles]
    parity = capped == [want[i][:8] for i in picked]
    verify_ticks = rep.engine.spec_stats["verify_ticks"]
    burning["on"] = False
    for _ in range(64):
        router.step()
        if ladder.level == 0:
            break
    h = router.submit(Request(prompt=reqs[picked[0]]["prompt"], max_new_tokens=16))
    router.drain(timeout=300)
    line = {"stages": "spec_off,max_new:8", "spec_k": k, "draft": "int8",
            "suspended_at_level_2": suspended, "requests": len(picked),
            "greedy_parity_under_spec_off": parity,
            "verify_ticks_while_suspended": verify_ticks,
            "transitions": [(t["direction"], t["stage"]) for t in ladder.transitions],
            "resumed": not rep.engine.spec_suspended,
            "verify_ticks_after": rep.engine.spec_stats["verify_ticks"],
            "closed": rep.engine.compile_count == rep.engine.programs_expected,
            "after_resume_ok": h.finish_reason == "length"}
    router.close()
    want_moves = [("down", "spec_off"), ("down", "max_new"), ("up", "max_new"), ("up", "spec_off")]
    if not (suspended and parity and verify_ticks == 0 and line["transitions"] == want_moves
            and line["resumed"] and line["verify_ticks_after"] > 0 and line["closed"]
            and line["after_resume_ok"]):
        raise AssertionError(f"fleet spec brownout: {line}")
    return line


def _fleet_profile_launches(model, params, scfg, reqs, card, device, ticks=4):
    """Decode-kernel launches by the profiler's kernel names on one
    inline replica: a prefill, then ``ticks`` decode ticks with all 8
    slots busy. Want 12 a prefill and 12 a tick."""
    from torch.profiler import ProfilerActivity, profile

    from distributeddeeplearning_tpu_torch.serving import Replica, Request

    rep = Replica(0, model, params, scfg, max_len=FLEET_MAX_LEN, device=device).start(
        threaded=False)
    server, engine = rep.server, rep.engine
    depth = len(engine.model.blocks)
    picked = [r for r in reqs if r["max_new"] >= 3 * ticks][: engine.num_slots]
    for r in picked[1:]:
        server.submit(Request(prompt=r["prompt"], max_new_tokens=r["max_new"]))
    while len(server._by_slot) < len(picked) - 1:
        server.step()
    server.submit(Request(prompt=picked[0]["prompt"], max_new_tokens=picked[0]["max_new"]))

    def counted(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages() if "decode_attention" in e.key)

    prefills0 = engine.prefill_execs
    n_prefill = counted(lambda: server._admit(time.monotonic()))
    steps0 = engine.decode_steps
    n_ticks = counted(lambda: [engine.decode_step() for _ in range(ticks)])
    got_ticks = engine.decode_steps - steps0
    line = {"prefill_launches": n_prefill, "prefills": engine.prefill_execs - prefills0,
            "tick_launches": n_ticks / max(got_ticks, 1), "ticks": got_ticks,
            "want_per_call": depth, "card": card}
    rep.stop()
    rep.release()
    if not (line["prefills"] == 1 and _replayed_ok(n_prefill, depth, 1)
            and _replayed_ok(line["tick_launches"], depth, got_ticks)):
        raise AssertionError(f"fleet launches by profiler names: {line}")
    return line


def _fleet_bench_twins(names, card, timeout=600):
    """``python -m distributeddeeplearning_tpu_torch.<name>`` for each of
    ``names`` at its protocol (its defaults, on the card), all at once
    (the chaos twin idles most of its wall waiting for its storm to
    settle): each record and exit code. A twin that prints no record or
    an error record fails the phase; its gates decide only its exit
    code, which is reported."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"distributeddeeplearning_tpu_torch.{name}"],
        env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__))) for name in names}
    out = []
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=timeout)
        records = [ln for ln in stdout.splitlines() if ln.startswith('{"metric"')]
        if not records or "error" in json.loads(records[-1]):
            raise AssertionError(f"{name} printed no record or an error (rc {proc.returncode}):"
                                 f"\n{stdout[-2000:]}\n{stderr[-3000:]}")
        out.append({"bench": name, "rc": proc.returncode,
                    "seconds": time.perf_counter() - t0,
                    "gates_failed": [ln for ln in stderr.splitlines() if "GATES FAILED" in ln],
                    "record": json.loads(records[-1]), "card": card})
    return out


def _spec_harness(card, timeout=600):
    """The serve harness's speculative compare (``SERVE_SPEC_K=4``, the
    int8 self-draft, ``lm_base`` f32, fused) in a subprocess: its record
    and exit code. Parity and closed program sets on both engines are
    enforced. The 1.4× gate decides the exit code, which is reported as
    ``gate_met`` and not enforced: on the H100 the self-draft misses it
    (ROADMAP.md §C, an open fault), and this script's exit code is the
    port's proof that it runs on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve_bench"],
        env=dict(os.environ, SERVE_SPEC_K="4", SERVE_SPEC_DRAFT="int8", BENCH_MODEL="lm_base",
                 SERVE_DECODE_KERNEL="fused"),
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    records = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"metric"')]
    record = json.loads(records[-1]) if records else {"error": "no record"}
    runs = [record.get("detail", {}).get(k, {}) for k in ("greedy", "spec")]
    if "error" in record or not record["detail"]["parity"] or any(
            r.get("compiles_during_measure") != 0
            or r.get("compile_count") != r.get("programs_expected") for r in runs):
        raise AssertionError(f"serve_bench spec compare: {records[-1:]}\n{proc.stderr[-3000:]}")
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "record": record,
            "card": card}


def fleet_phase(pd, card, variant="base", device="cuda", small=None):
    """``fleet``: the serving fleet on the card. Prints one line a part:
    ``fleetroute`` (the engine route), ``fleet`` (one replica against two
    on the seeded three-tenant backlog: bitwise streams, tenant shares
    at the end of contention, closed program sets), ``fleetdrain`` and
    ``fleetfault`` (replica 0 drained, then faulted, mid-load; every
    stream spliced bitwise; the faulted one rejoins), ``fleetdisagg``
    (one prefill and two decode replicas: handoff streams equal to the
    mixed replica's, a directory adoption with zero prefills, a live
    migration, ``serve.handoff_ms``), ``fleetstorm`` (a seeded
    crash/hang/slow/corrupt/flap storm over two replicas, streams equal
    to the undisturbed run, peak memory before and after),
    ``fleetbrownout`` (a spec int8-draft replica under
    ``spec_off,max_new:8``), ``fleetlaunches`` (decode kernels by
    profiler names), ``fleetbench`` (the three bench twins' records and
    exit codes) and ``fleetspec`` (the serve harness's spec int8
    compare). ``small`` (sizes) rehearses it on the CPU. Returns the
    decode-kernel launches the fleets' captured engines replayed."""
    from distributeddeeplearning_tpu_torch import chaos_bench, disagg_bench, fleet_bench
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import SlotEngine
    from distributeddeeplearning_tpu_torch.serving.chaos import storm_plan

    s = small or {}
    on_card = torch.device(device).type == "cuda"
    vocab = s.get("vocab", VOCAB)
    fair_reqs, tenants = _fleet_requests(s.get("fair_requests", FLEET_FAIR_REQUESTS), vocab,
                                         s.get("shapes", FLEET_SHAPES))
    reqs = fair_reqs[:s.get("requests", FLEET_REQUESTS)]
    _fleet_engine_route(card, variant, device, vocab, s.get("route_new", 64))
    gc.collect()
    params = convert.init_params(variant, vocab, torch.Generator(device=device).manual_seed(0),
                                 FLEET_MAX_LEN)
    model = get_model(f"lm_{variant}", num_classes=vocab, max_seq_len=FLEET_MAX_LEN,
                      device=device)
    scfg, fcfg = _fleet_configs(s.get("slots", 8))
    _fleet_import_inplace(model, params, scfg, reqs, card, device)
    gc.collect()
    with _FleetLaunches() as fleet_launches:
        single, want, single_status = fleet_bench.run_fleet(
            model, params, fair_reqs, scfg, fcfg, 1, FLEET_MAX_LEN, tenants)
        gc.collect()
        two, streams, status = fleet_bench.run_fleet(
            model, params, fair_reqs, scfg, fcfg, 2, FLEET_MAX_LEN, tenants)
        gc.collect()
        weights = fcfg.tenant_weights
        window = two["fairness_at_contention"]
        shares = {t: {"weight_share": w / sum(weights.values()),
                      "token_share": window[t]["share"], "window_tokens": window[t]["tokens"]}
                  for t, w in weights.items()}
        for row in shares.values():
            row["rel_err"] = abs(row["token_share"] - row["weight_share"]) / row["weight_share"]
        ledgers = single["per_replica"] + two["per_replica"]
        line = {"requests": len(fair_reqs), "single": {k: single[k] for k in (
                    "tokens_per_sec", "wall_s", "ttft_p50_ms", "ttft_p99_ms", "per_replica")},
                "fleet": {k: two[k] for k in ("tokens_per_sec", "wall_s", "ttft_p50_ms",
                                              "ttft_p99_ms", "per_replica", "requeued")},
                "scaling": two["tokens_per_sec"] / single["tokens_per_sec"],
                "streams_equal": streams == want and status == single_status,
                "contended": bool(window.get("_contended")),
                "shares": shares, "card": card}
        print("fleet " + json.dumps(line), flush=True)
        if not (line["streams_equal"] and all(st in ("eos", "length") for st in status)
                and line["contended"]
                and all(r["rel_err"] <= FLEET_FAIRNESS_TOL for r in shares.values())
                and all(r["compile_count"] == r["programs_expected"]
                        and r["compiles_during_measure"] == 0 for r in ledgers)):
            raise AssertionError("fleet: one replica against two failed a check (line above)")
        want = want[:len(reqs)]

        for action in ("drain", "fault"):
            line = _fleet_disturbed(model, params, reqs, scfg, fcfg, want, action, device)
            print(f"fleet{action} " + json.dumps(dict(line, card=card)), flush=True)
            gc.collect()

        # Disaggregated: one prefill and two decode replicas (migration
        # needs a second decode replica), with the directory and a
        # scheduled migration; the probe re-sends a published prompt.
        fcfg_d = dataclasses.replace(fcfg, replicas=3, disagg=True, prefill_pool=1,
                                     decode_pool=2)
        donor = max(range(1, len(reqs)), key=lambda i: len(reqs[i]["prompt"]))
        probe = {"prompt": reqs[donor]["prompt"], "max_new": reqs[donor]["max_new"],
                 "tenant": tenants[-1]}
        n0 = len(fleet_launches.handoff_ms)
        run, d_streams, d_out, probe_out = disagg_bench.run_fleet(
            model, params, reqs, scfg, fcfg_d, FLEET_MAX_LEN, migrate_tick=6, probe=probe)
        ms = sorted(fleet_launches.handoff_ms[n0:])
        handoff = {"n": len(ms), "p50": float(np.percentile(ms, 50)) if ms else None,
                   "p99": float(np.percentile(ms, 99)) if ms else None,
                   "max": ms[-1] if ms else None}
        line = {"pools": run["pools"], "handoffs": run["stats"]["handoffs"],
                "migrations": run["stats"]["migrations"],
                "migrated_streams": run["migrated_streams"],
                "streams_equal_mixed": d_streams == want,
                "completed": all(o in ("eos", "length") for o in d_out),
                "probe_prefill_execs": probe_out["prefill_execs_delta"],
                "probe_directory_hits": probe_out["directory_hits_delta"],
                "probe_equal": probe_out["tokens"] == want[donor],
                "handoff_ms": handoff, "ttft_p99_ms": run["ttft_p99_ms"],
                "itl_p99_ms": run["itl_p99_ms"], "tokens_per_sec": run["tokens_per_sec"],
                "per_replica": run["per_replica"], "card": card}
        print("fleetdisagg " + json.dumps(line), flush=True)
        if not (line["streams_equal_mixed"] and line["completed"] and line["handoffs"] >= 1
                and line["migrations"] >= 1 and line["probe_prefill_execs"] == 0
                and line["probe_directory_hits"] >= 1 and line["probe_equal"]
                and all(r["compile_count"] == r["programs_expected"]
                        for r in run["per_replica"])):
            raise AssertionError("fleetdisagg failed a check (line above)")
        gc.collect()

        # The storm, against the undisturbed run of the same geometry,
        # under the chaos bench's drill-tempo knobs.
        fcfg_c = dataclasses.replace(fcfg, max_restarts=FLEET_STORM_RESTARTS,
                                     restart_backoff_s=0.05,
                                     straggler_factor=4.0, straggler_ticks=5,
                                     quarantine_ticks=60, heartbeat_timeout_s=0.75)
        plan = storm_plan(2, **FLEET_STORM).replace("count=3", f"count={FLEET_STORM_FLAPS}")
        mem = {}
        if on_card:
            mem["allocated_before_undisturbed"] = _settled_allocated()
            torch.cuda.reset_peak_memory_stats()
        base = chaos_bench.run_storm(model, params, reqs, scfg, fcfg_c, FLEET_MAX_LEN, tenants,
                                     chaos_plan="", brownout_stages="", burn_window=(20, 40))
        if on_card:
            mem["peak_undisturbed"] = torch.cuda.max_memory_allocated()
            mem["allocated_before_storm"] = _settled_allocated()
            torch.cuda.reset_peak_memory_stats()
        storm, s_streams, s_out, splice_ok, mismatches, _ = chaos_bench.run_storm(
            model, params, reqs, scfg, fcfg_c, FLEET_MAX_LEN, tenants, chaos_plan=plan,
            brownout_stages="", burn_window=(20, 40))
        if on_card:
            mem["peak_storm"] = torch.cuda.max_memory_allocated()
            mem["allocated_after_storm"] = _settled_allocated()
        fired = sorted({f["kind"] for f in storm["chaos_fired"]})
        line = {"plan": plan, "fired": fired, "restarts": storm["stats"]["rejoins"],
                "breaker_open": storm["stats"]["breaker_open"],
                "splice_mismatch": storm["stats"]["splice_mismatch"],
                "streams_equal_undisturbed": s_streams == base[1] == want,
                "completed": all(o in ("eos", "length") for o in s_out),
                "splices_consistent": splice_ok, "memory": mem,
                "live_engines": sum(isinstance(o, SlotEngine) for o in gc.get_objects()),
                "per_replica": storm["per_replica"], "wall_s": storm["wall_s"], "card": card}
        print("fleetstorm " + json.dumps(line), flush=True)
        corrupt_ok = "corrupt" not in fired or (mismatches >= 1 and splice_ok)
        # The storm's peak above its start against the undisturbed run's.
        mem_ok = not on_card or (
            mem["peak_storm"] - mem["allocated_before_storm"]
            <= (1 + FLEET_STORM_MEM_SLACK) * (mem["peak_undisturbed"]
                                              - mem["allocated_before_undisturbed"])
            and mem["allocated_after_storm"] <= mem["allocated_before_storm"] + 2 ** 25)
        # A flap's crashes are recorded as crashes; its mark is the breaker.
        if not (line["streams_equal_undisturbed"] and line["completed"] and corrupt_ok
                and set(fired) >= {"crash", "hang", "slow", "corrupt"}
                and line["breaker_open"] >= 1 and mem_ok):
            raise AssertionError("fleetstorm failed a check (line above)")
        gc.collect()

        line = _fleet_spec_brownout(model, params, reqs, scfg, want, device)
        print("fleetbrownout " + json.dumps(dict(line, card=card)), flush=True)
        gc.collect()
    launches = fleet_launches.total
    if on_card:
        line = _fleet_profile_launches(model, params, scfg, reqs, card, device)
        print("fleetlaunches " + json.dumps(dict(line, replayed_total=launches)), flush=True)
        torch.cuda.empty_cache()
        for line in _fleet_bench_twins(s.get("benches", FLEET_BENCHES), card):
            print("fleetbench " + json.dumps(line), flush=True)
        spec = _spec_harness(card)
        d = spec["record"]["detail"]
        ticks = max(d["spec"]["decode_steps"], 1)
        print("fleetspec " + json.dumps({
            "rc": spec["rc"], "gate_met": spec["rc"] == 0,
            "speedup": d["speedup"], "min_speedup": d["min_speedup"],
            "parity": d["parity"], "accept_rate_mean": d["accept_rate_mean"],
            "draft_ms_per_tick": d["draft_ms_total"] / ticks,
            "verify_ms_per_tick": d["verify_ms_total"] / ticks,
            "greedy_tokens_per_sec": d["greedy"]["tokens_per_sec"],
            "spec_tokens_per_sec": d["spec"]["tokens_per_sec"],
            "seconds": spec["seconds"], "card": card}), flush=True)
        if spec["rc"] != 0:
            print(f"fleetspec: the spec gate is not met ({d['speedup']} < "
                  f"{d['min_speedup']}x), an open fault (ROADMAP.md §C)",
                  file=sys.stderr, flush=True)
    return launches


# ---------------------------------------------------------------------------
# mesh: the pjit, sp and pp engines in multi-process worlds
# ---------------------------------------------------------------------------

# lm_base training's shapes (T 1024, batch 8, vocab 32,000; ResNet-50 and
# ViT-B/16 at 224 px); the f32 first step against one rank at 2 layers
# and batch 8; ``timed`` bf16 steps a world after one warm-up step.
MESH_SIZE = dict(variant="base", vocab=32_000, seq=1024, batch=8, check_batch=8,
                 check_layers=2, timed=2, image_size=224, resnet_batch=32, vit_batch=8)
MESH_LOSS_REL = 1e-5  # f32: the same sums in another order
MESH_PARAM_REL = 1e-4  # f32: of the largest value (the CPU tests' assert_step_matches)
# One H100, two ranks sharing it under gloo (ranks_per_card 2).
MESH_SCENARIOS = (
    dict(name="pjit_tp", engine="pjit", param_sharding="tp", axes=["data", "model"],
         shape=[1, 2], model="lm"),
    dict(name="pjit_fsdp", engine="pjit", param_sharding="fsdp", axes=["data"], shape=[2],
         model="lm"),
    dict(name="sp_ring", engine="sp", axes=["data", "seq"], shape=[1, 2], model="lm"),
    dict(name="pp_gpipe", engine="pp", pp_schedule="gpipe", axes=["data", "pipe"],
         shape=[1, 2], model="lm"),
    dict(name="pp_1f1b", engine="pp", pp_schedule="1f1b", axes=["data", "pipe"],
         shape=[1, 2], model="lm"),
    dict(name="resnet50_sync_bn", engine="pjit", param_sharding="dp", axes=["data"],
         shape=[2], model="resnet", allow_sync_bn=True),
    dict(name="vit_b16_pjit", engine="pjit", param_sharding="dp", axes=["data"], shape=[2],
         model="vit"),
    # lm_moe_base (12 layers, 6 routed over 8 experts): the experts over
    # 'expert', each expert's mlp dim over 'model', their embed dims over 'data'
    dict(name="pjit_ep", engine="pjit", param_sharding="tp", axes=["data", "expert"],
         shape=[1, 2], model="lm", moe=True),
    dict(name="pjit_tp_moe", engine="pjit", param_sharding="tp", axes=["data", "model"],
         shape=[1, 2], model="lm", moe=True),
    dict(name="pjit_fsdp_moe", engine="pjit", param_sharding="fsdp", axes=["data"], shape=[2],
         model="lm", moe=True),
)


def _mesh_cfg(sc, dtype, attn_impl, size):
    from distributeddeeplearning_tpu_torch.config import TrainConfig

    kw = dict(engine=sc["engine"], mesh_axes=tuple(sc["axes"]), mesh_shape=tuple(sc["shape"]),
              param_sharding=sc.get("param_sharding", "tp"),
              pp_schedule=sc.get("pp_schedule", "gpipe"), pp_microbatches=4,
              allow_sync_bn=sc.get("allow_sync_bn", False), compute_dtype=dtype,
              scale_lr_by_world_size=False)
    if sc["model"] == "lm":
        family = "lm_moe" if sc.get("moe") else "lm"
        return TrainConfig(model=f"{family}_{size['variant']}", num_classes=size["vocab"],
                           attn_impl=attn_impl, batch_size_per_device=size["batch"], **kw)
    if sc["model"] == "vit":
        return TrainConfig(model="vit_b16", num_classes=1000, attn_impl="fused",
                           image_size=size["image_size"],
                           batch_size_per_device=size["vit_batch"], **kw)
    return TrainConfig(model="resnet50", num_classes=1000, image_size=size["image_size"],
                       batch_size_per_device=size["resnet_batch"], **kw)


def _mesh_model(sc, cfg, device, size, layers=None):
    from distributeddeeplearning_tpu_torch.models import get_model

    if sc["model"] == "lm":
        return get_model(cfg.model, num_classes=size["vocab"], dtype=cfg.compute_dtype,
                         attn_impl=cfg.attn_impl, max_seq_len=size["seq"], n_layers=layers,
                         device=device)
    if sc["model"] == "vit":
        return get_model("vit_b16", num_classes=1000, dtype=cfg.compute_dtype,
                         attn_impl="fused", fused_dense_grad=True,
                         image_size=size["image_size"], device=device)
    return get_model("resnet50", num_classes=1000, dtype=cfg.compute_dtype, fused=True,
                     device=device)


def _mesh_batch(sc, rows, size, seed=5):
    """The global batch of a scenario (numpy, from ``seed``)."""
    rng = np.random.RandomState(seed)
    if sc["model"] == "lm":
        r = rng.randint(0, size["vocab"], size=(rows, size["seq"] + 1)).astype(np.int32)
        return r[:, :-1], r[:, 1:]
    px = size["image_size"]
    return (rng.randint(0, 256, size=(rows, px, px, 3)).astype(np.uint8),
            rng.randint(0, 1000, size=(rows,)).astype(np.int32))


def _resnet_agree_sd(device):
    """``fused_vs_unfused_step``'s weights: the seeded init with every
    BN γ drawn 1 ± 0.2 and the branches' last γ 0.1 ± 0.02."""
    from distributeddeeplearning_tpu_torch.models import convert

    sd = convert.init_resnet_params(50, 1000, torch.Generator(device=device).manual_seed(42))
    g = torch.Generator(device=device).manual_seed(7)
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 1:
            base = 0.1 if bool((v == 0).all()) else 1.0
            sd[k] = base * (1.0 + 0.2 * torch.randn(v.shape, device=device, generator=g))
    return sd


def _mesh_engine(sc, cfg, device, size, mesh=None, layers=None):
    """The scenario's engine through the port's entry points (seeded
    init; the ResNet from the agreement weights)."""
    from distributeddeeplearning_tpu_torch.training import create_optimizer, engines
    from distributeddeeplearning_tpu_torch.training.pjit_step import build_pjit_state

    model = _mesh_model(sc, cfg, device, size, layers)
    tx, _ = create_optimizer(cfg, 100, world_size=1)
    mesh = engines.resolve_mesh(cfg, mesh)
    state = None
    if sc["model"] == "resnet":
        state = build_pjit_state(model, cfg, tx, mesh, device=device,
                                 state_dict=_resnet_agree_sd(device))
    return engines.build_engine(model, cfg, tx, state=state, device=device, mesh=mesh)


def _local(eng, batch, device):
    index, count = eng.batch_shard()
    n = batch[0].shape[0] // count
    return tuple(torch.as_tensor(x[index * n:(index + 1) * n]).to(device) for x in batch)


def _mesh_counts():
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp
    from distributeddeeplearning_tpu_torch.ops import fused_block as fb
    from distributeddeeplearning_tpu_torch.ops import fused_grads as fg

    out = dict(fl.launches_by_op)
    out.update(fb.launches_by_op)
    out.update(fp.launches_by_op)
    out["matmul_dw_db"] = fg.launches
    return out


def _mesh_reset():
    from distributeddeeplearning_tpu_torch.ops import flash as fl
    from distributeddeeplearning_tpu_torch.ops import flash_packed as fp
    from distributeddeeplearning_tpu_torch.ops import fused_block as fb
    from distributeddeeplearning_tpu_torch.ops import fused_grads as fg

    for mod in (fl, fb, fp):
        mod.launches = 0
        for k in mod.launches_by_op:
            mod.launches_by_op[k] = 0
    fg.launches = 0


def mesh_child(spec_path, out_path):
    """One rank of the ``mesh`` phase's world (``chip_smoke.py
    --mesh-child SPEC OUT``, started by :func:`mesh_phase` or
    ``scripts/mesh_check.py``): the world from ``DDL_*``
    (``parallel.distributed``), then for each scenario
    of ``SPEC`` the f32 first step at ``check_layers`` layers (LM;
    rank 0 saves the whole state after it) and the full-depth bf16 run:
    one warm-up step, ``timed`` steps (``SPEC``'s sizes), the kernels' launches
    a step and the peak memory of this rank. Rank 0 writes every rank's
    lines to ``OUT`` (JSON)."""
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
    from distributeddeeplearning_tpu_torch.training import checkpoint

    distributed.maybe_initialize()
    device = distributed.default_device()
    backend = dist.get_backend()
    rank, world = collectives.rank(), collectives.size()
    spec = json.load(open(spec_path))
    size = spec["size"]
    cuda = device.type == "cuda"
    ranks_per_card = max(1, world // torch.cuda.device_count()) if cuda else 0
    lines = []
    for sc in spec["scenarios"]:
        t0 = time.perf_counter()
        line = {"name": sc["name"], "rank": rank, "backend": backend, "world": world,
                "ranks_per_card": ranks_per_card}
        if sc["model"] == "lm" and spec.get("check", True):
            cfg = _mesh_cfg(sc, "float32", "xla", size)
            eng = _mesh_engine(sc, cfg, device, size, layers=size["check_layers"])
            state, m = eng.train_step(eng.state, _local(eng, _mesh_batch(
                sc, size["check_batch"], size), device))
            line["check_loss"] = float(m["loss"])
            payload = checkpoint._payload(state)
            if rank == 0:
                torch.save({"loss": float(m["loss"]), "model": {
                    k: v.detach().cpu() for k, v in payload["model"].items()}},
                    os.path.join(os.path.dirname(out_path), f"{sc['name']}_check.pt"))
            del eng, state, payload
            gc.collect()
        attn = ("pallas" if cuda else "xla") if sc["model"] == "lm" else "fused"
        cfg = _mesh_cfg(sc, "bfloat16" if cuda else "float32", attn, size)
        eng = _mesh_engine(sc, cfg, device, size)
        rows = cfg.batch_size_per_device * (world if sc["model"] != "lm" else 1)
        timed = size["timed"]
        batches = [_local(eng, _mesh_batch(sc, rows, size, seed=5 + i), device)
                   for i in range(timed + 1)]
        line["param_mib"] = sum(t.numel() * t.element_size()
                                for t in eng.state.model.parameters()) / 2**20
        line["expert_mib"] = sum(t.numel() * t.element_size()  # w1, b1, w2, b2
                                 for n, t in eng.state.model.named_parameters()
                                 if ".moe." in n and "router" not in n) / 2**20
        state, m = eng.train_step(eng.state, batches[0])
        if sc["model"] == "resnet" and rank == 0:
            payload = {k: v.detach().cpu() for k, v in eng.state.model.state_dict().items()}
        elif sc["model"] == "resnet":
            payload = None
        line["first_loss"] = float(m["loss"])
        if sc["model"] == "resnet" and rank == 0:
            torch.save({"loss": float(m["loss"]), "model": payload},
                       os.path.join(os.path.dirname(out_path), f"{sc['name']}_check.pt"))
        _sync(device)
        collectives.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _mesh_reset()
        t1 = time.perf_counter()
        losses = []
        for b in batches[1:]:
            state, m = eng.train_step(state, b)
            losses.append(float(m["loss"]))
        _sync(device)
        line["step_ms"] = (time.perf_counter() - t1) / timed * 1e3
        line["launches_per_step"] = {k: v / timed for k, v in _mesh_counts().items()}
        line["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        line["losses"] = losses
        if eng.mesh is not None and eng.mesh.shape.get("expert", 1) > 1:
            line["replicas_agree"] = state.layout.replicas_agree(eng.mesh.group("expert"))
        line["seconds"] = time.perf_counter() - t0
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{sc['name']}: non-finite losses {losses}")
        del eng, state, batches
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        collectives.barrier()
        every = [None] * world
        dist.all_gather_object(every, line)
        lines += every
    if rank == 0:
        json.dump({"lines": lines, "backend": backend}, open(out_path, "w"))
    distributed.shutdown()


def _mesh_want(sc, layers, on_card=True):
    """Each kernel's launches a step on a rank (PERF.md §6's table): the
    flash kernels once a layer a forward (tp: 6 of 12 heads; fsdp: the
    whole model) and backward; pp ×4 microbatches over 6 layers a stage,
    1F1B's forwards twice (its recompute); ring attention none; the
    fused ResNet 16 + 16 a forward; the packed ViT kernels 12 + 12 and
    dW+db 49 (every ``FusedGradDense``, on each rank's own tensors)."""
    zero = {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "matmul_stats",
                           "bn_relu_matmul_stats", "fused_qkv_fwd", "fused_qkv_bwd",
                           "matmul_dw_db")}
    if not on_card:
        return zero
    if sc["model"] == "resnet":
        return dict(zero, matmul_stats=16, bn_relu_matmul_stats=16)
    if sc["model"] == "vit":
        return dict(zero, fused_qkv_fwd=12, fused_qkv_bwd=12, matmul_dw_db=49)
    if sc["engine"] == "sp":
        return zero
    if sc["engine"] == "pp":
        n = layers // sc["shape"][sc["axes"].index("pipe")] * 4
        return dict(zero, flash_fwd=2 * n if sc["pp_schedule"] == "1f1b" else n,
                    flash_bwd_dq=n, flash_bwd_dkv=n)
    return dict(zero, flash_fwd=layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)


def _mesh_reference(sc, device, size):
    """One rank's step on the same global batch and weights: the dp
    engine (LM: f32 at the check depth; ResNet: the fused bf16 step on
    the whole batch), or for pp the pipeline of one stage holding both
    stages' blocks (JAX's ``apply_reference``)."""
    from distributeddeeplearning_tpu_torch.models.pipeline_lm import (
        PipelineLM,
        init_pipeline_params,
    )
    from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu_torch.training import create_optimizer, engines
    from distributeddeeplearning_tpu_torch.training.pp_step import create_pp_state
    from distributeddeeplearning_tpu_torch.training.state import create_train_state

    if sc["model"] == "resnet":
        cfg = _mesh_cfg(sc, "bfloat16" if torch.device(device).type == "cuda" else "float32",
                        "fused", size).replace(engine="dp", mesh_axes=("data",),
                                               mesh_shape=None)
        model = _mesh_model(sc, cfg, device, size)
        tx, _ = create_optimizer(cfg, 100, world_size=1)
        state = create_train_state(model, cfg, tx, device=device,
                                   state_dict=_resnet_agree_sd(device))
        eng = engines.build_engine(model, cfg, tx, state=state, device=device)
        batch = _mesh_batch(sc, 2 * cfg.batch_size_per_device, size, seed=5)
    elif sc["engine"] == "pp":
        cfg = _mesh_cfg(sc, "float32", "xla", size).replace(mesh_shape=(1, 1))
        lm = (size["variant"], size["vocab"], size["seq"])
        sds = [init_pipeline_params(PipelineLM(*lm, 2, size["check_layers"], torch.float32,
                                               stage=s, device=device), cfg.seed, device)
               for s in range(2)]
        one = {k: v for k, v in sds[0].items() if not k.startswith("core.")}
        for s, sd in enumerate(sds):
            one.update({f"core.layers.{s}." + k[len("core.layers.0."):]: v
                        for k, v in sd.items() if k.startswith("core.layers.0.")})
        pl = PipelineLM(*lm, 1, size["check_layers"], torch.float32, device=device)
        tx, _ = create_optimizer(cfg, 100, world_size=1)
        mesh = create_mesh(axes=("data", "pipe"))
        state = create_pp_state(pl, cfg, tx, mesh, device=device, state_dict=one)
        eng = engines.build_engine(pl, cfg, tx, state=state, device=device, mesh=mesh)
        batch = _mesh_batch(sc, size["check_batch"], size)
    else:
        cfg = _mesh_cfg(sc, "float32", "xla", size).replace(
            engine="dp", mesh_axes=("data",), mesh_shape=None)
        model = _mesh_model(sc, cfg, device, size, size["check_layers"])
        tx, _ = create_optimizer(cfg, 100, world_size=1)
        eng = engines.build_engine(model, cfg, tx, device=device)
        batch = _mesh_batch(sc, size["check_batch"], size)
    state, m = eng.train_step(eng.state, tuple(torch.as_tensor(x).to(device) for x in batch))
    from distributeddeeplearning_tpu_torch.training import checkpoint

    got = checkpoint._payload(state)["model"]
    return float(m["loss"]), {k: v.detach().cpu() for k, v in got.items()}


def _mesh_compare(sc, want_loss, want, got_loss, got, device):
    """The check of one scenario against its one-rank reference: f32
    LM (and pp) loss within ``MESH_LOSS_REL`` and every parameter within
    ``MESH_PARAM_REL`` of the largest value; the bf16 fused ResNet under
    the fused-vs-unfused limits (``AGREE_LOSS_REL``, ``AGREE_UPDATE_REL``
    on the update of each group, ``AGREE_STATS_REL``)."""
    if sc["model"] == "resnet":
        init = {k: v.cpu() for k, v in _resnet_agree_sd(device).items()}
        sums, stats = {}, 0.0
        for k, ref in init.items():
            if "running" in k:
                stats = max(stats, ((got[k] - want[k]).abs().max()
                                    / want[k].abs().max()).item())
                continue
            dw, dg = want[k].double() - ref.double(), got[k].double() - ref.double()
            n, d = sums.get(_agree_group(k), (0.0, 0.0))
            sums[_agree_group(k)] = (n + (dg - dw).pow(2).sum().item(),
                                     d + dw.pow(2).sum().item())
        gaps = {g: (n / d) ** 0.5 for g, (n, d) in sums.items()}
        loss_rel = abs(got_loss - want_loss) / abs(want_loss)
        res = {"loss_rel": loss_rel, "update_rel_by_group": gaps, "running_stats_rel": stats}
        res["within_limits"] = (loss_rel <= AGREE_LOSS_REL
                                and max(gaps.values()) <= AGREE_UPDATE_REL
                                and stats <= AGREE_STATS_REL)
        return res
    scale = max(float(v.abs().max()) for v in want.values())
    if sc["engine"] != "pp":
        worst = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    else:  # stages stacked [S, ...] against one stage's blocks
        worst = 0.0
        for k, v in got.items():
            if k.startswith("core.layers."):
                for s in range(v.shape[0]):
                    ref = want["core.layers." + str(s) + k[len("core.layers.0"):]]
                    worst = max(worst, float((v[s] - ref).abs().max()))
            else:
                worst = max(worst, float((v - want[k]).abs().max()))
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    return {"loss_rel": loss_rel, "param_err_rel": worst / scale,
            "within_limits": loss_rel <= MESH_LOSS_REL and worst <= MESH_PARAM_REL * scale}


def run_mesh_world(scenarios, nprocs, tmp, size=MESH_SIZE, timeout=600, platform="gpu"):
    """Start ``nprocs`` ranks of :func:`mesh_child` as a world from
    ``DDL_*`` (NCCL with a card a rank when the machine has one for each,
    else gloo with ranks sharing the cards) and return rank 0's JSON."""
    import socket

    os.makedirs(tmp, exist_ok=True)
    spec, out = os.path.join(tmp, "spec.json"), os.path.join(tmp, "out.json")
    json.dump({"scenarios": list(scenarios), "size": size}, open(spec, "w"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(nprocs):
        env = dict(os.environ, DDL_COORDINATOR=f"127.0.0.1:{port}",
                   DDL_NUM_PROCESSES=str(nprocs), DDL_PROCESS_ID=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(nprocs), DDL_PLATFORM=platform,
                   PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "chip_smoke.py"), "--mesh-child", spec, out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("mesh world failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{log[-6000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return json.load(open(out))


def mesh_phase(card, device="cuda", scenarios=MESH_SCENARIOS, nprocs=2, tmp=None,
               size=MESH_SIZE):
    """The ``mesh`` phase: every scenario in one world of ``nprocs``
    ranks (:func:`run_mesh_world`), each rank's first step held against
    the one-rank reference (:func:`_mesh_compare`), each rank's launches
    a step against :func:`_mesh_want`, GPipe against 1F1B (equal losses
    within the f32 limit at the check, 1F1B's peak memory lower at full
    depth). Prints a ``mesh`` line a scenario and ``meshworld``; returns
    each kernel's launches a step by scenario (rank 0)."""
    import tempfile

    tmp = tmp or tempfile.mkdtemp(prefix="ddl-mesh-")
    got = run_mesh_world(scenarios, nprocs, tmp, size,
                         platform="gpu" if device == "cuda" else "cpu")
    by = {}
    for line in got["lines"]:
        by.setdefault(line["name"], []).append(line)
    print("meshworld " + json.dumps({"backend": got["backend"], "world": nprocs,
                                     "card": card}), flush=True)
    launches = {}
    for sc in scenarios:
        ranks = by[sc["name"]]
        path = os.path.join(tmp, f"{sc['name']}_check.pt")
        agree = None
        if os.path.exists(path):
            saved = torch.load(path, weights_only=True)
            want_loss, want = _mesh_reference(sc, device, size)
            agree = _mesh_compare(sc, want_loss, want, saved["loss"], saved["model"], device)
            gc.collect()
        from distributeddeeplearning_tpu_torch.models.transformer_lm import _VARIANTS

        want_launch = _mesh_want(sc, _VARIANTS[size["variant"]][1], device == "cuda")
        line = {"name": sc["name"], "engine": sc["engine"],
                "mesh": dict(zip(sc["axes"], sc["shape"])), "backend": ranks[0]["backend"],
                "ranks_per_card": ranks[0]["ranks_per_card"],
                "step_ms_by_rank": [r["step_ms"] for r in ranks],
                "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in ranks],
                "param_mib_by_rank": [r["param_mib"] for r in ranks],
                "expert_mib_by_rank": [r["expert_mib"] for r in ranks],
                "replicas_agree": [r.get("replicas_agree") for r in ranks],
                "launches_per_step_rank0": ranks[0]["launches_per_step"],
                "losses": ranks[0]["losses"], "agree": agree, "card": card}
        print("mesh " + json.dumps(line), flush=True)
        for r in ranks:
            bad = {k: (r["launches_per_step"].get(k), v) for k, v in want_launch.items()
                   if r["launches_per_step"].get(k) != v}
            if bad:
                raise AssertionError(f"{sc['name']} rank {r['rank']}: launches a step "
                                     f"(got, want) {bad}")
        if agree is not None and not agree["within_limits"]:
            raise AssertionError(f"{sc['name']}: the first step disagrees with one rank: {agree}")
        if any(r.get("replicas_agree") is False for r in ranks):
            raise AssertionError(f"{sc['name']}: the replicated parameters differ across the "
                                 f"expert ranks after the timed steps")
        launches[sc["name"]] = {k: v for k, v in ranks[0]["launches_per_step"].items() if v}
    pairs = [[by[sc["name"]] for sc in scenarios if sc.get("pp_schedule") == s]
             for s in ("gpipe", "1f1b")]
    if pairs[0] and pairs[1]:
        g, o = pairs[0][0], pairs[1][0]
        gl, ol = g[0]["check_loss"], o[0]["check_loss"]
        if abs(gl - ol) > MESH_LOSS_REL * abs(gl):
            raise AssertionError(f"GPipe and 1F1B first losses differ: {gl} {ol}")
        gm, om = max(r["peak_mem_gb"] for r in g), max(r["peak_mem_gb"] for r in o)
        print("meshpp " + json.dumps({"gpipe_loss": gl, "1f1b_loss": ol, "gpipe_peak_gb": gm,
                                      "1f1b_peak_gb": om, "card": card}), flush=True)
        if device == "cuda" and not om < gm:
            raise AssertionError(f"1F1B's peak {om} GB is not below GPipe's {gm} GB")
    return launches


# The generic routes (the inputs the fast kernels refuse): the kernels of
# csrc/flash_generic.cu (flash and packed attention at f32 and at other
# head dims), csrc/fused_block_f32.cu, and the decode kernel's head dim 96.

# Generic flash cases: (name, B, H, Tq, Tk, d, causal, dtype): lm_base
# training in f32, and ViT-H/16's head dim 80 (1280 / 16) in bf16.
GENERIC_FLASH_CASES = (
    ("lm_base_train_f32", 8, 12, 1024, 1024, 64, True, torch.float32),
    ("vit_h16_bf16", 8, 16, 197, 197, 80, False, torch.bfloat16),
)
# The packed route: ViT-B/16 training in f32 (name, B, T, H, d, causal, dtype).
GENERIC_PACKED_CASES = (("vit_b16_f32", 64, 197, 12, 64, False, torch.float32),)
# Rows 1-2's timed stage-1 shapes, in f32: (op, where, M, K, N).
F32_FB_SHAPES = (("matmul_stats", "stage1_conv1", 200_704, 256, 64),
                 ("bn_relu_matmul_stats", "stage1_conv3", 200_704, 64, 256))
# Decode at lm_large's head dim 96 (1536 / 16): (B, H, d, L) of 8 slots,
# 16 heads, 512-token contexts, paged in 16-position blocks.
D96_DECODE = (8, 16, 96, 512)


def flash_f32_limit(ref: torch.Tensor, terms: torch.Tensor, n: int) -> torch.Tensor:
    """Per-element limit on |kernel − f32 plain| for f32 inputs (O, dQ,
    dK, dV; ``terms`` from :func:`flash_terms` with ``amp = 2**24 / n``).

    The generic kernels round nothing the plain version does not (their
    roundings to the input dtype are no-ops at f32): the two differ only
    in the order of their f32 sums. A score is a d-term sum, an output
    an n-term sum over keys (queries for dK and dV) of terms that each
    carry their score's error through exp: in all at most
    n·2**-24·terms, n = max(Tq, Tk) + d (recursive summation's worst
    case), and the division by l and the store a few 2**-24·|ref|. ds
    also carries dp's and Δ's cancellation (:func:`flash_terms`, ``amp``
    chosen so that the limit holds twice its bound). Limit:
    2**-24·(2·n·terms + 8·|ref|), twice the worst case. Written before
    the first run on the card."""
    return 2 ** -24 * (2 * n * terms + 8 * ref.abs())


def _generic_limits(q, k, v, o, do, lse, delta, causal, sc):
    """(limit function, (t_o, t_dq, t_dk, t_dv)) of q's dtype: the flash
    limits in bf16, :func:`flash_f32_limit` in f32."""
    if q.dtype == torch.bfloat16:
        return flash_limit, flash_terms(q, k, v, o, do, lse, delta, causal, sc)
    n = max(q.shape[1], k.shape[1]) + q.shape[-1]
    terms = flash_terms(q, k, v, o, do, lse, delta, causal, sc, amp=2 ** 24 / n)
    return (lambda ref, t: flash_f32_limit(ref, t, n)), terms


def _dtype_rates(dtype):
    """(bytes an element, peak flop/s) of a kernel's inputs."""
    return (4, H100_F32_FLOP_S) if dtype == torch.float32 else (2, H100_BF16_FLOP_S)


def _sdpa_times(q, k, v, do, causal, sc, flush):
    """SDPA's forward, and its forward+backward minus forward, on BTHD
    views (the library yardstick; timed only)."""
    import torch.nn.functional as F

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=sc)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, scale=sc)
        return torch.autograd.grad(o, (qg, kg, vg), doh)

    with torch.no_grad():
        fwd = time_ms(sdpa, flush)
    return fwd, time_ms(sdpa_fwd_bwd, flush) - fwd


def generic_flash_case(fl, name, b, h, tq, tk, d, causal, dtype, flush, g):
    """The three generic flash kernels (``csrc/flash_generic.cu``) against
    their plain versions (f32 on the same inputs; the backward's plain
    version gets the kernel's own O and LSE), the dtype's limits
    (:func:`_generic_limits`), the backward twice with equal bits, one
    launch of each counted on the generic route, a negative control (the
    forward dropping each row's last key tile must fail the O limit),
    and CUDA-event times of each kernel, its plain version, SDPA in the
    same dtype and the bound."""
    if fl.route(dtype, d) != "generic":
        raise AssertionError(f"{name}: {dtype} at head dim {d} is not on the generic route")

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    q, k, v, do = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d), randn(b, tq, h, d)
    sc = d ** -0.5
    before = dict(fl.generic_launches_by_op)
    out, lse = fl.flash_forward(q, k, v, causal, sc)
    delta = fl.flash_delta(out, do)
    dq = fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc)
    dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc)
    again = (fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc),
             *fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc))
    torch.cuda.synchronize()
    got = {op: fl.generic_launches_by_op[op] - before[op] for op in before}
    if got != {"flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}:
        raise AssertionError(f"{name}: generic launches {got}")
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
    limit, (t_o, t_dq, t_dk, t_dv) = _generic_limits(q, k, v, out, do, lse, delta, causal, sc)
    errs = {}
    for what, got_x, ref, lim in (
        ("O", out, ref_o, limit(ref_o, t_o)),
        ("LSE", lse, ref_lse, flash_lse_limit(q, k, ref_lse, sc)),
        ("dQ", dq, ref_dq, limit(ref_dq, t_dq)),
        ("dK", dk, ref_dk, limit(ref_dk, t_dk)),
        ("dV", dv, ref_dv, limit(ref_dv, t_dv)),
    ):
        errs[what] = _ratio(got_x, ref, lim)
        if errs[what][1] > 1.0:
            raise AssertionError(
                f"{name}: |generic {what} - plain| exceeds its limit "
                f"{errs[what][1]:.2f}x (max abs error {errs[what][0]})")
    bad, _ = fl.flash_forward(q, k, v, causal, sc, drop_last_tile=True)
    control = _ratio(bad, ref_o, limit(ref_o, t_o))[1]
    if not control > 1.0:
        raise AssertionError(f"{name}: the dropped-tile variant passes ({control:.2f}x)")
    del bad, ref_o, ref_dq, ref_dk, ref_dv, t_o, t_dq, t_dk, t_dv

    with torch.no_grad():
        times = {
            "flash_fwd": time_ms(lambda: fl.flash_forward(q, k, v, causal, sc), flush),
            "flash_bwd_dq": time_ms(
                lambda: fl.flash_bwd_dq(q, k, v, do, lse, delta, causal, sc), flush),
            "flash_bwd_dkv": time_ms(
                lambda: fl.flash_bwd_dkv(q, k, v, do, lse, delta, causal, sc), flush),
        }
        plain = {
            "flash_fwd": time_ms(lambda: fl.flash_forward_plain(q, k, v, causal, sc), flush,
                                 N_TIMED_PLAIN),
            "flash_bwd_dq": time_ms(
                lambda: fl.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, sc), flush,
                N_TIMED_PLAIN),
            "flash_bwd_dkv": time_ms(
                lambda: fl.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, sc), flush,
                N_TIMED_PLAIN),
        }
    sdpa_fwd, sdpa_bwd = _sdpa_times(q, k, v, do, causal, sc, flush)
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
    bounds = flash_bounds(b, h, tq, tk, d, causal, *_dtype_rates(dtype))
    return {
        "case": f"generic/{name}", "route": "generic",
        "shape": {"B": b, "H": h, "Tq": tq, "Tk": tk, "d": d, "causal": causal,
                  "dtype": str(dtype).replace("torch.", "")},
        "max_abs_err": {w: e[0] for w, e in errs.items()},
        "err_over_limit": {w: e[1] for w, e in errs.items()},
        "negative_control_O_err_over_limit": control, "backward_repeats_bitwise": True,
        "kernels": {op: {"ms": times[op], "plain_ms": plain[op], "library_ms": library[op],
                         "bound_ms": bounds[op][0], "bound_by": bounds[op][1],
                         "bytes": bounds[op][2], "flops": bounds[op][3]}
                    for op in FLASH_OPS},
    }


def generic_packed_case(fp, fl, name, b, t, h, d, causal, dtype, flush, g):
    """Packed attention on the generic route: ``fused_qkv_forward`` (the
    generic forward with packed numerics, q, k and v read as column views
    of the projection, its LSE returned) and ``fused_qkv_backward`` (the
    generic dq and dk/dv kernels writing views of one dqkv) against their
    plain versions (f32 on the same inputs; the backward's gets the
    kernel's own O), the dtype's limits, the backward twice with equal
    bits, one call of each counted on the generic route, the dropped-tile
    control, and times of each call, its plain version, SDPA and the
    bound."""
    if fp.route(dtype, t, d) != "generic":
        raise AssertionError(f"{name}: {dtype} at T {t}, head dim {d} is not on the generic route")
    qkv = torch.randn(b, t, 3 * h * d, device="cuda", generator=g).to(dtype)
    do = torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype)
    sc = d ** -0.5
    before = dict(fp.generic_launches_by_op)
    out, lse = fp.fused_qkv_forward(qkv, h, causal, sc, return_lse=True)
    dqkv = fp.fused_qkv_backward(qkv, out, do, h, causal, sc, lse=lse)
    again = fp.fused_qkv_backward(qkv, out, do, h, causal, sc, lse=lse)
    torch.cuda.synchronize()
    got = {op: fp.generic_launches_by_op[op] - before[op] for op in before}
    if got != {"fused_qkv_fwd": 1, "fused_qkv_bwd": 2}:
        raise AssertionError(f"{name}: generic launches {got}")
    for x, what in ((out, "O"), (lse, "LSE"), (dqkv, "dQKV")):
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
    ref_lse = fl.flash_forward_plain(q.float(), k.float(), v.float(), causal, sc)[1]
    errs = {"LSE": _ratio(lse, ref_lse, flash_lse_limit(q, k, ref_lse, sc))}
    limit, (t_o, t_dq, t_dk, t_dv) = _generic_limits(q, k, v, o4, do4, lse,
                                                     fl.flash_delta(o4, do4), causal, sc)
    ref_o4 = ref_o.view(b, t, h, d)
    o_limit = limit(ref_o4, t_o)
    errs["O"] = _ratio(o4, ref_o4, o_limit)
    got_parts, ref_parts = dqkv.view(b, t, 3, h, d), ref_d.view(b, t, 3, h, d)
    for i, (what, terms) in enumerate((("dQ", t_dq), ("dK", t_dk), ("dV", t_dv))):
        errs[what] = _ratio(got_parts[:, :, i], ref_parts[:, :, i],
                            limit(ref_parts[:, :, i], terms))
    for what, (err, ratio) in errs.items():
        if ratio > 1.0:
            raise AssertionError(f"{name}: |generic {what} - plain| exceeds its limit "
                                 f"{ratio:.2f}x (max abs error {err})")
    bad = fp.fused_qkv_forward(qkv, h, causal, sc, drop_last_tile=True)
    control = _ratio(bad.view(b, t, h, d), ref_o4, o_limit)[1]
    if not control > 1.0:
        raise AssertionError(f"{name}: the dropped-tile variant passes ({control:.2f}x)")
    del bad, ref_o, ref_d, ref_lse, t_o, t_dq, t_dk, t_dv, o_limit

    with torch.no_grad():
        times = {
            "fused_qkv_fwd": time_ms(lambda: fp.fused_qkv_forward(qkv, h, causal, sc), flush),
            "fused_qkv_bwd": time_ms(
                lambda: fp.fused_qkv_backward(qkv, out, do, h, causal, sc, lse=lse), flush),
        }
        plain = {
            "fused_qkv_fwd": time_ms(
                lambda: fp.fused_qkv_attention_plain(qkv, h, causal, sc), flush, N_TIMED_PLAIN),
            "fused_qkv_bwd": time_ms(
                lambda: fp.fused_qkv_attention_backward_plain(qkv, out, do, h, causal, sc),
                flush, N_TIMED_PLAIN),
        }
    sdpa_fwd, sdpa_bwd = _sdpa_times(q, k, v, do4, causal, sc, flush)
    library = {"fused_qkv_fwd": sdpa_fwd, "fused_qkv_bwd": sdpa_bwd}
    bounds = fp_bounds(b, t, h, d, causal, *_dtype_rates(dtype))
    return {
        "case": f"generic/{name}", "route": "generic",
        "shape": {"B": b, "T": t, "H": h, "d": d, "causal": causal,
                  "dtype": str(dtype).replace("torch.", "")},
        "max_abs_err": {w: e[0] for w, e in errs.items()},
        "err_over_limit": {w: e[1] for w, e in errs.items()},
        "negative_control_O_err_over_limit": control, "backward_repeats_bitwise": True,
        "kernels": {op: {"ms": times[op], "plain_ms": plain[op], "library_ms": library[op],
                         "bound_ms": bounds[op][0], "bound_by": bounds[op][1],
                         "bytes": bounds[op][2], "flops": bounds[op][3]}
                    for op in FP_OPS},
    }


def fb_f32_y_limit(terms: torch.Tensor, k: int) -> torch.Tensor:
    """Per-element limit on |kernel y − plain y| for f32 operands, given
    ``terms`` = |z|·|w|ᵀ (Σ_k |z_k·w_k| of each element).

    The f32 kernel rounds nothing the plain version does not: its
    prologue is the plain version's multiply, add and ReLU (no fused
    multiply-add), its product K f32 FMAs in order where the plain
    version's cuBLAS sums in another order (TF32 off). Recursive
    summation of K terms errs by at most K·2**-24·terms, in each, and a
    one-ulp difference of the folded affine (rsqrt) moves each z by
    2**-23 of itself. Limit: 2**-24·(2K + 4)·terms. Written before the
    first run on the card."""
    return 2 ** -24 * (2 * k + 4) * terms


def f32_fb_depth(fb, m: int, n: int, sms: int) -> int:
    """The f32 kernel's summation depth of a column's statistics
    (``fused_block.f32_plan``): a thread's 8 rows of each of its row
    tiles, then the block's 16 row lanes, then the panel's groups."""
    p = fb.f32_plan(m, n, sms)
    return 8 * -(-p["tiles"] // p["groups"]) + 16 + p["groups"]


def f32_fb_case(name, fb, op, a, w, flush, *, bn=None, control=False):
    """The f32 fused-block kernel (``csrc/fused_block_f32.cu``) against
    its plain version (the same f32 inputs), :func:`fb_f32_y_limit` and
    ``fb_stats_limit`` at :func:`f32_fb_depth`, run twice for equal bits,
    each launch counted on the ``f32`` route; with ``control`` the kernel
    leaving each panel's last group out of its statistics must miss the
    limit more than tenfold; and CUDA-event times of the kernel, the
    plain version, the library yardstick (an f32 ``torch.matmul``, TF32
    off, the prologue first for bn_relu, then the two column sums) and
    the bound (f32 bytes; 67 TFLOP/s)."""
    m, k = a.shape
    n = w.shape[0]
    if fb.route(a.dtype, k, n) != "f32":
        raise AssertionError(f"{name}: {a.dtype} K={k} N={n} is not on the f32 route")
    if bn is None:
        def kern(**kw):
            return fb.matmul_stats(a, w, **kw)

        def plain_fn():
            return fb.matmul_stats_plain(a, w)

        def z_of():
            return a

        prologue_bytes = 0
    else:
        mean, var, scale, bias = bn
        inv = torch.rsqrt(var + 1e-5) * scale
        shift = bias - mean * inv

        def kern(**kw):
            return fb.bn_relu_matmul_stats(a, mean, var, scale, bias, w, **kw)

        def plain_fn():
            return fb.bn_relu_matmul_stats_plain(a, mean, var, scale, bias, w)

        def z_of():
            return torch.relu(a * inv + shift)

        prologue_bytes = 4 * 4 * k
    before = fb.launches_by_route["f32"]
    with torch.no_grad():
        y, s, ss = kern()
        y2, s2, ss2 = kern()
    torch.cuda.synchronize()
    if fb.launches_by_route["f32"] != before + 2:
        raise AssertionError(f"{name}: {fb.launches_by_route['f32'] - before} f32 launches, "
                             f"want 2")
    if not (torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2)):
        raise AssertionError(f"{name}: a second launch did not repeat the first bit for bit")
    del y2, s2, ss2
    if y.shape != (m, n) or y.dtype != torch.float32:
        raise AssertionError(f"{name}: y {tuple(y.shape)} {y.dtype}")
    if not (torch.isfinite(y).all() and torch.isfinite(s).all() and torch.isfinite(ss).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    diff = (y - plain_fn()[0]).abs()
    lim = fb_f32_y_limit(z_of().abs() @ w.abs().t(), k)
    err = diff.max().item()
    y_ratio = (diff / lim.clamp(min=torch.finfo(torch.float32).tiny)).max().item()
    if not (diff <= lim).all():
        raise AssertionError(f"{name}: |y - plain| exceeds its limit {y_ratio:.2f}x (max {err})")
    del diff, lim
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    depth = f32_fb_depth(fb, m, n, sms)
    s_ratio = _fb_stats_ratio(s, ss, y, depth)
    if s_ratio > 1.0:
        raise AssertionError(f"{name}: the statistics exceed their limit {s_ratio:.2f}x")
    factor = None
    if control:
        with torch.no_grad():
            yb, sb, ssb = kern(drop_last_partial=True)
        factor = _fb_stats_ratio(sb, ssb, yb, depth)
        del yb, sb, ssb
        print("control " + json.dumps({"case": f"f32_{name}_drop_last_group",
                                       "err_over_limit": factor}), flush=True)
        if not factor > 10:
            raise AssertionError(f"{name}: the f32 kernel without each panel's last group "
                                 f"stays within {factor:.2f}x of its limit")

    def library():
        yl = torch.matmul(z_of(), w.t())
        return yl, yl.sum(0), (yl * yl).sum(0)

    nbytes = 4 * (m * k + k * n + m * n) + 8 * n + prologue_bytes
    flops = 2.0 * m * k * n
    bound_bytes = nbytes / H100_BYTES_PER_S * 1e3
    bound_ops = flops / H100_F32_FLOP_S * 1e3
    with torch.no_grad():
        return {
            "case": f"f32/{op}/{name}", "op": op, "route": "f32",
            "shape": {"M": m, "K": k, "N": n}, "plan": fb.f32_plan(m, n, sms),
            "stat_depth": depth, "repeats_bitwise": True, "max_abs_err": err,
            "y_err_over_limit": y_ratio, "stats_err_over_limit": s_ratio,
            "negative_control_stats_err_over_limit": factor,
            "ms": time_ms(kern, flush),
            "plain_ms": time_ms(plain_fn, flush, N_TIMED_PLAIN),
            "library_ms": time_ms(library, flush),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "bytes": int(nbytes), "flops": flops,
        }


def generic_kernel_phase(fl, fp, fb, pd, flush):
    """The generic routes' kernel cases: the generic flash kernels
    (``GENERIC_FLASH_CASES``), packed attention on the generic route
    (``GENERIC_PACKED_CASES``), the f32 fused block at rows 1-2's
    stage-1 shapes (``F32_FB_SHAPES``; the dropped-group control at
    conv3), and the decode kernel at head dim 96 (``D96_DECODE``: bf16,
    int8 and fp8 stores, paged, each twice with equal bits; the
    dropped-split control on the bf16 store). Returns the case lines."""
    from distributeddeeplearning_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(2121)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    cases = []
    for case in GENERIC_FLASH_CASES:
        cases.append(generic_flash_case(fl, *case, flush, g))
        torch.cuda.empty_cache()
    for case in GENERIC_PACKED_CASES:
        cases.append(generic_packed_case(fp, fl, *case, flush, g))
        torch.cuda.empty_cache()
    for op, where, m, k, n in F32_FB_SHAPES:
        w = randn(n, k) * (2.0 / n) ** 0.5
        if op == "matmul_stats":
            cases.append(f32_fb_case(where, fb, op, randn(m, k), w, flush))
        else:
            a = randn(m, k) * (randn(k).abs() * 0.5 + 0.5) + randn(k) * 0.5
            mean = a.mean(0)
            bn = (mean, (a * a).mean(0) - mean * mean, 1.0 + 0.1 * randn(k), 0.1 * randn(k))
            cases.append(f32_fb_case(where, fb, op, a, w, flush, bn=bn, control=True))
            del a, bn
        torch.cuda.empty_cache()

    b, h, d, length = D96_DECODE
    bs, rng = 16, np.random.RandomState(2121)
    pos = rng.randint(0, length, size=b)
    pos[0] = length - 1
    q_pos = torch.from_numpy(pos[:, None].astype(np.int32)).cuda()
    mb = length // bs
    k = randn(b * mb + 1, bs, h, d).to(torch.bfloat16)
    v = randn(b * mb + 1, bs, h, d).to(torch.bfloat16)
    table = torch.from_numpy((1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)).cuda()
    q = randn(b, 1, h, d).to(torch.bfloat16)
    cases.append(kernel_case("lm_large_decode_d96", pd, q, k, v, q_pos, flush, table=table,
                             bs=bs))
    for kind in ("int8", "fp8"):
        (kq, ks), (vq, vs) = quant.quantize_kv(k, kind), quant.quantize_kv(v, kind)
        cases.append(kernel_case(f"lm_large_decode_d96_{kind}", pd, q, kq, vq, q_pos, flush,
                                 table=table, bs=bs, k_scale=ks, v_scale=vs))
    kw = dict(block_table=table, block_size=bs)
    ref = pd.fused_decode_attention_plain(q.float(), k.float(), v.float(), q_pos, **kw)
    wrong = pd.fused_decode_attention(q, k, v, q_pos, drop_last_split=True, **kw)
    factor = ((wrong.float() - ref).abs() / bf16_tolerance(ref)).max().item()
    print("control " + json.dumps({"case": "lm_large_decode_d96_drop_last_split",
                                   "err_over_tol": factor}), flush=True)
    if not factor > 10:
        raise AssertionError(f"the d96 decode without each tile's last split stays within "
                             f"{factor:.2f}x of the tolerance")
    return cases


# The generic phase: the generic routes' user paths at full width through the
# normal entry points, each on the routes the fast kernels refuse.
GENERIC_STEPS = 3  # steps of each training path (a fit's first is its warm-up)
GENERIC_PROFILED = 2  # profiled steps (the busy share)
# f32 first steps against their yardstick steps from the same weights on
# the same batch (derived in generic_phase's docstring).
F32_LM_LIMITS = {"loss_rel": 1e-5, "update_rel": 1e-3, "logits_rel": 1e-5}
F32_RESNET_LIMITS = {"loss_rel": 1e-5, "update_rel": 1e-2, "running_stats_rel": 1e-4}


def _reset_routes(*mods):
    for mod in mods:
        mod.launches = 0
        for table in ("launches_by_op", "launches_by_route", "generic_launches_by_op"):
            for key in getattr(mod, table, {}):
                getattr(mod, table)[key] = 0


def _generic_steps(label, setup, counted, want, card, device, steps=GENERIC_STEPS):
    """``setup()`` -> (cfg, ds, model, state, step) through the port's
    entry points; one warm-up step, then ``steps`` steps timed to a host
    readback of the loss with the launch counters zeroed before them, the
    peak memory, and ``profile_train``'s busy share over
    ``GENERIC_PROFILED`` more steps. ``counted(model)`` reads the counts
    the path must show, ``want(model)`` what they must be."""
    from distributeddeeplearning_tpu_torch.data import prefetch_to_device

    cfg, ds, model, state, step = setup()
    batches = prefetch_to_device(ds.epoch(0), device)
    state, m = step(state, next(batches))
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counts0 = counted(model)
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        state, m = step(state, next(batches))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    wall = time.perf_counter() - t0
    got = {k: v - counts0.get(k, 0) for k, v in counted(model).items()}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite losses {losses}")
    line = {"what": label, "model": cfg.model, "dtype": cfg.compute_dtype,
            "attn_impl": cfg.attn_impl, "batch": cfg.global_batch_size, "steps": steps,
            "step_ms": wall / steps * 1e3, "losses": losses, "launches": got,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2 ** 30 if device == "cuda"
                            else "not measured"), "card": card}
    print("generic " + json.dumps(line), flush=True)
    if got != want(model, steps):
        raise AssertionError(f"{label}: launches {got}, want {want(model, steps)}")
    if device == "cuda":
        profile_train(state, step, batches, card, line["step_ms"], label, ("_generic_",),
                      steps=GENERIC_PROFILED)
    else:
        batches.close()
    return line


def _flash_counts(fl):
    return lambda model: dict(fl.generic_launches_by_op, wgmma=fl.launches_by_route["wgmma"])


def generic_phase(fl, fp, fb, pd, card, device="cuda", small=None):
    """The generic routes' user paths at full width (``small`` cuts them for a
    CPU rehearsal), each through the port's entry points on the routes
    the fast kernels refuse, with the launch counters zeroed before each:

    * ``lm_base`` f32, ``attn_impl="pallas"``, T 1024, batch 8, through
      ``fit`` (``GENERIC_STEPS`` steps): the generic flash kernels 12 / 12
      / 12 a step, none on the wgmma route; the first step from seeded
      weights against the same step with ``"xla"``
      (``lm_pallas_vs_xla_step`` in f32, ``F32_LM_LIMITS``);
    * ViT-B/16 f32 with ``attn_impl="auto"`` (224 px, batch 64): auto
      resolves to the packed kernels, which take the generic route, 12
      forward and 12 backward calls a step;
    * ViT-H/16 bf16 with ``"pallas"`` (head dim 80; batch 8): the generic
      flash kernels 32 / 32 / 32 a step;
    * fused ResNet-50 f32 through ``fit`` (224 px, batch 64): the f32
      fused-block kernel 16 + 16 times a forward, none on the TMA route;
      one fused step against one unfused f32 step (TF32 off:
      ``fused_vs_unfused_step`` in f32, ``F32_RESNET_LIMITS``);
    * ``lm_large`` (head dim 96) served paged with the fused decode
      kernel: bf16 on the captured program set (``serve_mix``: 24
      launches a forward, the streams against each request alone, the
      first token's logits against a re-forward), a decode tick's
      profile; then f32, whose greedy streams must equal ``generate``'s.

    Each training path prints step ms, peak GB and (``profile``) the
    busy share. The f32 limits, written before the first run on the
    card: both f32 steps of a pair run the same f32 math with the sums in
    other orders (TF32 off), so the loss moves by round-off, about 1e-7
    relative. The CPU rehearsal (``small``: lm_tiny T 64 batch 2;
    ResNet-50 64 px batch 4) read loss gaps 0 and 1.1e-7, update gaps up
    to 3.1e-5 (LM) and 8.0e-5 (ResNet: BN amplifies round-off by the
    inverse of small standard deviations), logits 4.9e-7 and running
    statistics 1.1e-6; the limits are 10x or more above those readings
    and far below the bf16 pairs' gaps (0.01-0.15).
    Returns each new kernel's launches on this phase's paths."""
    from distributeddeeplearning_tpu_torch import inference
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import ServeConfig, Server
    from distributeddeeplearning_tpu_torch.training import create_train_state

    sz = {"lm": dict(variant="base", batch=8, seq=1024, vocab=32_000),
          "vit_b": dict(variant="b", image_size=224, batch=64, num_classes=1000),
          "vit_h": dict(variant="h", image_size=224, batch=8, num_classes=1000),
          "resnet": dict(image_size=224, batch=64, num_classes=1000),
          "serve": "large", **(small or {})}
    on_card = torch.device(device).type == "cuda"
    out = {}

    # lm_base f32 pallas through fit, and its first step against xla.
    lm = sz["lm"]
    cfg = TrainConfig(model=f"lm_{lm['variant']}", batch_size_per_device=lm["batch"],
                      num_classes=lm["vocab"], attn_impl="pallas", compute_dtype="float32",
                      fake_data_length=GENERIC_STEPS * lm["batch"], epochs=1, log_every_steps=1)
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=lm["seq"],
                                 vocab_size=lm["vocab"], num_physical_batches=2, seed=cfg.seed)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=lm["seq"], device=device)
    tx = _fit_tx(cfg, data)
    state = create_train_state(model, cfg, tx, device=device)
    _reset_routes(fl)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, _, launches, by_label, _ = _fit_run(fl, cfg, data, model, device, state=state, tx=tx)
    wall = time.perf_counter() - t0
    want = {k: model.depth * GENERIC_STEPS if on_card else 0 for k in launches}
    _check_fit_run("generic lm f32 pallas", res, launches, by_label, want, 1)
    generic = dict(fl.generic_launches_by_op)
    if generic != want or fl.launches_by_route["wgmma"]:
        raise AssertionError(f"lm f32 pallas: generic launches {generic}, wgmma "
                             f"{fl.launches_by_route['wgmma']}, want {want} and 0")
    print("generic " + json.dumps({
        "what": "lm f32 pallas fit", "model": cfg.model, "seq_len": lm["seq"],
        "batch": lm["batch"], "steps": GENERIC_STEPS, "history": res.history,
        "generic_launches_by_op": generic, "fit_wall_s": wall,
        "step_ms": cfg.global_batch_size / res.images_per_sec * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
        else "not measured", "card": card}), flush=True)
    out.update({f"lm_{k}": v for k, v in generic.items()})
    if on_card:
        from distributeddeeplearning_tpu_torch.data import prefetch_to_device
        from distributeddeeplearning_tpu_torch.training import make_train_step

        profile_train(res.state, make_train_step(model, tx, cfg, device=device),
                      prefetch_to_device(data.epoch(1), device), card,
                      cfg.global_batch_size / res.images_per_sec * 1e3,
                      "lm f32 pallas train step", ("_generic_",), steps=GENERIC_PROFILED)
    del res, model, data, state
    agree = lm_pallas_vs_xla_step(variant=lm["variant"], batch=lm["batch"], seq=lm["seq"],
                                  vocab=lm["vocab"], device=device, compute_dtype="float32",
                                  limits=F32_LM_LIMITS)
    print("genericlmagree " + json.dumps(dict(agree, card=card)), flush=True)
    if not agree["within_limits"]:
        raise AssertionError(f"f32 pallas and xla LM steps disagree: {agree}")
    if on_card:
        torch.cuda.empty_cache()

    # ViT-B/16 f32 auto: the packed kernels on the generic route.
    vb = sz["vit_b"]
    line = _generic_steps(
        "vit_b16 f32 auto",
        lambda: _vit_setup("auto", False, device=device, compute_dtype="float32", **vb),
        lambda model: dict(fp.generic_launches_by_op, wgmma=fp.launches_by_route["wgmma"]),
        lambda model, n: {"fused_qkv_fwd": model.depth * n if on_card else 0,
                          "fused_qkv_bwd": model.depth * n if on_card else 0, "wgmma": 0},
        card, device)
    out.update({f"vit_{k}": v for k, v in line["launches"].items()})
    if on_card:
        torch.cuda.empty_cache()

    # ViT-H/16 bf16 pallas: head dim 80 on the generic flash kernels.
    vh = sz["vit_h"]
    line = _generic_steps(
        "vit_h16 bf16 pallas (head dim 80)",
        lambda: _vit_setup("pallas", False, device=device, **vh),
        _flash_counts(fl),
        lambda model, n: {**{op: model.depth * n if on_card else 0 for op in FLASH_OPS},
                          "wgmma": 0},
        card, device)
    for op in FLASH_OPS:
        out[f"vith_{op}"] = line["launches"][op]
    if on_card:
        torch.cuda.empty_cache()

    # Fused ResNet-50 f32 through fit, and one fused against one unfused step.
    rn = sz["resnet"]
    cfg, data, model = _resnet_fit_setup(epochs=1, steps=GENERIC_STEPS, device=device,
                                         image_size=rn["image_size"], batch=rn["batch"],
                                         num_classes=rn["num_classes"], compute_dtype="float32")
    tx = _fit_tx(cfg, data)
    state = create_train_state(model, cfg, tx, device=device)
    _reset_routes(fb)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    res, _, launches, by_label, _ = _fit_run(fb, cfg, data, model, device, state=state, tx=tx)
    want = {k: 16 * GENERIC_STEPS if on_card else 0 for k in launches}
    _check_fit_run("generic resnet50 f32 fused", res, launches, by_label, want, 1)
    routes = dict(fb.launches_by_route)
    if routes != {"tma": 0, "f32": 32 * GENERIC_STEPS if on_card else 0}:
        raise AssertionError(f"resnet50 f32 fused: launches by route {routes}")
    step_ms = cfg.global_batch_size / res.images_per_sec * 1e3
    print("generic " + json.dumps({
        "what": "resnet50 f32 fused fit", "steps": GENERIC_STEPS, "history": res.history,
        "launches_by_op": launches, "launches_by_route": routes, "step_ms": step_ms,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
        else "not measured", "card": card}), flush=True)
    out.update({f"resnet_{k}": v for k, v in launches.items()})
    if on_card:
        from distributeddeeplearning_tpu_torch.data import prefetch_to_device
        from distributeddeeplearning_tpu_torch.training import make_train_step

        profile_train(res.state, make_train_step(model, tx, cfg, device=device),
                      prefetch_to_device(data.epoch(1), device), card, step_ms,
                      "resnet50 f32 fused train step", ("matmul_stats_f32",),
                      steps=GENERIC_PROFILED)
    del res, model, data, state
    agree = fused_vs_unfused_step(image_size=rn["image_size"], batch=rn["batch"],
                                  num_classes=rn["num_classes"], device=device,
                                  compute_dtype="float32", limits=F32_RESNET_LIMITS)
    print("genericresnetagree " + json.dumps(dict(agree, card=card)), flush=True)
    if not agree["within_limits"]:
        raise AssertionError(f"f32 fused and unfused ResNet steps disagree: {agree}")
    if on_card:
        torch.cuda.empty_cache()

    # lm_large served: bf16 captured and timed, then f32 against generate.
    variant = sz["serve"]
    params = convert.init_params(variant, VOCAB, torch.Generator(device=device).manual_seed(0))
    summary, server, reqs, _ = serve_mix(pd, card, SERVE_ENV, "genericserve", params,
                                         variant=variant, device=device)
    _print_line("genericserve", summary)
    out["decode_d96_bf16"] = summary["launches"]
    if on_card:
        ticks, depth = 4, len(server.engine.model.blocks)
        prof = profile_decode(server, VOCAB, card, ticks=ticks, label="genericserve_profile")
        if not (_replayed_ok(prof["decode_attention_launches_per_tick"], depth, ticks)
                and prof["replayed_launches_per_tick"] == depth):
            raise AssertionError(f"genericserve: {prof['decode_attention_launches_per_tick']} "
                                 f"decode kernels a tick by name, "
                                 f"{prof['replayed_launches_per_tick']} replayed, want {depth}")
    del server
    if on_card:
        torch.cuda.empty_cache()
    model32 = get_model(f"lm_{variant}", num_classes=VOCAB, dtype=torch.float32, device=device)
    server32 = Server.build(model32, params, ServeConfig.from_env(SERVE_ENV), device=device)
    del params
    server32.engine.warmup()
    greedy = [r for r in reqs if r.temperature == 0]
    _reset_launches(pd)
    replayed0 = server32.engine.replayed_launches()
    hs = [server32.submit(r) for r in greedy]
    server32.drain()
    launches32 = pd.launches + server32.engine.replayed_launches() - replayed0
    equal32 = [[int(t) for t in h.new_tokens] == inference.generate(
        server32.engine.model, r.prompt[None], max_new_tokens=NEW_TOKENS)[
        0, len(r.prompt):].tolist() for r, h in zip(greedy, hs)]
    print("genericserve_f32 " + json.dumps({
        "requests": len(greedy), "greedy_equal_generate": equal32, "launches": launches32,
        "kv_store": str(server32.engine._stores[0][0].dtype).replace("torch.", ""),
        "card": card}), flush=True)
    del server32, model32
    if not all(equal32):
        raise AssertionError(f"genericserve f32: streams differ from generate: {equal32}")
    out["decode_d96_f32"] = launches32
    if on_card:
        torch.cuda.empty_cache()
    return out


def _generic_entries(cases, launched):
    """The ``kernels`` line's entries of the generic routes' kernels: the times
    of each one's timed case, the largest error over its cases, and its
    launches on the ``generic`` phase's paths."""
    def case(name):
        return next(c for c in cases if c["case"] == name)

    entries = []
    flash_case_ = case("generic/lm_base_train_f32")
    outputs = {"flash_fwd": ("O",), "flash_bwd_dq": ("dQ",), "flash_bwd_dkv": ("dK", "dV"),
               "fused_qkv_fwd": ("O",), "fused_qkv_bwd": ("dQ", "dK", "dV")}
    for op, line in (("flash_fwd", "179"), ("flash_bwd_dq", "371"), ("flash_bwd_dkv", "394")):
        k = flash_case_["kernels"][op]
        entries.append({
            "name": op.replace("flash_", "flash_generic_"), "route": "cuda",
            "source": "distributeddeeplearning_tpu_torch/csrc/flash_generic.cu",
            "replaces": f"distributeddeeplearning_tpu/ops/pallas/flash.py:{line}",
            "launches": launched[f"lm_{op}"] + launched[f"vith_{op}"],
            "max_abs_err": max(c["max_abs_err"][w] for c in cases
                               if c["case"].startswith("generic/") and "flash_fwd" in c["kernels"]
                               for w in outputs[op]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "timed_case": "generic/lm_base_train_f32"})
    packed = case("generic/vit_b16_f32")
    for op, line in (("fused_qkv_fwd", "259"), ("fused_qkv_bwd", "285")):
        k = packed["kernels"][op]
        entries.append({
            "name": op.replace("fused_qkv_", "fused_qkv_generic_"), "route": "cuda",
            "source": "distributeddeeplearning_tpu_torch/csrc/flash_generic.cu",
            "replaces": f"distributeddeeplearning_tpu/ops/pallas/flash_packed.py:{line}",
            "launches": launched[f"vit_{op}"],
            "max_abs_err": max(packed["max_abs_err"][w] for w in outputs[op]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "timed_case": "generic/vit_b16_f32"})
    for op, where, line in (("matmul_stats", "stage1_conv1", "160"),
                            ("bn_relu_matmul_stats", "stage1_conv3", "194")):
        c = case(f"f32/{op}/{where}")
        entries.append({
            "name": f"{op}_f32", "route": "cuda",
            "source": "distributeddeeplearning_tpu_torch/csrc/fused_block_f32.cu",
            "replaces": f"distributeddeeplearning_tpu/ops/pallas/fused_block.py:{line}",
            "launches": launched[f"resnet_{op}"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "timed_case": c["case"]})
    d96 = [c for c in cases if c["case"].startswith("lm_large_decode_d96")]
    c = case("lm_large_decode_d96")
    entries.append({
        "name": "paged_decode_attention_d96", "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/paged_decode.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/paged_decode.py:175",
        "launches": launched["decode_d96_bf16"] + launched["decode_d96_f32"],
        "launches_by_store": {"bf16": launched["decode_d96_bf16"],
                              "f32": launched["decode_d96_f32"]},
        "max_abs_err": max(x["max_abs_err"] for x in d96),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "timed_case": "lm_large_decode_d96"})
    return entries


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
    phase (the build's start first: the builds then run on beside the
    kernels phase, which waits for each library it checks) and opens
    ``name``."""

    def __init__(self, phases):
        self.t0 = self.last = time.perf_counter()
        self.phases, self.current, self.seconds = phases, "build", {}

    def start(self, name):
        now = time.perf_counter()
        if self.current == "build" or self.current in self.phases:
            self.seconds[self.current] = now - self.last
        self.current, self.last = name, now


PHASES = ("kernels", "serve", "servequant", "servespec", "servegraph", "train", "lmtrain",
          "vittrain", "effnettrain", "fit", "warmup", "frontends", "launch", "trace", "bench",
          "realdata", "knobs", "fleet", "mesh", "generic")


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
    ap.add_argument("--mesh-child", nargs=2, metavar=("SPEC", "OUT"),
                    help="run one rank of the mesh phase's world (the mesh phase starts it)")
    args = ap.parse_args(argv)
    if args.mesh_child:
        mesh_child(*args.mesh_child)
        return 0
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
    # One nvcc per source, all started together; the kernels phase checks
    # each library as soon as its build ends, the shortest builds first,
    # so the longest builds (depthwise, paged_decode: 33-40 s) overlap the
    # other kernels' cases instead of delaying them.
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(name):
        t0 = time.perf_counter()
        _build.build(name)
        return time.perf_counter() - t0

    # ddl_native: the native IO tier's host library (csrc/ddl_native.cpp).
    names = ("paged_decode", "fused_block", "flash", "flash_packed", "fused_grads", "depthwise",
             "flash_generic", "fused_block_f32", "ddl_native")
    pool = ThreadPoolExecutor(len(names))
    builds = {name: pool.submit(timed_build, name) for name in names}

    def built(*libs):
        """Wait for ``libs``' builds (a failed build raises here) and print
        each one's seconds and ptxas lines once."""
        for name in libs:
            if name not in builds:
                continue
            sec = builds.pop(name).result()
            print(f"build {name} {sec:.1f}s", flush=True)
            for line in _build.build_log(name).splitlines():
                if ("registers" in line or "spill" in line or "Compiling entry" in line
                        or "Performance Loss" in line):
                    print(f"ptxas {name}:", line.strip(), flush=True)

    entries = []
    pd_cases = fb_cases = flash_cases = fp_cases = fg_cases = dw_cases = generic_cases = None
    clock.start("kernels")
    if "kernels" in phases:
        flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
        built("fused_block")
        fb_cases = fused_block_phase(fb, flush)
        built("flash")
        flash_cases = flash_phase(fl, flush)
        built("flash_packed")
        fp_cases = fp_phase(fp, fl, flush)
        built("fused_grads")
        fg_cases = fg_phase(fg, flush)
        built("paged_decode")
        pd_cases = kernel_phase(pd, flush)
        built("depthwise")
        dw_cases = dw_phase(dwm, flush)
        built("flash_generic", "fused_block_f32")
        generic_cases = generic_kernel_phase(fl, fp, fb, pd, flush)
        for c in (pd_cases + fb_cases + flash_cases + fp_cases + fg_cases + dw_cases
                  + generic_cases):
            print("case " + json.dumps(c), flush=True)
        del flush
        torch.cuda.empty_cache()
    built(*names)
    pool.shutdown()

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

    clock.start("servegraph")
    if "servegraph" in phases:
        servegraph_phase(pd, card)
        gc.collect()
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
        # 10 timed and 3 profiled steps: B4's step is 0.45 s, and the hook
        # pass runs it at full width again.
        line, state, step, batches, ds, cfg = effnet_train_fit(dwm, card, timed=10)
        profile_train(state, step, batches, card, line["step_ms"],
                      f"efficientnet_b4 train step, batch {line['batch']}, 380 px, bf16",
                      ("dwconv_",), steps=3)
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

    harness_lm = None
    clock.start("bench")
    if "bench" in phases:
        wall = bench_phase(card)
        harness_lm = wall.get("lm_base_synthetic_train_tokens_per_sec", {}).get("median")

    clock.start("realdata")
    if "realdata" in phases:
        real = realdata_phase(fb, fl, pd, card, harness=harness_lm)
        for e in entries:  # the same kernels' launches on the real-data plane
            if e["name"] in real:
                e["realdata_launches"] = real[e["name"]]
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("knobs")
    if "knobs" in phases:
        knobs = knobs_phase(fl, fp, fb, pd, card)
        for e in entries:  # the same kernels' launches a step on the knobs' paths
            if e["name"] in knobs:
                e["knobs_launches"] = knobs[e["name"]]
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("fleet")
    if "fleet" in phases:
        n = fleet_phase(pd, card)
        for e in entries:  # the decode kernel's launches replayed by the fleets
            if e["name"] == "paged_decode_attention":
                e["fleet_launches"] = n
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("mesh")
    if "mesh" in phases:
        meshed = mesh_phase(card)
        for e in entries:  # the kernels' launches a step a rank on the mesh engines
            got = {sc: n[e["name"]] for sc, n in meshed.items() if e["name"] in n}
            if got:
                e["mesh_launches"] = got
        gc.collect()
        torch.cuda.empty_cache()

    clock.start("generic")
    if "generic" in phases:
        launched = generic_phase(fl, fp, fb, pd, card)
        print("genericlaunches " + json.dumps(launched), flush=True)
        if generic_cases is not None:
            entries += _generic_entries(generic_cases, launched)
        gc.collect()
        torch.cuda.empty_cache()

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
