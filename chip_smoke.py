#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: print ``nvidia-smi --query-gpu=name,power.limit`` and pin
   float32 matmuls and convolutions to full precision (no TF32).
2. Build the serving path's kernel from ``csrc/`` with ``nvcc`` for
   ``sm_90a``.
3. Kernel cases at lm_base shapes: the hand-written decode-attention
   kernel against its plain PyTorch version on the same device (run in
   f32 on the same bf16 inputs), with CUDA-event times of the kernel,
   the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only) beside the byte/operation bound.
4. Serving: full-width ``lm_base`` with seeded random weights behind
   ``Server.build`` (paged KV, fused kernel, 8 slots) answers 16
   requests. Checks: lengths and vocab range, the kernel ran exactly
   once per layer per forward (``launches == 12 × (prefills +
   decode_steps)``), each greedy stream equals the same request served
   alone, and the first request's first-token logits agree with a
   full-sequence plain re-forward.
5. The ``kernels`` JSON line, then the contract's last line
   ``{"ok": true, "device": {...}}``.

Exits with code 2 and prints no result when CUDA is absent or the port
is not importable (the script on its own, outside the repository).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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


def main() -> int:
    if not torch.cuda.is_available():
        _die("CUDA is not available; this smoke runs the port on an NVIDIA GPU")
    try:
        from distributeddeeplearning_tpu_torch.ops import _build
        from distributeddeeplearning_tpu_torch.ops import paged_decode as pd
    except ImportError as e:
        _die(f"the port is not importable from here ({e}); run from the repo root")

    card = device_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    t0 = time.perf_counter()
    _build.build("paged_decode")
    print(f"build paged_decode {time.perf_counter() - t0:.1f}s", flush=True)
    for line in _build.build_log("paged_decode").splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas", line.strip(), flush=True)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    cases = kernel_phase(pd, flush)
    for c in cases:
        print("case " + json.dumps(c), flush=True)
    del flush

    launches = serving_phase(pd, card)

    main_case = next(c for c in cases if c["case"] == "paged_decode_full")
    entry = {
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "distributeddeeplearning_tpu_torch/csrc/paged_decode.cu",
        "replaces": "distributeddeeplearning_tpu/ops/pallas/paged_decode.py:175",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "timed_case": main_case["case"],
    }
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
