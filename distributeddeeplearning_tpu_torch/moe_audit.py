"""MoE efficiency audit: where an MoE LM's step time goes beside the
dense one (the port's twin of the JAX package's ``scripts/moe_audit.py``).

Trains dense ``lm_<variant>`` and ``lm_moe_<variant>`` (8 experts) on
seeded synthetic tokens through the port's train step, across the
routing design space (top-1 and top-2, a capacity-factor sweep), and
prints for each: tokens/s and step ms (the host clock over timed steps
closed by one readback; on the card the step is captured as a CUDA graph
first, as the harness times it, so the device sets the rate), device ms
a step by kernel family (one step under ``torch.profiler`` on the card),
and the bytes of the routing machinery, which exists in the MoE step and
not in the dense one: the
f32 dispatch and combine tensors ``[B, S, E, C]`` and the expert-major
activations ``[E, B, C, D]`` in and out, each written once and read once
in the forward and the same again in the backward.

    python -m distributeddeeplearning_tpu_torch.moe_audit [--seq-len 1024] [--batch 8]
        [--variant small] [--steps 10] [--device cpu]

One JSON line a variant (``moe_audit ...``) and a table. The card's
attention is ``pallas`` and its dtype bf16; the CPU's ``xla`` and f32.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

VOCAB = 32_000
EXPERTS = 8
VARIANTS = (
    ("moe top2 cf1.25 (default)", dict(moe_top_k=2, moe_capacity_factor=1.25)),
    ("moe top1 cf1.25", dict(moe_top_k=1, moe_capacity_factor=1.25)),
    ("moe top2 cf1.0", dict(moe_top_k=2, moe_capacity_factor=1.0)),
    ("moe top2 cf2.0", dict(moe_top_k=2, moe_capacity_factor=2.0)),
    ("moe top1 cf2.0", dict(moe_top_k=1, moe_capacity_factor=2.0)),
)
# Kernel families by name, first match wins.
_FAMILIES = (
    ("flash", ("flash",)),
    ("gemm", ("gemm", "nvjet", "sm90_", "cutlass", "xmma", "matmul", "gemv")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce", "cumsum", "scan")),
    ("copy", ("copy", "memcpy", "memset", "cat", "index")),
    ("elementwise", ("elementwise", "vectorized", "fill")),
)


def family(name: str) -> str:
    """The family of a device kernel's name."""
    low = name.lower()
    for fam, marks in _FAMILIES:
        if any(m in low for m in marks):
            return fam
    return "other"


def routing_bytes(batch: int, seq: int, experts: int, top_k: int, cf: float,
                  hidden: int, layers: int) -> Dict[str, float]:
    """The routing machinery's bytes a step (all MoE layers): f32
    dispatch and combine ``[B, S, E, C]`` and bf16 expert-major in and out
    ``[E, B, C, D]``, one write and one read each, forward and backward."""
    c = max(int(math.ceil(min(top_k, experts) * seq / experts * cf)), 1)
    onehot = batch * seq * experts * c * 4 * 2
    expert_io = experts * batch * c * hidden * 2 * 2
    per_pass = 2 * (onehot + expert_io)  # a write and a read
    return {"capacity": c, "dispatch_combine_bytes": onehot, "expert_io_bytes": expert_io,
            "routing_bytes_per_step": 2 * per_pass * layers}


def measure(model_name: str, seq: int, batch: int, steps: int = 10, device="cuda",
            **model_kw) -> Dict[str, object]:
    """One model's train steps on ``device``: tokens/s, step ms, device
    ms a step by kernel family (the card), peak memory (the card)."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    on_card = torch.device(device).type == "cuda"
    cfg = TrainConfig(model=model_name, batch_size_per_device=batch, num_classes=VOCAB,
                      attn_impl="pallas" if on_card else "xla",
                      compute_dtype="bfloat16" if on_card else "float32")
    model = get_model(model_name, **cfg.model_kwargs(), max_seq_len=seq, device=device,
                      **model_kw)
    tx, _ = create_optimizer(cfg, steps_per_epoch=64)
    state = create_train_state(model, cfg, tx, device=device)
    step = make_train_step(model, tx, cfg, device=device)
    rows = np.random.RandomState(42).randint(0, VOCAB, size=(batch, seq + 1)).astype(np.int32)
    tokens = torch.as_tensor(rows[:, :-1], device=device)
    labels = torch.as_tensor(rows[:, 1:], device=device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        # Captured before any eager step, as fit does: its warm-up steps
        # run on the capture stream (eager MoE steps first made the
        # capture fail on the card, cudaErrorStreamCaptureImplicit).
        step.aot_compile(state, (tokens, labels))
    for _ in range(3):
        state, m = step(state, (tokens, labels))
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, (tokens, labels))
    loss = float(m["loss"])
    dt = (time.perf_counter() - t0) / steps
    by_family: object = "not measured"
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, m = step(state, (tokens, labels))
            torch.cuda.synchronize()
        by_family = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                fam = family(e.key)
                by_family[fam] = by_family.get(fam, 0.0) + e.device_time_total / 1e3
    if on_card and step.eager_calls:
        raise RuntimeError(f"{model_name}: {step.eager_calls} steps missed the captured graph")
    out = {"model": model_name, "tok_s": batch * seq / dt, "step_ms": dt * 1e3,
           "loss": loss, "device_ms_by_family": by_family,
           "device_ms": (sum(by_family.values()) if isinstance(by_family, dict)
                         else "not measured"),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if on_card else "not measured"}
    del state, step, model
    if on_card:
        torch.cuda.empty_cache()
    return out


def audit(seq: int = 1024, batch: int = 8, variant: str = "small", steps: int = 10,
          device="cuda", variants=VARIANTS) -> List[Dict[str, object]]:
    """Dense ``lm_<variant>`` then each MoE variant; prints one
    ``moe_audit`` JSON line each and the table; returns the rows."""
    from distributeddeeplearning_tpu_torch.models.transformer_lm import _VARIANTS

    hidden, depth = _VARIANTS[variant][:2]
    dense = measure(f"lm_{variant}", seq, batch, steps, device)
    rows = [dict(dense, label=f"lm_{variant} (dense)", vs_dense=1.0)]
    for label, kw in variants:
        r = measure(f"lm_moe_{variant}", seq, batch, steps, device, moe_experts=EXPERTS, **kw)
        r.update(label=label, vs_dense=r["tok_s"] / dense["tok_s"], **kw,
                 **routing_bytes(batch, seq, EXPERTS, kw["moe_top_k"],
                                 kw["moe_capacity_factor"], hidden, depth // 2))
        rows.append(r)
    for r in rows:
        print("moe_audit " + json.dumps(dict(r, seq=seq, batch=batch)), flush=True)
    print(f"{'variant':28s} {'tok/s':>9s} {'ms':>8s} {'dev ms':>8s} {'vs dense':>8s} "
          f"{'cap':>4s} {'routing GB':>10s}", flush=True)
    for r in rows:
        dev = r["device_ms"]
        print(f"{r['label']:28s} {r['tok_s']:9.0f} {r['step_ms']:8.2f} "
              f"{dev if isinstance(dev, str) else f'{dev:8.2f}':>8s} {r['vs_dense']:8.3f} "
              f"{r.get('capacity', '-')!s:>4s} "
              f"{r.get('routing_bytes_per_step', 0) / 1e9:10.3f}", flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--variant", default="small")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device

    audit(args.seq_len, args.batch, args.variant, args.steps, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
