"""Benchmark harness of the port: emits ONE JSON line with the canonical
metric, as the repo's ``bench.py`` does for the JAX package.

    python -m distributeddeeplearning_tpu_torch.bench [--events]

Three modes, with ``bench.py``'s env knobs, metric names and record keys
(``metric``, ``value``, ``unit``, ``vs_baseline``, ``compile_sec``,
``host_sync_count``, ``accum_steps``, ``effective_batch``, ``detail``):

* **vision** (default): ResNet-50 (unfused, as the JAX default builds
  it) training at 224 px in bf16 on one staged batch of seeded random
  images, metric ``resnet50_synthetic_train_images_per_sec``;
  ``BENCH_DEPTH``, ``BENCH_IMAGE_SIZE`` and ``BENCH_MODEL`` (a vision
  model of the registry) name other protocols (``_vision_protocol``).
  The per-device batch steps down 256, 128, 64, 32 (``BENCH_BATCH``
  pins one). ``vs_baseline`` is images/s per device over 325, the
  reference's ResNet-50 fp32 V100 estimate;
* **LM** (``BENCH_MODEL=lm_*``): tokens/s of a decoder LM on seeded
  random tokens, T = ``BENCH_SEQ_LEN`` (1024), vocab ``BENCH_VOCAB``
  (32,000), ``ATTN_IMPL`` defaulting to ``pallas`` (the flash kernels)
  on the card, batch 8, 4, 2, 1;
* **decode** (``BENCH_DECODE=1``): generated tokens/s through
  ``inference.generate`` on the dense cache (no kernel, as in JAX).

Each training protocol first captures the step as CUDA graphs (the
port's counterpart of ``bench.py``'s AOT compile, ``bench.py:140-146``:
``metrics.StepFn.aot_compile``, warm-up steps on the capture stream
included), then runs 3 warm-up and 20 timed replays of one staged
batch; the timed window closes with one host readback of the loss, and
``host_sync_count`` counts the materialisations inside it under
``utils/hostsync.track()`` (1 when the step is sync-free).
``compile_sec`` is the capture's seconds, the first kernel builds
included; ``COMPILATION_CACHE_DIR`` makes re-runs load the kernel
libraries built there instead of running ``nvcc`` again
(``training/warmup.enable_persistent_cache``), and the record's
``detail`` then carries the cache's hits and misses. On the CPU (``BENCH_DEVICE=cpu``) there is no graph: the
warm-up step runs in its place and the timed steps run eager. ``ACCUM_STEPS``
sets in-step accumulation. ``BENCH_PROFILE=DIR`` writes a
``torch.profiler`` Chrome trace of the timed window there. ``--events``
(or ``OBS_DIR``) routes every record and span through the event bus.

Two departures from ``bench.py``, on purpose:

(a) OOM only: the batch step-down catches ``torch.cuda.OutOfMemoryError``
    and nothing else (``bench.py`` retries on any exception); an OOM
    during the capture discards the graphs and their pool before the
    smaller batch. Any other failure (a failed capture included) prints
    the error record and raises, exiting non-zero, so a kernel that fails
    never passes as a smaller batch.
(b) No CPU fallback: without CUDA the harness prints the error record
    and exits non-zero, unless ``BENCH_DEVICE=cpu`` asks for the CPU
    (the tests do); ``detail.platform`` then says ``"cpu"``.

One process drives one GPU, so ``detail.devices`` is 1 and
``BENCH_SCALING`` (a multi-device comparison in ``bench.py``) has no
effect, as in ``bench.py`` on one device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

REFERENCE_IMAGES_PER_SEC_PER_DEVICE = 325.0  # V100 fp32 ResNet50, reference stack
WARMUP_STEPS = 3
MEASURE_STEPS = 20


def _emit_record(record: dict) -> None:
    """THE output path of every record: the JSON line on stdout plus a
    ``bench_result`` point (and accumulation gauges) on the bus."""
    print(json.dumps(record), flush=True)
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.get_bus()
    bus.point("bench_result", **record)
    if "accum_steps" in record:
        bus.gauge("bench.accum_steps", float(record["accum_steps"]))
    if "effective_batch" in record:
        bus.gauge("bench.effective_batch", float(record["effective_batch"]))
    bus.flush()


def _accum_steps_env() -> int:
    return max(int(os.environ.get("ACCUM_STEPS", "1")), 1)


def _device() -> torch.device:
    """``BENCH_DEVICE`` (default ``cuda``); a CUDA device without CUDA
    raises (no fallback)."""
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device

    return resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(step, state, batch, device, profile_dir=None):
    """The protocol shared by the training modes: the step captured
    (``compile_sec``; an OOM there drops the graphs before it
    propagates), the warm-up, a fence, then ``MEASURE_STEPS`` steps
    closed by one host readback, under ``hostsync.track()``. Returns
    ``(seconds, compile_sec, host_sync_count, graphs)``."""
    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.utils import hostsync

    with obs.span("compile", what="bench_step"):
        try:
            captured, compile_sec = step.aot_compile(state, batch)
        except torch.cuda.OutOfMemoryError:
            step.discard()
            raise
    for _ in range(WARMUP_STEPS):
        state, metrics = step(state, batch)
    float(hostsync.device_get(metrics["loss"], label="bench_fence"))

    prof = contextlib.nullcontext()
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
    sync0 = hostsync.accountant().count
    with prof as p, hostsync.track(), obs.span("bench_measure", steps=MEASURE_STEPS):
        t0 = time.perf_counter()
        for _ in range(MEASURE_STEPS):
            state, metrics = step(state, batch)
        loss = float(hostsync.device_get(metrics["loss"], label="bench_fence"))
        dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} after the timed steps")
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        p.export_chrome_trace(os.path.join(profile_dir, "bench_trace.json"))
    if step.eager_calls:
        raise RuntimeError(f"{step.eager_calls} step(s) found no graph for their signature")
    return dt, compile_sec, int(hostsync.accountant().count - sync0), captured.graphs


def run_bench(per_device_batch: int, device: torch.device, profile_dir=None, *,
              model_name=None, depth: int = 50, image_size: int = 224):
    """Images/s of one vision training protocol: ``(images_per_sec,
    n_dev, perf)``."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import to_device
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    n_dev = 1
    global_batch = per_device_batch * n_dev
    cfg = TrainConfig(batch_size_per_device=per_device_batch, image_size=image_size,
                      accum_steps=_accum_steps_env())
    name = model_name or f"resnet{depth}"
    model = get_model(name, num_classes=1000, dtype=torch.bfloat16, image_size=image_size,
                      device=device)
    tx, _ = create_optimizer(cfg, steps_per_epoch=cfg.steps_per_epoch())
    state = create_train_state(model, cfg, tx, device=device)
    step = make_train_step(model, tx, cfg, device=device)
    rng = np.random.RandomState(42)
    host_batch = (
        # f32 on the host; the model's first op casts to bf16 on the device
        rng.uniform(-1, 1, size=(global_batch, image_size, image_size, 3)).astype(np.float32),
        rng.randint(0, 1000, size=(global_batch,)).astype(np.int32),
    )
    batch = to_device(host_batch, device)
    dt, compile_sec, syncs, graphs = _timed_steps(step, state, batch, device, profile_dir)
    perf = {"compile_sec": round(compile_sec, 3), "host_sync_count": syncs,
            "accum_steps": cfg.accum_steps, "effective_batch": global_batch,
            "graphs_captured": graphs}
    return MEASURE_STEPS * global_batch / dt, n_dev, perf


def run_lm_bench(model_name: str, per_device_batch: int, seq_len: int, attn_impl: str,
                 device: torch.device, profile_dir=None):
    """Tokens/s of a decoder LM on seeded random tokens: ``(tokens_per_sec,
    n_dev, perf)``."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import to_device
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    vocab = int(os.environ.get("BENCH_VOCAB", "32000"))
    n_dev = 1
    global_batch = per_device_batch * n_dev
    cfg = TrainConfig(model=model_name, batch_size_per_device=per_device_batch,
                      attn_impl=attn_impl, num_classes=vocab, accum_steps=_accum_steps_env())
    model = get_model(model_name, **cfg.model_kwargs(), max_seq_len=seq_len, device=device)
    tx, _ = create_optimizer(cfg, steps_per_epoch=64)
    state = create_train_state(model, cfg, tx, device=device)
    step = make_train_step(model, tx, cfg, device=device)
    rng = np.random.RandomState(42)
    rows = rng.randint(0, vocab, size=(global_batch, seq_len + 1)).astype(np.int32)
    batch = to_device((rows[:, :-1], rows[:, 1:]), device)
    dt, compile_sec, syncs, graphs = _timed_steps(step, state, batch, device, profile_dir)
    perf = {"compile_sec": round(compile_sec, 3), "host_sync_count": syncs,
            "accum_steps": cfg.accum_steps, "effective_batch": global_batch,
            "graphs_captured": graphs}
    return MEASURE_STEPS * global_batch * seq_len / dt, n_dev, perf


def run_decode_bench(model_name: str, batch: int, prompt_len: int, new_tokens: int,
                     device: torch.device) -> float:
    """Generated tokens/s through ``inference.generate`` (dense cache)."""
    from distributeddeeplearning_tpu_torch.inference import generate
    from distributeddeeplearning_tpu_torch.models import convert, get_model
    from distributeddeeplearning_tpu_torch.serving import keys

    vocab = int(os.environ.get("BENCH_VOCAB", "32000"))
    max_len = prompt_len + new_tokens
    model = get_model(model_name, num_classes=vocab, max_seq_len=max_len, device=device)
    model.load_state_dict(convert.init_params(
        model.variant, vocab, torch.Generator(device=device).manual_seed(0), max_len))
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, vocab, size=(batch, prompt_len)).astype(np.int32)
    kw = dict(max_new_tokens=new_tokens, temperature=0.8, top_k=40)
    with torch.no_grad():
        out = generate(model, prompt, rng=keys.key_from_seed(1), **kw)  # warm-up
        int(out[0, -1])
        t0 = time.perf_counter()
        reps = 3
        for i in range(reps):
            out = generate(model, prompt, rng=keys.key_from_seed(2 + i), **kw)
        int(out[0, -1])  # fence
        dt = time.perf_counter() - t0
    return reps * batch * new_tokens / dt


def _vision_protocol():
    """The vision knobs, resolved once for the success and the failure
    records (``bench.py``'s derivation)."""
    depth = int(os.environ.get("BENCH_DEPTH", "50"))
    image_size = int(os.environ.get("BENCH_IMAGE_SIZE", "224"))
    vision_model = os.environ.get("BENCH_MODEL") or None
    if vision_model == "resnet50":
        vision_model = None
    canonical = depth == 50 and image_size == 224 and not vision_model
    if canonical:
        metric = "resnet50_synthetic_train_images_per_sec"
    elif vision_model:
        metric = f"{vision_model}_{image_size}px_images_per_sec"
    else:
        metric = f"resnet{depth}_{image_size}px_smoke_images_per_sec"
    return vision_model, depth, image_size, canonical, metric


def _intended_metric():
    """``(metric, unit)`` the env selects, resolvable before any device
    work, so a failure record names the protocol asked for."""
    model = os.environ.get("BENCH_MODEL", "")
    if os.environ.get("BENCH_DECODE", "") == "1":
        return f"{model or 'lm_small'}_decode_tokens_per_sec", "tokens/sec"
    if model.startswith("lm_"):
        return f"{model}_synthetic_train_tokens_per_sec", "tokens/sec"
    return _vision_protocol()[4], "images/sec"


def _released(e: BaseException) -> BaseException:
    """The error without its traceback, whose frames hold the failed
    protocol's model, state and graphs."""
    return type(e)(str(e))


def _graphs(perf: dict) -> dict:
    """``graphs_captured`` moved from the protocol's ``perf`` to the
    record's ``detail`` (the top-level keys are ``bench.py``'s)."""
    return {"graphs_captured": perf.pop("graphs_captured")} if "graphs_captured" in perf else {}


def _cache_detail() -> dict:
    """The library cache's hits and misses this process, when
    ``COMPILATION_CACHE_DIR`` is set."""
    if not os.environ.get("COMPILATION_CACHE_DIR"):
        return {}
    from distributeddeeplearning_tpu_torch.training.warmup import cache_stats

    hits, misses = cache_stats()
    return {"persistent_cache_hits": hits, "persistent_cache_misses": misses}


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def decode_main(device: torch.device) -> int:
    model_name = os.environ.get("BENCH_MODEL", "lm_small")
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    prompt_len = int(os.environ.get("BENCH_PROMPT_LEN", "128"))
    new_tokens = int(os.environ.get("BENCH_NEW_TOKENS", "128"))
    tps = run_decode_bench(model_name, batch, prompt_len, new_tokens, device)
    _emit_record({
        "metric": f"{model_name}_decode_tokens_per_sec", "value": round(tps, 1),
        "unit": "tokens/sec", "vs_baseline": 0.0,  # the reference has no inference path
        "detail": {"batch": batch, "prompt_len": prompt_len, "new_tokens": new_tokens,
                   "platform": device.type},
    })
    return 0


def lm_main(device: torch.device) -> int:
    model_name = os.environ["BENCH_MODEL"]
    seq_len = int(os.environ.get("BENCH_SEQ_LEN", "1024"))
    attn_impl = os.environ.get("ATTN_IMPL", "pallas" if device.type == "cuda" else "xla")
    batches = (8, 4, 2, 1)
    if "BENCH_BATCH" in os.environ:
        batches = (int(os.environ["BENCH_BATCH"]),)
    profile_dir = os.environ.get("BENCH_PROFILE") or None
    last_err: Optional[BaseException] = None
    for per_device_batch in batches:
        try:
            tps, n_dev, perf = run_lm_bench(model_name, per_device_batch, seq_len, attn_impl,
                                            device, profile_dir)
        except torch.cuda.OutOfMemoryError as e:
            last_err = _released(e)
            _free(device)
            continue
        graphs = _graphs(perf)
        _emit_record({
            "metric": f"{model_name}_synthetic_train_tokens_per_sec",
            "value": round(tps, 1),
            "unit": "tokens/sec",  # no reference point: the reference is vision-only
            "vs_baseline": 0.0,
            **perf,
            "detail": {"devices": n_dev, "per_device_batch": per_device_batch,
                       "seq_len": seq_len, "attn_impl": attn_impl,
                       "tokens_per_sec_per_device": round(tps / n_dev, 1),
                       "platform": device.type, **graphs, **_cache_detail()},
        })
        return 0
    _emit_record({"metric": f"{model_name}_synthetic_train_tokens_per_sec", "value": 0.0,
                  "unit": "tokens/sec", "vs_baseline": 0.0, "error": repr(last_err)})
    return 1


def vision_main(device: torch.device) -> int:
    batches = (256, 128, 64, 32)
    if "BENCH_BATCH" in os.environ:
        batches = (int(os.environ["BENCH_BATCH"]),)
    profile_dir = os.environ.get("BENCH_PROFILE") or None
    vision_model, depth, image_size, canonical, metric = _vision_protocol()
    last_err: Optional[BaseException] = None
    for per_device_batch in batches:
        try:
            ips, n_dev, perf = run_bench(per_device_batch, device, profile_dir,
                                         model_name=vision_model, depth=depth,
                                         image_size=image_size)
        except torch.cuda.OutOfMemoryError as e:
            last_err = _released(e)
            _free(device)
            continue
        graphs = _graphs(perf)
        per_chip = ips / n_dev
        detail = {"devices": n_dev, "world_size": n_dev, "per_device_batch": per_device_batch,
                  "images_per_sec_per_device": round(per_chip, 1),
                  "platform": device.type, "image_size": image_size,
                  **graphs, **_cache_detail()}
        if vision_model:
            detail["model"] = vision_model
        else:
            detail["model_depth"] = depth
            detail["baseline_images_per_sec_per_device"] = REFERENCE_IMAGES_PER_SEC_PER_DEVICE
            if not canonical:
                detail["smoke_overrides"] = True
        _emit_record({
            "metric": metric, "value": round(ips, 1), "unit": "images/sec",
            "vs_baseline": (round(per_chip / REFERENCE_IMAGES_PER_SEC_PER_DEVICE, 3)
                            if canonical else 0.0),
            **perf, "detail": detail,
        })
        return 0
    _emit_record({"metric": metric, "value": 0.0, "unit": "images/sec", "vs_baseline": 0.0,
                  "error": repr(last_err)})
    return 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--events" in argv or os.environ.get("OBS_DIR"):
        from distributeddeeplearning_tpu_torch import obs

        if not os.environ.get("OBS_DIR"):
            os.environ["OBS_DIR"] = os.path.join("runs", f"bench-{int(time.time())}")
        obs.configure_from_env()
    if os.environ.get("COMPILATION_CACHE_DIR"):
        # The kernel-library cache: re-runs load what an earlier run built.
        from distributeddeeplearning_tpu_torch.training.warmup import enable_persistent_cache

        enable_persistent_cache(os.environ["COMPILATION_CACHE_DIR"])
    metric, unit = _intended_metric()
    try:
        device = _device()
        if os.environ.get("BENCH_DECODE", "") == "1":
            return decode_main(device)
        if os.environ.get("BENCH_MODEL", "").startswith("lm_"):
            return lm_main(device)
        return vision_main(device)
    except Exception as e:  # the harness boundary: record the failure, then re-raise
        _emit_record({"metric": metric, "value": 0.0, "unit": unit, "vs_baseline": 0.0,
                      "error": repr(e)})
        raise


if __name__ == "__main__":
    sys.exit(main())
