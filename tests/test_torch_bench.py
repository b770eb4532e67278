"""The port's bench harness (``python -m distributeddeeplearning_tpu_torch.bench``)
at a tiny size with ``BENCH_DEVICE=cpu``:

* each mode (vision, LM, decode) prints one JSON line carrying
  ``bench.py``'s record keys and metric name, ``detail.platform`` the
  device it ran on, and for the training modes ``host_sync_count == 1``
  (the closing readback; counted under ``hostsync.track()``);
* without CUDA and without ``BENCH_DEVICE`` it prints the error record
  and exits non-zero (no CPU fallback);
* the batch steps down on ``torch.cuda.OutOfMemoryError`` only: any
  other error is recorded, raised and not retried.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributeddeeplearning_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent
# bench.py's record keys (its training records, bench.py:351-370 and 654-677)
TRAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "compile_sec", "host_sync_count",
              "accum_steps", "effective_batch", "detail"}
BENCH_VARS = ("BENCH_DEVICE", "BENCH_MODEL", "BENCH_DECODE", "BENCH_BATCH", "BENCH_DEPTH",
              "BENCH_IMAGE_SIZE", "BENCH_SEQ_LEN", "BENCH_VOCAB", "BENCH_PROMPT_LEN",
              "BENCH_NEW_TOKENS", "BENCH_PROFILE", "ACCUM_STEPS", "ATTN_IMPL", "OBS_DIR")



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture
def env(monkeypatch):
    for k in BENCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    return monkeypatch


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_vision_record(env, capsys):
    env.setenv("BENCH_DEPTH", "18")
    env.setenv("BENCH_IMAGE_SIZE", "32")
    env.setenv("BENCH_BATCH", "2")
    env.setenv("ACCUM_STEPS", "2")
    assert bench.main([]) == 0
    (rec,) = _records(capsys)
    assert set(rec) == TRAIN_KEYS
    assert rec["metric"] == "resnet18_32px_smoke_images_per_sec" and rec["unit"] == "images/sec"
    assert rec["host_sync_count"] == 1
    assert rec["accum_steps"] == 2 and rec["effective_batch"] == 2
    assert rec["value"] > 0 and rec["compile_sec"] > 0 and rec["vs_baseline"] == 0.0
    assert rec["detail"]["platform"] == "cpu" and rec["detail"]["per_device_batch"] == 2
    assert rec["detail"]["smoke_overrides"] is True


def test_lm_record(env, capsys):
    env.setenv("BENCH_MODEL", "lm_tiny")
    env.setenv("BENCH_SEQ_LEN", "32")
    env.setenv("BENCH_VOCAB", "64")
    env.setenv("BENCH_BATCH", "2")
    assert bench.main([]) == 0
    (rec,) = _records(capsys)
    assert set(rec) == TRAIN_KEYS
    assert rec["metric"] == "lm_tiny_synthetic_train_tokens_per_sec"
    assert rec["host_sync_count"] == 1 and rec["effective_batch"] == 2
    assert rec["detail"]["attn_impl"] == "xla"  # the CPU default, as JAX's off the TPU
    assert rec["detail"]["platform"] == "cpu" and rec["detail"]["seq_len"] == 32


def test_decode_record(env, capsys):
    env.setenv("BENCH_DECODE", "1")
    env.setenv("BENCH_MODEL", "lm_tiny")
    env.setenv("BENCH_VOCAB", "64")
    env.setenv("BENCH_BATCH", "2")
    env.setenv("BENCH_PROMPT_LEN", "8")
    env.setenv("BENCH_NEW_TOKENS", "4")
    assert bench.main([]) == 0
    (rec,) = _records(capsys)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "lm_tiny_decode_tokens_per_sec" and rec["value"] > 0
    assert rec["detail"] == {"batch": 2, "prompt_len": 8, "new_tokens": 4, "platform": "cpu"}


def test_canonical_metric_names_match_bench_py(env):
    sys.path.insert(0, str(ROOT))
    import bench as jax_bench

    for extra in ({}, {"BENCH_MODEL": "resnet50"}, {"BENCH_MODEL": "vit_b16"},
                  {"BENCH_DEPTH": "18"}, {"BENCH_MODEL": "lm_base"},
                  {"BENCH_DECODE": "1", "BENCH_MODEL": "lm_small"}):
        for k in ("BENCH_MODEL", "BENCH_DEPTH", "BENCH_DECODE"):
            env.delenv(k, raising=False)
        for k, v in extra.items():
            env.setenv(k, v)
        assert bench._intended_metric() == jax_bench._intended_metric(), extra
    assert bench.REFERENCE_IMAGES_PER_SEC_PER_DEVICE == jax_bench.REFERENCE_IMAGES_PER_SEC_PER_DEVICE
    assert (bench.WARMUP_STEPS, bench.MEASURE_STEPS) == (jax_bench.WARMUP_STEPS,
                                                         jax_bench.MEASURE_STEPS)


def test_no_cuda_exits_nonzero_without_bench_device():
    env = {k: v for k, v in os.environ.items() if k not in BENCH_VARS}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m", "distributeddeeplearning_tpu_torch.bench"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    (line,) = [x for x in res.stdout.splitlines() if x.startswith("{")]
    rec = json.loads(line)
    assert rec["metric"] == "resnet50_synthetic_train_images_per_sec"
    assert rec["value"] == 0.0 and "CUDA" in rec["error"]


def test_only_oom_steps_the_batch_down(env, capsys):
    calls = []

    def oom_then_ok(per_device_batch, device, profile_dir=None, **kw):
        calls.append(per_device_batch)
        if per_device_batch > 64:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return 100.0, 1, {"compile_sec": 1.0, "host_sync_count": 1, "accum_steps": 1,
                          "effective_batch": per_device_batch}

    env.setattr(bench, "run_bench", oom_then_ok)
    assert bench.main([]) == 0
    assert calls == [256, 128, 64]
    (rec,) = _records(capsys)
    assert rec["detail"]["per_device_batch"] == 64 and rec["vs_baseline"] == round(100 / 325, 3)

    calls.clear()

    def broken(per_device_batch, device, profile_dir=None, **kw):
        calls.append(per_device_batch)
        raise ValueError("kernel disagrees")

    env.setattr(bench, "run_bench", broken)
    with pytest.raises(ValueError, match="kernel disagrees"):
        bench.main([])
    assert calls == [256]  # not retried at a smaller batch
    (rec,) = _records(capsys)
    assert rec["value"] == 0.0 and "kernel disagrees" in rec["error"]
