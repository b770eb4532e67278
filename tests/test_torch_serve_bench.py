"""The port's serve harness (``python -m
distributeddeeplearning_tpu_torch.serve_bench``) on the CPU at a tiny
width (``lm_tiny``, vocab 256, six requests, ``BENCH_DEVICE=cpu``):

* each protocol prints one JSON line with the JAX script's record keys
  and metric name: continuous batching (paged, fused kernel), the
  dense/paged compare, the speculative compare with n-gram drafts and
  the int8 quantization compare; ``detail.platform`` names the device;
  every engine's program set is closed (``compile_count ==
  programs_expected``) and nothing was installed during the measure;
* the exit code follows the gates: 0 when they hold, 1 when one fails
  (an unreachable ``SERVE_SPEC_MIN_SPEEDUP``), with the record printed
  either way;
* without CUDA and without ``BENCH_DEVICE`` it prints the error record
  and exits non-zero.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributeddeeplearning_tpu_torch import serve_bench

ROOT = Path(__file__).resolve().parent.parent
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
RUN_KEYS = {"kv_layout", "tokens_per_sec", "parity", "slots", "peak_concurrent",
            "ttft_p50_ms", "ttft_p99_ms", "queue_wait_p50_ms", "queue_wait_p99_ms",
            "slot_occupancy_mean", "decode_steps", "compile_count", "programs_expected",
            "compiles_during_measure", "wall_s"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def env(monkeypatch):
    import os

    for k in list(os.environ):
        if k.startswith(("SERVE_", "BENCH_")) or k in ("SLO_SPEC", "OBS_DIR"):
            monkeypatch.delenv(k, raising=False)
    for k, v in {"BENCH_DEVICE": "cpu", "BENCH_VOCAB": "256", "SERVE_REQUESTS": "6",
                 "SERVE_MAX_NEW": "4"}.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def _run(capsys):
    rc = serve_bench.main([])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"metric"')]
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == RECORD_KEYS
    assert record["detail"]["platform"] == "cpu"
    return rc, record


def _closed(run):
    assert RUN_KEYS <= set(run)
    assert run["compile_count"] == run["programs_expected"]
    assert run["compiles_during_measure"] == 0


def test_continuous_paged_fused_record(env, capsys):
    env.setenv("SERVE_KV_LAYOUT", "paged")
    env.setenv("SERVE_DECODE_KERNEL", "fused")
    rc, record = _run(capsys)
    d = record["detail"]
    assert record["metric"] == "serve_continuous_tokens_per_sec"
    assert record["unit"] == "tokens/sec" and record["value"] > 0
    assert d["kv_layout"] == "paged" and d["decode_kernel"] == "fused"
    assert d["requests"] == 6 and d["buckets"] == [8, 16]
    assert d["sequential_tokens_per_sec"] > 0 and d["sequential_compiled_shapes"] >= 1
    _closed(d)
    assert d["pool"]["capacity_blocks"] > 0
    assert d["parity"] is True  # same streams as the sequential generate
    assert rc == 0


def test_compare_record_and_its_gate(env, capsys):
    env.setenv("SERVE_KV_LAYOUT", "compare")
    rc, record = _run(capsys)
    d = record["detail"]
    assert record["metric"] == "serve_paged_vs_dense_capacity"
    for run in (d["dense"], d["paged"]):
        _closed(run)
    assert d["dense"]["slots"] == 4 and d["paged"]["slots"] == 8
    assert d["parity"] is True
    ok = d["capacity_ratio"] >= 2.0 or d["tps_ratio"] >= 1.5
    assert rc == (0 if ok else 1)


def test_spec_ngram_record_and_failed_gate_exit_code(env, capsys):
    env.setenv("SERVE_SPEC_K", "2")
    env.setenv("SERVE_SPEC_DRAFT", "ngram")
    env.setenv("SERVE_SPEC_MIN_SPEEDUP", "1000")  # a gate that cannot hold
    rc, record = _run(capsys)
    d = record["detail"]
    assert record["metric"] == "serve_spec_vs_greedy_tokens_per_sec"
    assert d["spec_k"] == 2 and d["spec_draft"] == "ngram"
    for run in (d["greedy"], d["spec"]):
        _closed(run)
    assert d["spec"]["programs_expected"] == d["greedy"]["programs_expected"] + 1
    assert d["parity"] is True  # greedy speculation is lossless
    assert d["speedup"] < d["min_speedup"] == 1000.0
    assert rc == 1


def test_quant_compare_record(env, capsys):
    env.setenv("SERVE_KV_DTYPE", "int8")
    env.setenv("SERVE_WEIGHT_DTYPE", "int8")
    rc, record = _run(capsys)
    d = record["detail"]
    assert record["metric"] == "serve_int8_vs_bf16_tokens_per_sec"
    for run in (d["bf16"], d["int8"]):
        _closed(run)
    assert d["int8"]["slots"] > d["bf16"]["slots"]  # the same pool bytes hold more
    assert d["kv_slot_bytes"]["int8"] < d["kv_slot_bytes"]["bf16"]
    assert 0.0 <= d["match_rate"] <= 1.0 and d["weight_logit_err_max"] >= 0.0
    ok = d["match_rate"] >= d["match_rate_min"] and d["tps_ratio"] >= 1.0
    assert rc == (0 if ok else 1)


def test_no_cuda_exits_nonzero_without_bench_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = {k: v for k, v in __import__("os").environ.items()
           if not k.startswith(("SERVE_", "BENCH_"))}
    proc = subprocess.run([sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve_bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    record = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert record["value"] == 0.0 and "CUDA" in record["error"]
