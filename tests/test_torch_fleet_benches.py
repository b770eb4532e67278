"""The port's fleet bench twins (``python -m
distributeddeeplearning_tpu_torch.fleet_bench``, ``disagg_bench``,
``chaos_bench``) against the JAX package's scripts, on the CPU.

Each pair runs at one tiny protocol (``lm_tiny``, a 64-token vocab, a
handful of requests; the port with ``BENCH_DEVICE=cpu``), a pair at a
time (port and JAX at once, one intra-op thread each, so the suite's
other workers keep their cores). Each port record carries the JAX record's keys
at every level (the same one-line JSON contract), the same gate names,
and the same values for the gates the seeded load decides on its own:
bitwise parity and completion. Timing gates (scaling, TTFT, cadence) are
compared by name only; the CPU's walls decide them.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = {"BENCH_VOCAB": "64", "SERVE_SEED": "0", "OMP_NUM_THREADS": "1",
          "SERVE_MAX_NEW": "4"}
# One prefill bucket each (the longest prompt): the JAX engines compile
# a program a bucket.
PROTOCOLS = {
    "fleet_bench": {"SERVE_REQUESTS": "12", "SERVE_REPLICAS": "2", "SERVE_BUCKETS": "20"},
    "disagg_bench": {"SERVE_REQUESTS": "6", "SERVE_REPLICAS": "3", "SERVE_BUCKETS": "24",
                     "BENCH_DISAGG_PREFIX_LEN": "4", "SERVE_PROFILE": "mixed"},
    "chaos_bench": {"SERVE_REQUESTS": "9", "SERVE_REPLICAS": "2", "SERVE_BUCKETS": "20",
                    "SERVE_CHAOS_PLAN": "crash:tick=3,replica=1;corrupt:tick=6,replica=0",
                    "SERVE_BROWNOUT_STAGES": "spec_off"},
}
# Gates the seeded backlog decides whatever the host's speed.
DETERMINISTIC = {
    "fleet_bench": ("parity", "no_drops"),
    "disagg_bench": ("parity_coloc", "parity_disagg", "completed_all", "programs_closed"),
    "chaos_bench": ("parity_non_shed", "completed_non_shed", "programs_closed"),
}


def _env(name, port):
    env = dict(os.environ, **COMMON, **PROTOCOLS[name])
    env.pop("OBS_DIR", None)
    if port:
        env["BENCH_DEVICE"] = "cpu"
    else:
        env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.fixture(scope="module")
def records():
    """Every bench's record and exit code, port and JAX."""
    out = {}
    for name in PROTOCOLS:
        procs = {
            (name, "port"): subprocess.Popen(
                [sys.executable, "-m", f"distributeddeeplearning_tpu_torch.{name}"],
                env=_env(name, True), cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
            (name, "jax"): subprocess.Popen(
                [sys.executable, os.path.join("scripts", f"{name}.py")],
                env=_env(name, False), cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True),
        }
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            lines = [ln for ln in stdout.splitlines() if ln.startswith('{"metric"')]
            assert lines, f"{key}: no record (rc {proc.returncode})\n{stderr[-3000:]}"
            out[key] = (json.loads(lines[-1]), proc.returncode, stderr)
    return out


def _paths(obj, prefix=()):
    """The record's key paths (list items by position's first element:
    per-replica rows share one shape)."""
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            out |= {prefix + (k,)} | _paths(v, prefix + (k,))
        return out
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return _paths(obj[0], prefix + ("[]",))
    return set()


# Keys whose sub-keys name things the load decides (tenants, chaos
# verbs, per-request rows), not the record's shape.
_FREE = ("fairness_at_contention", "chaos_fired", "brownout_transitions", "probe", "directory",
         "tenant_weights", "fairness")


def _shape(record):
    return {p for p in _paths(record) if not any(f in p[:-1] for f in _FREE)}


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_bench_twin_record_matches_jax(records, name):
    port, port_rc, port_err = records[(name, "port")]
    jax_rec, jax_rc, _ = records[(name, "jax")]
    assert "error" not in port, port_err[-3000:]
    assert "error" not in jax_rec
    assert port["metric"] == jax_rec["metric"] and port["unit"] == jax_rec["unit"]
    assert port["detail"]["platform"] == "cpu"
    missing = _shape(jax_rec) - _shape(port)
    extra = _shape(port) - _shape(jax_rec)
    assert not missing and not extra, (sorted(missing), sorted(extra))
    gates_p = port["detail"].get("gates", {})
    gates_j = jax_rec["detail"].get("gates", {})
    assert sorted(gates_p) == sorted(gates_j)
    for gate in DETERMINISTIC[name]:
        got = gates_p[gate] if gate in gates_p else port["detail"][gate]
        want = gates_j[gate] if gate in gates_j else jax_rec["detail"][gate]
        assert got == want is True, (gate, got, want)
    # exit codes agree wherever the timing gates do
    timing_p = {g: v for g, v in gates_p.items() if g not in DETERMINISTIC[name]}
    timing_j = {g: v for g, v in gates_j.items() if g not in DETERMINISTIC[name]}
    if timing_p == timing_j and name != "fleet_bench":
        assert port_rc == jax_rc


def test_fleet_bench_defaults_and_gates_match_jax(records):
    """The fleet bench's gate parameters are JAX's defaults."""
    port, _, _ = records[("fleet_bench", "port")]
    jax_rec, _, _ = records[("fleet_bench", "jax")]
    for key in ("scaling_min_multi_core", "ttft_max_ratio", "fairness_tol", "tenant_weights",
                "placement", "slots_per_replica", "buckets", "requests", "replicas"):
        assert port["detail"][key] == jax_rec["detail"][key], key
