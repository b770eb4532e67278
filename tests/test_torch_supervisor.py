"""The port's restart supervisor (``launch.launch_supervised``), twins of
the supervisor tests of ``tests/test_faults.py`` over
``tests/_torch_fault_child.py`` (the port's ``faults`` and ``obs``, no
torch): the exit-code table against JAX's for every code in -64..255,
SIGKILL then restart then resume, 121 terminal, a watchdog-killed hang
recovered, the budget spent, one ``COMPILATION_CACHE_DIR`` across
attempts whose restart loads the library the first attempt built, and a
silent kernel build kept alive under the watchdog by its heartbeat.

The child prints before it imports anything, so a hang timeout never
measures interpreter start; the hang drills wait on the fault itself.
"""

import json
import os
import stat
import subprocess
import sys
import textwrap

import pytest

from distributeddeeplearning_tpu_torch import faults

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = "tests/_torch_fault_child.py"


def _run(args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.launch", "--platform", "cpu",
         *args], cwd=REPO_ROOT, capture_output=True, text=True, timeout=timeout)


def test_exit_table_equals_jax():
    from distributeddeeplearning_tpu import faults as jax_faults

    for name in ("EXIT_OK", "EXIT_NONFINITE", "EXIT_TIMEOUT", "EXIT_HUNG", "EXIT_INTERRUPTED",
                 "EXIT_RESIZE"):
        assert getattr(faults, name) == getattr(jax_faults, name), name
    for rc in range(-64, 256):
        mine, ref = faults.classify_exit(rc), jax_faults.classify_exit(rc)
        assert (mine.rc, mine.retryable, mine.reason) == (ref.rc, ref.retryable, ref.reason), rc
        assert faults.normalize_rc(rc) == jax_faults.normalize_rc(rc), rc
    assert faults.classify_exit(-9).reason == "signal_SIGKILL"
    assert faults.normalize_rc(-9) == 137


def test_supervisor_restarts_after_sigkill_and_resumes(tmp_path):
    """SIGKILL of process 1 after step 3 kills the world; the supervisor
    restarts it with resume, and the relaunched rank continues from its
    persisted step; the black box, per-attempt files and one merged
    timeline are left behind."""
    from distributeddeeplearning_tpu_torch.obs import render, summarize
    from distributeddeeplearning_tpu_torch.obs.report import load

    obs_dir = tmp_path / "run"
    res = _run(["-n", "2", "--max-restarts", "2", "--restart-backoff", "0.1", "--timeout", "120",
                "--obs-dir", str(obs_dir), "--env", "FAULT_PLAN=kill:step=3,rank=1",
                "--env", f"STATE_FILE={tmp_path}/state", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "supervisor: attempt 0 failed (rc=-9, signal_SIGKILL" in out
    assert "restarting in 0.1s" in out
    assert "FAULT_CHILD_DONE 1 start=3" in out, out[-4000:]
    assert "FAULT_CHILD_DONE 0" in out
    head = json.loads(open(obs_dir / "flight-p1.jsonl").readline())
    assert head["reason"] == "fault_kill"
    for name in ("events-p1.jsonl", "events-p1-r1.jsonl", "events-supervisor.jsonl"):
        assert (obs_dir / name).exists(), name
    recs = [json.loads(ln) for ln in open(obs_dir / "events.jsonl")]
    names = {r.get("name") for r in recs}
    assert {"attempt_start", "attempt_exit", "restart_scheduled", "fault_fired",
            "world_exit"} <= names
    assert len({r["run"] for r in recs if r.get("kind") == "meta"}) == 1
    text = render(summarize(load([str(obs_dir)])))
    assert "restart_scheduled" in text and "supervisor" in text


def test_supervisor_treats_nonfinite_exit_as_terminal():
    """121 (the non-finite guard's code) is not retried: a resume would
    replay the same NaN."""
    res = _run(["-n", "1", "--max-restarts", "3", "--restart-backoff", "0.1", "--timeout", "120",
                "--env", "FAULT_PLAN=exit:step=2,code=121", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 121, out[-2000:]
    assert "non-retryable" in out
    assert "restarting in" not in out
    assert out.count("FAULT_CHILD_START") == 1


def test_supervisor_recovers_watchdog_killed_hang(tmp_path):
    """Hang, watchdog kill (125, retryable), relaunch, resume past the
    hang step, clean exit."""
    res = _run(["-n", "1", "--max-restarts", "1", "--restart-backoff", "0.1",
                "--hang-timeout", "5", "--timeout", "120",
                "--env", "FAULT_PLAN=hang:step=2,secs=300",
                "--env", f"STATE_FILE={tmp_path}/state", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert out.count("declaring the world hung") == 1
    assert "rc=125, world_hung" in out
    assert "FAULT_CHILD_DONE 0 start=2" in out


def test_supervisor_restart_budget_exhausts():
    """A fault that recurs on every attempt (no state file, so no
    resume) spends the budget; the final code is shell-normalized."""
    res = _run(["-n", "1", "--max-restarts", "1", "--restart-backoff", "0.1", "--timeout", "120",
                "--env", "FAULT_PLAN=kill:step=2", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 137, out[-2000:]  # 128 + SIGKILL
    assert "restart budget exhausted (1)" in out
    assert out.count("FAULT_CHILD_START") == 2


def test_supervisor_keeps_one_cache_dir_and_the_restart_hits_it(tmp_path):
    """Where JAX suffixes ``COMPILATION_CACHE_DIR`` per attempt, the port
    keeps the one directory: the first attempt builds a library there
    (a miss: ``csrc/fused_block_plan.cpp`` with the host compiler), the
    restarted world loads it (a hit, no compiler)."""
    obs_dir = tmp_path / "run"
    cache = tmp_path / "kernel-cache"
    res = _run(["-n", "1", "--max-restarts", "1", "--restart-backoff", "0.1", "--timeout", "120",
                "--obs-dir", str(obs_dir), "--env", f"COMPILATION_CACHE_DIR={cache}",
                "--env", "BUILD_LIBRARY=fused_block_plan",
                "--env", "FAULT_PLAN=kill:step=2,rank=0",
                "--env", f"STATE_FILE={tmp_path}/state", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert out.count(f"FAULT_CHILD_CACHE_DIR 0 {cache}\n") == 2  # both attempts, unsuffixed
    assert "-r1" not in "".join(ln for ln in out.splitlines() if "CACHE_DIR" in ln)
    assert "FAULT_CHILD_CACHE 0 hits=0 misses=1" in out, out[-4000:]
    assert "FAULT_CHILD_CACHE 0 hits=1 misses=0" in out, out[-4000:]
    recs = [json.loads(ln) for ln in open(obs_dir / "events-supervisor.jsonl")]
    assert not [r for r in recs if r.get("name") == "cache_dir_suffixed"]
    assert [r["labels"]["attempt"] for r in recs if r.get("name") == "attempt_start"] == [0, 1]


_BUILD_CHILD = textwrap.dedent("""
    import os
    print("alive", flush=True)
    from distributeddeeplearning_tpu_torch.ops import _build
    _build.set_cache_dir(os.environ["COMPILATION_CACHE_DIR"])
    _build.build("fused_block_plan")  # the compiler is silent for 8 s
    print("BUILD_CHILD_OK", flush=True)
    """)


def test_heartbeat_keeps_a_building_world_alive(tmp_path):
    """A kernel build silent for 8 s under a 3 s watchdog survives:
    ``ops/_build.build`` runs the compiler inside ``heartbeat.during``,
    the launcher arms it (``DDL_HEARTBEAT_EVERY_S``) and counts its lines
    as liveness without streaming them."""
    from distributeddeeplearning_tpu_torch.utils.heartbeat import MAGIC

    slow = tmp_path / "slow-c++"
    slow.write_text("#!/bin/sh\nsleep 8\nexec c++ \"$@\"\n")
    slow.chmod(slow.stat().st_mode | stat.S_IEXEC)
    script = tmp_path / "build.py"
    script.write_text(_BUILD_CHILD)
    res = _run(["-n", "1", "--hang-timeout", "3", "--timeout", "120",
                "--env", f"CXX={slow}", "--env", f"COMPILATION_CACHE_DIR={tmp_path / 'cache'}",
                str(script)])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "BUILD_CHILD_OK" in out
    assert MAGIC not in out


@pytest.mark.parametrize("armed", [False, True])
def test_build_heartbeat_unit(tmp_path, monkeypatch, capfd, armed):
    """``_build.build`` emits heartbeat lines while its compiler runs only
    when armed."""
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.utils import heartbeat

    slow = tmp_path / "slow-c++"
    slow.write_text("#!/bin/sh\nsleep 1\nexec c++ \"$@\"\n")
    slow.chmod(slow.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(slow))
    if armed:
        monkeypatch.setenv(heartbeat.ENV_VAR, "0.1")
    else:
        monkeypatch.delenv(heartbeat.ENV_VAR, raising=False)
    _build.set_cache_dir(str(tmp_path / "cache"))
    try:
        _build.build("fused_block_plan")
    finally:
        _build.set_cache_dir(None)
    lines = [ln for ln in capfd.readouterr().out.splitlines() if ln.startswith(heartbeat.MAGIC)]
    if armed:
        assert lines and all(ln == f"{heartbeat.MAGIC} build:fused_block_plan" for ln in lines)
    else:
        assert not lines
