"""Elastic worlds in the port (``faults.py``'s capacity protocol and
elasticity verbs, ``launch.py``'s elastic supervisor, ``config.py``),
twins of the fast tier of ``tests/test_elastic.py``:

* the grammar of ``shrink``/``restore_capacity`` parsed as JAX parses it;
* capacity files written by either package read the same by both
  (valid, past ``restore_at``, future ``restore_at``, clamped, torn,
  malformed, stale under ``CAPACITY_STALE_S``, unknown owner);
* ``_elastic_world`` equal to JAX's over full 1-16 x available -1-17 x
  floor 1-17;
* the injector's shrink (capacity written, survivors spared) and
  step-indexed restore, each file equal to the one JAX's injector
  writes;
* ``ELASTIC`` and ``LR_WORLD_SIZE`` resolved as JAX resolves them, and
  ``LR_WORLD_SIZE < 1`` refused by both;
* the supervisor's shrink-and-grow and min-world drills over
  ``tests/_torch_fault_child.py``, whose shrunken world blocks after
  announcing capacity until the grow poller stops it (no race with the
  poller).
"""

import json
import os
import subprocess
import sys
import time

import pytest

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.launch import _elastic_world

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = "tests/_torch_fault_child.py"


def _jax_faults():
    from distributeddeeplearning_tpu import faults as jax_faults

    return jax_faults


@pytest.mark.parametrize("text", [
    "shrink:step=3,ranks=2;restore_capacity:secs=30",
    "shrink:step=2;restore_capacity:step=6",
    "shrink:step=4,rank=1,ranks=1;restore_capacity:step=8,rank=0",
])
def test_elastic_plan_parses_like_jax(text):
    assert faults.parse_fault_plan(text) == [
        faults.Fault(**vars(f)) for f in _jax_faults().parse_fault_plan(text)]


@pytest.mark.parametrize("bad", ["kill:step=1,ranks=2", "restore_capacity:", "shrink:ranks=1",
                                 "shrink:step=1,ranks=0"])
def test_elastic_plan_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        _jax_faults().parse_fault_plan(bad)
    with pytest.raises(ValueError):
        faults.parse_fault_plan(bad)


def _case(case):
    """The ``write_capacity`` arguments of a valid-file ``case``."""
    if case == "valid":
        return dict(available=3)
    if case == "restored":
        return dict(available=3, restore_at=time.time() - 1)
    if case == "future":
        return dict(available=3, restore_at=time.time() + 3600)
    if case == "clamped":
        return dict(available=99)
    if case == "owner_fault":
        return dict(available=2, owner="fault")
    if case == "unknown_owner":
        return dict(available=2, owner="stranger")
    raise AssertionError(case)


CASES = ["valid", "restored", "future", "clamped", "owner_fault", "unknown_owner", "torn",
         "malformed", "not_a_dict", "bad_available", "stale", "missing"]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", CASES)
def test_capacity_file_reads_the_same_in_both(tmp_path, monkeypatch, writer, case):
    jax_faults = _jax_faults()
    path = str(tmp_path / "capacity.json")
    write = (jax_faults if writer == "jax" else faults).write_capacity
    monkeypatch.delenv("CAPACITY_STALE_S", raising=False)
    if case == "torn":
        (tmp_path / "capacity.json").write_text('{"available": 3')
    elif case == "malformed":
        (tmp_path / "capacity.json").write_text("nonsense")
    elif case == "not_a_dict":
        (tmp_path / "capacity.json").write_text("[3]")
    elif case == "bad_available":
        (tmp_path / "capacity.json").write_text('{"available": "three"}')
    elif case == "stale":
        write(path, 3, owner="arbiter")
        old = time.time() - 100
        os.utime(path, (old, old))
        monkeypatch.setenv("CAPACITY_STALE_S", "10")
    elif case != "missing":
        write(path, **_case(case))
    for current in (None, 4):
        got = faults.probe_capacity(path, 8, current=current)
        want = jax_faults.probe_capacity(path, 8, current=current)
        assert got == want, (case, current, got, want)
    expect = {"valid": 3, "restored": 8, "future": 3, "clamped": 8, "owner_fault": 2,
              "unknown_owner": 4, "torn": 4, "malformed": 4, "not_a_dict": 4,
              "bad_available": 4, "stale": 4, "missing": 8}[case]
    assert faults.probe_capacity(path, 8, current=4) == expect
    if case not in ("torn", "malformed", "not_a_dict", "bad_available", "stale", "missing"):
        # the file either package wrote is the same JSON
        d = json.loads((tmp_path / "capacity.json").read_text())
        assert set(d) == {"available", "restore_at", "owner"}
    assert faults.probe_capacity(None, 8) == jax_faults.probe_capacity(None, 8) == 8


def test_elastic_world_equals_jax():
    from distributeddeeplearning_tpu.launch import _elastic_world as jax_world

    for full in range(1, 17):
        for available in range(-1, 18):
            for floor in range(1, 18):
                assert _elastic_world(full, available, floor) == jax_world(
                    full, available, floor), (full, available, floor)
    assert _elastic_world(8, 7, 1) == 4 and _elastic_world(8, 1, 2) == 2


def _injected(mod, plan, tmp_path, name, **kw):
    cap = str(tmp_path / name)
    inj = mod.FaultInjector(mod.parse_fault_plan(plan), capacity_file=cap, **kw)
    return inj, cap


def test_injector_shrink_writes_capacity_and_spares_survivors(tmp_path):
    """Rank 0 of a 2-process world survives a ranks=1 shrink; both
    packages' injectors write the same capacity file, with the wall-clock
    restore folded in as ``restore_at``."""
    jax_faults = _jax_faults()
    plan = "shrink:step=2,ranks=1;restore_capacity:secs=45"
    mine, cap = _injected(faults, plan, tmp_path, "port.json", rank=0, world=2)
    ref, ref_cap = _injected(jax_faults, plan, tmp_path, "jax.json", rank=0, world=2)
    assert mine.restore_secs == ref.restore_secs == 45.0
    assert mine.due_after(2) and ref.due_after(2)
    t0 = time.time()
    mine.fire_after(2)  # rank 0 < survivors (1): returns alive
    ref.fire_after(2)
    d, r = (json.loads(open(p).read()) for p in (cap, ref_cap))
    assert d["available"] == r["available"] == 1 and d["owner"] == r["owner"] == "fault"
    assert t0 + 40 <= d["restore_at"] <= time.time() + 50
    assert abs(d["restore_at"] - r["restore_at"]) < 5
    assert not mine.due_after(2)  # one-shot


def test_injector_restore_capacity_step_announces_full_world(tmp_path):
    jax_faults = _jax_faults()
    mine, cap = _injected(faults, "restore_capacity:step=5", tmp_path, "port.json", rank=0,
                          world=1, full_world=2)
    ref, ref_cap = _injected(jax_faults, "restore_capacity:step=5", tmp_path, "jax.json",
                             rank=0, world=1, full_world=2)
    assert mine.due_after(5)
    mine.fire_after(5)  # announces capacity and returns
    ref.fire_after(5)
    assert json.loads(open(cap).read()) == json.loads(open(ref_cap).read())
    assert faults.probe_capacity(cap, 2) == 2


def test_injector_from_env_like_jax(tmp_path):
    jax_faults = _jax_faults()
    env = {"FAULT_PLAN": "shrink:step=3,ranks=1", "DDL_PROCESS_ID": "1",
           "DDL_NUM_PROCESSES": "2", "DDL_WORLD_FULL": "4", "OBS_DIR": str(tmp_path)}
    mine, ref = faults.FaultInjector.from_env(env), jax_faults.FaultInjector.from_env(env)
    for attr in ("rank", "world", "full_world", "capacity_file", "restore_secs"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.capacity_file == os.path.join(str(tmp_path), "capacity.json")
    env[faults.CAPACITY_FILE_ENV] = "/elsewhere/cap.json"
    assert faults.FaultInjector.from_env(env).capacity_file == "/elsewhere/cap.json"


ELASTIC_ENVS = [{}, {"ELASTIC": "1"}, {"ELASTIC": "no"}, {"LR_WORLD_SIZE": "8"},
                {"ELASTIC": "true", "LR_WORLD_SIZE": "4", "DATA_TOPOLOGY": "global"}]


@pytest.mark.parametrize("env", ELASTIC_ENVS,
                         ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()) or "none")
def test_config_resolves_elastic_settings_like_jax(env):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for field in ("elastic", "lr_world_size", "data_topology"):
        assert getattr(mine, field) == getattr(ref, field), field


def test_lr_world_size_below_one_refused_like_jax():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training.loop import resolve_engine as jax_resolve

    from distributeddeeplearning_tpu_torch.training.loop import resolve_engine

    with pytest.raises(ValueError, match="LR_WORLD_SIZE"):
        resolve_engine(TrainConfig(lr_world_size=0), device="cpu")
    with pytest.raises(ValueError, match="LR_WORLD_SIZE"):
        jax_resolve(JaxConfig(lr_world_size=0))
    assert resolve_engine(TrainConfig(lr_world_size=1), device="cpu")[0] == "dp"


def _run(args, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.launch", "--platform", "cpu",
         *args], cwd=REPO_ROOT, capture_output=True, text=True, timeout=timeout)


def test_supervisor_elastic_shrink_and_grow(tmp_path):
    """``--elastic`` over the light child: a shrink kills rank 1 of a
    2-process world and records lost capacity; the supervisor relaunches
    at world 1 with BATCHSIZE/ACCUM_STEPS doubled and LR_WORLD_SIZE
    pinned; the shrunken world announces capacity at step 6 and blocks;
    the grow poller stops it with the resize code (no budget spent) and
    the full world resumes and completes."""
    obs_dir = tmp_path / "run"
    res = _run(["-n", "2", "--max-restarts", "1", "--restart-backoff", "0.1", "--elastic",
                "--min-world-size", "1", "--grow-check-every-s", "0.2", "--timeout", "120",
                "--obs-dir", str(obs_dir), "--env", "FAKE_STEPS=12", "--env", "BATCHSIZE=2",
                "--env", "ACCUM_STEPS=1",
                # rank=1: the world-1 relaunch (rank 0) never re-fires it
                "--env", "FAULT_PLAN=shrink:step=3,rank=1,ranks=1;restore_capacity:step=6",
                "--env", f"STATE_FILE={tmp_path}/state", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "FAULT_CHILD_WORLD rank=0 world=2 batch=2 accum=1 lr_world=2" in out
    assert "rc=-9, signal_SIGKILL" in out
    assert ("supervisor: elastic world 1/2 processes — BATCHSIZE 2->4, ACCUM_STEPS 1->2"
            in out), out[-4000:]
    assert "FAULT_CHILD_WORLD rank=0 world=1 batch=4 accum=2 lr_world=2" in out
    assert "FAULT_CHILD_BLOCKED restored step=6" in out
    assert "launch: world resize requested (capacity restored" in out
    assert "supervisor: world resize 1 -> 2" in out and "no restart budget consumed" in out
    assert "FAULT_CHILD_WORLD rank=1 world=2 batch=2 accum=1 lr_world=2" in out
    assert "FAULT_CHILD_DONE 0 start=6" in out and "FAULT_CHILD_DONE 1 start=3" in out
    assert "BLOCK_DEADLINE" not in out
    assert json.loads((obs_dir / "capacity.json").read_text())["available"] == 2
    recs = [json.loads(ln) for ln in open(obs_dir / "events-supervisor.jsonl")]
    assert [r["labels"]["world_size"] for r in recs
            if r.get("name") == "attempt_start"] == [2, 1, 2]
    resized = [r["labels"] for r in recs if r.get("name") == "elastic.world_resized"]
    assert [(r["phase"], r["from_world"], r["to_world"]) for r in resized] == [
        ("shrink", 2, 1), ("grow", 1, 2)]
    exits = [r["labels"]["rc"] for r in recs if r.get("name") == "attempt_exit"]
    assert exits == [-9, faults.EXIT_RESIZE, 0]
    dumps = list(obs_dir.glob("flight-p1*.jsonl"))
    assert dumps, sorted(os.listdir(obs_dir))
    assert json.loads(open(dumps[0]).readline())["reason"] == "fault_shrink"


def test_supervisor_elastic_respects_min_world_size(tmp_path):
    """MIN_WORLD_SIZE=2 on a 2-process world: the shrink cannot go below
    the floor, so the world relaunches at full size, resumes past the
    one-shot shrink and completes."""
    res = _run(["-n", "2", "--max-restarts", "2", "--restart-backoff", "0.1", "--elastic",
                "--min-world-size", "2", "--timeout", "120", "--env", "FAKE_STEPS=6",
                "--env", "FAULT_PLAN=shrink:step=3,rank=1,ranks=1",
                "--env", f"STATE_FILE={tmp_path}/state", CHILD])
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "FAULT_CHILD_WORLD rank=1 world=2" in out
    assert "supervisor: elastic world" not in out and "world=1" not in out
    assert "FAULT_CHILD_DONE 1 start=3" in out, out[-4000:]
    assert out.count("FAULT_CHILD_START") == 4  # two attempts of two processes
