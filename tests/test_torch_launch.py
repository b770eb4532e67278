"""The port's launcher (``distributeddeeplearning_tpu_torch/launch.py``),
twins of ``tests/test_launch.py``: ``_child_env`` against JAX's (the
same ``DDL_*`` and ``PYTHONPATH``, plus ``LOCAL_RANK``, without JAX's
variables), the helpers and the dry run, a 2-rank gloo world running the
port's ``examples/imagenet_keras.py`` as a script, all-or-nothing exit,
the hang watchdog, telemetry as liveness, the merged ``events.jsonl``, a
killed child's flight dump, the flags the port refuses, and a card
world refused without CUDA.

The children print before they go quiet and block on the launcher's
teardown rather than on a sleep that races it, so no outcome depends on
how loaded the host is: the watchdog's clock starts from a live process.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from distributeddeeplearning_tpu_torch.launch import (
    _child_env,
    _parse_env_args,
    find_free_port,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.launch"]


def _run(args, timeout=120, env=None):
    return subprocess.run([*LAUNCH, *args], cwd=REPO_ROOT, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_find_free_port():
    p = find_free_port()
    assert isinstance(p, int) and 0 < p < 65536


def test_parse_env_args_like_jax():
    from distributeddeeplearning_tpu.launch import _parse_env_args as jax_parse

    assert _parse_env_args(["A=1", "B=x=y"]) == jax_parse(["A=1", "B=x=y"]) == {
        "A": "1", "B": "x=y"}
    with pytest.raises(SystemExit):
        _parse_env_args(["NOEQUALS"])


@pytest.mark.parametrize("platform", ["cpu", None])
def test_child_env_matches_jax_plus_local_rank(platform):
    from distributeddeeplearning_tpu.launch import _child_env as jax_child_env

    base = {"PYTHONPATH": "/elsewhere", "HOME": "/h", "RANK": "7", "MASTER_PORT": "1"}
    kw = dict(coordinator="127.0.0.1:1234", num_processes=2, process_id=1, platform=platform,
              extra_env={"FAKE": "True"})
    mine = _child_env(dict(base), **kw)
    ref = jax_child_env(dict(base), devices_per_process=None, **kw)
    for k in ("DDL_COORDINATOR", "DDL_NUM_PROCESSES", "DDL_PROCESS_ID", "PYTHONPATH", "FAKE",
              "HOME"):
        assert mine[k] == ref[k], k
    assert mine.get("DDL_PLATFORM") == ref.get("DDL_PLATFORM") == platform
    assert mine["LOCAL_RANK"] == "1" and "LOCAL_RANK" not in ref
    assert "JAX_PLATFORMS" not in mine and "XLA_FLAGS" not in mine
    assert "RANK" not in mine and "MASTER_PORT" not in mine  # the DDL_* world is the child's
    assert mine["PYTHONPATH"].split(os.pathsep)[0] == REPO_ROOT
    with pytest.raises(ValueError, match="mesh"):
        _child_env(dict(base), devices_per_process=4, **kw)


def test_dry_run_and_refused_flags():
    res = _run(["--dry-run", "-n", "4", "script.py"])
    assert res.returncode == 0 and "4 local processes" in res.stdout
    res = _run(["--tpu", "pod", "script.py"])
    assert res.returncode == 2 and "orchestration" in res.stderr, res.stderr
    res = _run(["--devices-per-process", "2", "script.py"])
    assert res.returncode == 2 and "mesh" in res.stderr, res.stderr
    res = _run(["--elastic", "script.py"])
    assert res.returncode == 2 and "--max-restarts" in res.stderr, res.stderr


def test_card_world_refused_without_cuda(tmp_path):
    """No ``--platform`` (or ``gpu``) asks for NCCL on the card: on a host
    without CUDA the launcher exits non-zero naming CUDA and forks
    nothing, and nothing moves to the CPU."""
    script = tmp_path / "marker.py"
    marker = tmp_path / "ran"
    script.write_text(f"open({str(marker)!r}, 'w').close()\n")
    env = {k: v for k, v in os.environ.items() if k not in ("DDL_PLATFORM", "CUDA_VISIBLE_DEVICES")}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, on any host
    for flags in ([], ["--platform", "gpu"]):
        res = _run([*flags, "-n", "1", str(script)], env=env)
        assert res.returncode != 0 and "CUDA" in res.stderr, (flags, res.stderr)
    assert not marker.exists()


def test_two_rank_gloo_world_runs_the_keras_example_as_a_script():
    """The twin of ``test_two_process_keras_frontend_end_to_end``: the
    launcher forms a 2-rank gloo world from ``DDL_*`` and the port's
    Keras-style example, started as a script, trains ResNet-18 at 32 px
    (2 images a rank, 4 steps), its output rank-tagged."""
    res = _run(["-n", "2", "--platform", "cpu", "--timeout", "240",
                "--env", "FAKE=True", "--env", "FAKE_DATA_LENGTH=16", "--env", "EPOCHS=1",
                "--env", "BATCHSIZE=2", "--env", "IMAGE_SIZE=32", "--env", "NUM_CLASSES=8",
                "--env", "MODEL=resnet18", "--env", "OMP_NUM_THREADS=2",
                "distributeddeeplearning_tpu_torch/examples/imagenet_keras.py"], timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    for r in (0, 1):
        assert f"[{r}] " in out
        assert f"distributed initialized: process {r}/2, backend gloo" in out, out[-4000:]
    assert "Total images processed: 16" in out, out[-4000:]


def test_child_failure_terminates_world(tmp_path):
    """All-or-nothing exit: one failing rank ends the job at once, its
    code the launcher's, the healthy rank blocked until then."""
    script = tmp_path / "failer.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["DDL_PROCESS_ID"] == "1":
            sys.exit(3)
        time.sleep(120)
        """))
    t0 = time.monotonic()
    res = _run(["-n", "2", "--platform", "cpu", "--timeout", "90", str(script)], timeout=110)
    assert res.returncode == 3, (res.returncode, res.stdout[-2000:])
    assert "process 1 exited 3; terminating the job" in res.stdout
    assert time.monotonic() - t0 < 80  # the teardown, not the timeout


def test_hang_watchdog_kills_silent_world(tmp_path):
    """Alive but silent after a first line (a deadlocked collective):
    declared hung and ended with 125, well before the timeout."""
    script = tmp_path / "hang.py"
    script.write_text("import time\nprint('alive', flush=True)\ntime.sleep(300)\n")
    t0 = time.monotonic()
    res = _run(["-n", "2", "--platform", "cpu", "--hang-timeout", "4", "--timeout", "120",
                str(script)], timeout=150)
    out = res.stdout + res.stderr
    assert res.returncode == 125, out[-2000:]
    assert "declaring the world hung" in out
    assert out.count("alive") == 2
    assert time.monotonic() - t0 < 100


_OBS_CHILD = textwrap.dedent("""
    import os, time
    from distributeddeeplearning_tpu_torch import obs

    bus = obs.configure_from_env()
    rank = os.environ["DDL_PROCESS_ID"]
    with bus.span("work", rank=rank):
        time.sleep(0.05)
    bus.counter("things", 3)
    bus.flush()
    bus.point("unflushed_tail")  # ring only: the flight dump's proof
    print("OBS_CHILD_OK", rank, flush=True)
    if os.environ.get("HANG"):
        # Rank 0 keeps talking until rank 1 is silent in its hang, so the
        # watchdog can only fire once rank 1 holds its ring and handler.
        ready = os.path.join(os.environ["OBS_DIR"], "hang-ready")
        if rank == "1":
            open(ready, "w").close()
            time.sleep(300)  # silent: the watchdog must end us
        while not os.path.exists(ready):
            print("waiting", flush=True)
            time.sleep(0.2)
    """)


def test_obs_dir_gives_merged_events_and_a_report(tmp_path):
    from distributeddeeplearning_tpu_torch.obs import render, summarize
    from distributeddeeplearning_tpu_torch.obs.report import load

    script = tmp_path / "obs_child.py"
    script.write_text(_OBS_CHILD)
    obs_dir = tmp_path / "run1"
    res = _run(["-n", "2", "--platform", "cpu", "--obs-dir", str(obs_dir), "--timeout", "120",
                str(script)], timeout=150)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "OBS_CHILD_OK 0" in out and "OBS_CHILD_OK 1" in out
    for name in ("events-p0.jsonl", "events-p1.jsonl", "events-launcher.jsonl"):
        assert (obs_dir / name).exists(), name
    recs = [json.loads(ln) for ln in open(obs_dir / "events.jsonl")]
    metas = [r for r in recs if r["kind"] == "meta"]
    assert {str(m["p"]) for m in metas} == {"0", "1", "launcher"}
    assert len({m["run"] for m in metas}) == 1  # one launcher-minted run id
    names = {r["name"] for r in recs if r["kind"] != "meta"}
    assert {"rendezvous", "child_start", "child_exit", "world_exit", "work", "things"} <= names
    walls = [r["wall"] for r in recs if "wall" in r]
    assert walls == sorted(walls)
    text = render(summarize(load([str(obs_dir)])))
    assert "work" in text and "timeline" in text


def test_watchdog_accepts_telemetry_as_liveness(tmp_path):
    """A process that prints once, then only emits bus events (flushed
    every 0.5 s) for longer than the hang timeout, is alive: event-file
    growth ticks the watchdog."""
    script = tmp_path / "silent_worker.py"
    script.write_text(textwrap.dedent("""
        import time
        from distributeddeeplearning_tpu_torch import obs

        bus = obs.configure_from_env()
        print("started", flush=True)
        for i in range(30):          # 6 s of stdout silence
            bus.point("tick", i=i)
            time.sleep(0.2)
        bus.flush()
        """))
    res = _run(["-n", "1", "--platform", "cpu", "--obs-dir", str(tmp_path / "run"),
                "--hang-timeout", "4", "--timeout", "120", "--env", "OBS_FLUSH_EVERY_S=0.5",
                str(script)], timeout=150)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "declaring the world hung" not in out


def test_killed_child_leaves_flight_dump(tmp_path):
    """Watchdog kill = SIGTERM: the hung child's flight ring reaches disk
    with its last events, the unflushed one too, the launcher records the
    watchdog, and the merge still runs."""
    script = tmp_path / "obs_child.py"
    script.write_text(_OBS_CHILD)
    obs_dir = tmp_path / "run2"
    res = _run(["-n", "2", "--platform", "cpu", "--obs-dir", str(obs_dir), "--hang-timeout",
                "4", "--timeout", "120", "--env", "HANG=1", str(script)], timeout=150)
    out = res.stdout + res.stderr
    assert res.returncode == 125, out[-4000:]
    dump = obs_dir / "flight-p1.jsonl"
    assert dump.exists(), out[-2000:]
    recs = [json.loads(ln) for ln in open(dump)]
    assert recs[0]["kind"] == "flight_meta" and recs[0]["reason"] == "sigterm"
    names = [r["name"] for r in recs[1:]]
    assert "work" in names and "unflushed_tail" in names
    launcher = [json.loads(ln) for ln in open(obs_dir / "events-launcher.jsonl")]
    assert any(r.get("name") == "watchdog_fired" for r in launcher)
    assert (obs_dir / "events.jsonl").exists()
