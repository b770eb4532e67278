"""Multi-process job launcher of the port: the twin of the JAX package's
``launch.py`` (the mpirun / Batch-AI-submit equivalent) for a world of
torch processes.

``python -m distributeddeeplearning_tpu_torch.launch -n N script.py``
forks N python processes of ``script.py`` on this host and wires the
rendezvous contract ``parallel/distributed.maybe_initialize`` reads:
``DDL_COORDINATOR`` (process 0's host:port, the TCP store),
``DDL_NUM_PROCESSES`` and ``DDL_PROCESS_ID``. Around that world it
keeps JAX's machinery, line for line where it can:

* **all-or-nothing exit**: the first child to fail tears the world down
  (SIGTERM, then SIGKILL after 10 s) and its code is the launcher's;
  ``--timeout`` ends it with 124;
* **hang watchdog** (``--hang-timeout``): no output from any child for
  that long ends the world with 125. Children print heartbeat lines
  (``utils/heartbeat.py``, armed through ``DDL_HEARTBEAT_EVERY_S``)
  through their silent phases (kernel builds, graph capture, the first
  step), which tick the watchdog and never reach the log; with
  ``--obs-dir``, growth of any event or flight file counts as liveness
  too (``obs/tail.activity_signature``);
* **telemetry** (``--obs-dir``): the launcher's own lifecycle events in
  ``events-launcher.jsonl``, ``OBS_DIR``/``OBS_RUN_ID`` exported to every
  child, and the host-0 merge into ``events.jsonl`` at world exit
  (``obs/report.merge_run_dir``);
* **restart supervisor** (``--max-restarts``, :func:`launch_supervised`):
  a retryable death (``faults.classify_exit``) relaunches the whole
  world with ``RESUME=True`` after an exponential backoff, each attempt
  under its own ``OBS_PROC_SUFFIX=-r<k>`` and ``DDL_RESTART=<k>``;
* **elastic worlds** (``--elastic``): a relaunch probes the capacity
  file (``faults.probe_capacity``) and runs at the largest divisor of
  the full world that fits (never below ``--min-world-size``), with
  ``BATCHSIZE`` and ``ACCUM_STEPS`` scaled by the same integer factor
  and ``LR_WORLD_SIZE`` pinned to the full world, so the effective batch
  and the LR schedule do not move; while shrunken it polls the probe
  every ``--grow-check-every-s`` and, when capacity returns, stops the
  world with ``faults.EXIT_RESIZE`` (no restart budget spent) and
  relaunches it at full size.

Departures from the JAX launcher:

* ``_child_env`` also sets ``LOCAL_RANK`` to the process id, so that
  ``maybe_initialize`` pins each child to its own card, and drops an
  inherited ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
  (torch's ``env://`` contract of an enclosing launcher: the ``DDL_*``
  world is the child's). It sets no ``JAX_PLATFORMS`` and no
  ``XLA_FLAGS``.
* ``--platform cpu`` exports ``DDL_PLATFORM=cpu``: a gloo world on the
  CPU. ``--platform gpu`` (exported as ``DDL_PLATFORM=gpu``, over an
  inherited ``cpu``), or no flag, gives an NCCL world, one card a
  process: the launcher refuses to start one without CUDA, or with
  fewer cards than processes, and nothing moves to the CPU.
* ``--devices-per-process`` is accepted only as 1: a torch process
  drives one device (more belongs to the mesh slice), so
  ``LR_WORLD_SIZE`` is the full world's process count.
* Pod mode (``--tpu``: gcloud TPU VMs) stays with the JAX launcher; it
  waits for the orchestration slice, and ``--tpu`` is an argparse error
  here.
* Every attempt shares one ``COMPILATION_CACHE_DIR``. JAX suffixes the
  directory per attempt to dodge a jax build's cache corruption; the
  port's cache holds ``nvcc``-built libraries written atomically
  (``ops/_build.py``), so a restart loads them instead of building
  every kernel again.

The repository's root ``launch.py`` stays the JAX launcher.

Usage::

    python -m distributeddeeplearning_tpu_torch.launch -n 2 --platform cpu \\
        --env FAKE=True distributeddeeplearning_tpu_torch/examples/imagenet_keras.py
    python -m distributeddeeplearning_tpu_torch.launch -n 4 --max-restarts 2 \\
        --elastic --min-world-size 2 --hang-timeout 300 --obs-dir runs/r1 train.py
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from distributeddeeplearning_tpu_torch import faults

# Child liveness lines (utils/heartbeat.py): tick the hang watchdog but
# never reach the streamed log.
_HEARTBEAT_MAGIC = b"__ddl_heartbeat__"

# torch's env:// rendezvous variables, dropped from a child's env.
_TORCH_RENDEZVOUS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

PLATFORMS = ("cpu", "gpu")


def find_free_port() -> int:
    """Pick a free TCP port for process 0's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse_env_args(pairs: Sequence[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--env expects KEY=VALUE, got {p!r}")
        k, v = p.split("=", 1)
        out[k] = v
    return out


def _check_devices_per_process(devices_per_process: Optional[int]) -> None:
    if devices_per_process not in (None, 1):
        raise ValueError(
            f"--devices-per-process {devices_per_process}: a torch process drives one device; "
            "more devices a process comes with the mesh slice (parallel/mesh.py)")


def _child_env(
    base: Dict[str, str],
    *,
    coordinator: str,
    num_processes: int,
    process_id: int,
    platform: Optional[str],
    devices_per_process: Optional[int] = None,
    extra_env: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """One child's environment: ``base`` and ``extra_env``, the package
    root and the launch directory first on ``PYTHONPATH`` (a script
    started as ``python dir/foo.py`` could not import the package
    otherwise), the ``DDL_*`` world, ``LOCAL_RANK`` and the platform."""
    _check_devices_per_process(devices_per_process)
    env = dict(base)
    env.update(extra_env or {})
    for k in _TORCH_RENDEZVOUS:
        env.pop(k, None)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [pkg_root, os.getcwd(), env.get("PYTHONPATH")]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(p for p in paths if p))
    env["DDL_COORDINATOR"] = coordinator
    env["DDL_NUM_PROCESSES"] = str(num_processes)
    env["DDL_PROCESS_ID"] = str(process_id)
    env["LOCAL_RANK"] = str(process_id)
    if platform:
        env["DDL_PLATFORM"] = platform
    return env


def _resolve_platform(platform: Optional[str], extra_env: Dict[str, str]) -> str:
    """The children's platform: the flag, else ``DDL_PLATFORM`` from
    ``--env`` or the launcher's environment, else ``gpu``."""
    return platform or extra_env.get("DDL_PLATFORM") or os.environ.get("DDL_PLATFORM") or "gpu"


def check_platform(platform: str, num_processes: int) -> None:
    """Refuse a card world this host cannot hold: NCCL needs CUDA and a
    card a process. Raises ``RuntimeError`` naming CUDA."""
    if platform == "cpu":
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: a card world (NCCL, one card a process) needs the card; "
            "pass --platform cpu for a gloo world on the CPU")
    have = torch.cuda.device_count()
    if have < num_processes:
        raise RuntimeError(
            f"{num_processes} processes need {num_processes} CUDA devices (LOCAL_RANK = "
            f"process id), this host has {have}")


def _stream(proc: subprocess.Popen, rank: int, tag: bool, sink, heartbeat=None
            ) -> threading.Thread:
    """Pump one child's merged stdout/stderr to ``sink``, rank-tagged
    (mpirun ``--tag-output``). ``heartbeat``: a one-element list set to
    the time of the last bytes from ANY child, the hang watchdog's
    signal."""

    def pump():
        prefix = f"[{rank}] " if tag else ""
        raw = proc.stdout  # binary pipe (see launch_local's Popen)
        pending = b""
        while True:
            # Chunked binary reads, not line iteration: the heartbeat
            # ticks on ANY bytes (a `\r` progress bar never ends a line).
            chunk = raw.read1(65536)
            if not chunk:
                break
            if heartbeat is not None:
                heartbeat[0] = time.monotonic()
            pending += chunk
            lines = pending.splitlines(keepends=True)
            if lines and not lines[-1].endswith((b"\n", b"\r")):
                pending = lines.pop()
            else:
                pending = b""
            wrote = False
            for ln in lines:
                # Heartbeat lines ticked the watchdog above; keep them
                # out of the log.
                if ln.startswith(_HEARTBEAT_MAGIC):
                    continue
                sink.write(prefix + ln.decode(errors="replace"))
                wrote = True
            if wrote:
                sink.flush()
        if pending and not pending.startswith(_HEARTBEAT_MAGIC):
            sink.write(prefix + pending.decode(errors="replace") + "\n")
            sink.flush()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    return t


class _ChildFailed(Exception):
    pass


def launch_local(
    script: str,
    script_args: Sequence[str] = (),
    *,
    num_processes: int = 2,
    devices_per_process: Optional[int] = None,
    platform: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    tag_output: bool = True,
    timeout: Optional[float] = None,
    hang_timeout: Optional[float] = None,
    obs_dir: Optional[str] = None,
    launcher_proc: str = "launcher",
    stop_check=None,
    sink=None,
) -> int:
    """Run ``script`` in ``num_processes`` local python processes.

    Returns the first nonzero child exit code, or 0. On any child
    failure (or timeout, watchdog, resize stop) the remaining children
    get SIGTERM, then SIGKILL 10 s later: the all-or-nothing semantics
    of an mpirun world.

    ``hang_timeout``: if NO child writes a byte for that many seconds
    the world is declared hung and ended (125). With ``obs_dir`` the
    growth of any ``events-*``/``flight-*`` file there counts as output
    (the bus flushes at least every ``OBS_FLUSH_EVERY_S`` while a
    process emits), so a world that works silently with telemetry
    flowing is alive.

    ``stop_check``: a zero-argument callable polled by the loop; a
    truthy reason string ends the world with ``faults.EXIT_RESIZE``
    (SIGTERM first, so checkpoints and flight rings drain).

    ``obs_dir``: the world's run directory: the launcher's lifecycle
    events (rendezvous, child start and exit, timeout, watchdog, resize)
    in ``events-<launcher_proc>.jsonl``, ``OBS_DIR``/``OBS_RUN_ID``
    exported, and every part file merged into ``events.jsonl`` when the
    world exits, whatever its code.

    Raises ``RuntimeError`` before forking anything when the platform
    (``platform``, else ``DDL_PLATFORM``, else the card) is the card and
    this host has no CUDA or fewer cards than processes.
    """
    _check_devices_per_process(devices_per_process)
    sink = sink or sys.stdout
    extra_env = dict(env or {})
    check_platform(_resolve_platform(platform, extra_env), num_processes)
    coordinator = f"127.0.0.1:{find_free_port()}"
    lbus = None
    if hang_timeout:
        # Arm the children's heartbeat (utils/heartbeat.py) so a long
        # silent build or capture is not mistaken for a hang.
        extra_env.setdefault("DDL_HEARTBEAT_EVERY_S", f"{max(hang_timeout / 3.0, 0.5):g}")
    if obs_dir:
        from distributeddeeplearning_tpu_torch.obs import EventBus

        obs_dir = os.path.abspath(obs_dir)
        run_id = (extra_env.get("OBS_RUN_ID") or os.environ.get("OBS_RUN_ID")
                  or f"run-{int(time.time())}")
        # A private bus: launching is an action inside the caller's
        # process, not that process's run.
        lbus = EventBus(directory=obs_dir, run_id=run_id, proc=launcher_proc)
        extra_env["OBS_DIR"] = obs_dir
        extra_env["OBS_RUN_ID"] = run_id
    procs: List[subprocess.Popen] = []
    pumps: List[threading.Thread] = []
    heartbeat = [time.monotonic()]  # updated by every pump thread
    for pid in range(num_processes):
        cenv = _child_env(dict(os.environ), coordinator=coordinator,
                          num_processes=num_processes, process_id=pid, platform=platform,
                          extra_env=extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", script, *script_args], env=cenv,
            # binary pipe: _stream reads raw chunks, so the watchdog sees
            # output without a newline too
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        if lbus is not None:
            lbus.point("child_start", rank=pid, pid=procs[-1].pid)
        pumps.append(_stream(procs[-1], pid, tag_output, sink, heartbeat))
    if lbus is not None:
        lbus.point("rendezvous", coordinator=coordinator, num_processes=num_processes,
                   script=script)
        lbus.flush()

    deadline = time.monotonic() + timeout if timeout else None
    exit_code = 0
    live = set(range(num_processes))
    # Telemetry liveness: a changed (name, size) signature over the run
    # directory's event files ticks the heartbeat like output does
    # (stat() only, about once a second).
    obs_sig = None
    obs_sig_next = 0.0
    if obs_dir and hang_timeout:
        from distributeddeeplearning_tpu_torch.obs.tail import activity_signature

        obs_sig = activity_signature(obs_dir)
    try:
        while live:
            for pid in sorted(live):
                rc = procs[pid].poll()
                if rc is not None:
                    live.discard(pid)
                    if lbus is not None:
                        lbus.point("child_exit", rank=pid, rc=rc)
                    if rc != 0 and exit_code == 0:
                        exit_code = rc
                        sink.write(f"launch: process {pid} exited {rc}; terminating the job\n")
                        raise _ChildFailed()
            if deadline and time.monotonic() > deadline:
                sink.write(f"launch: timeout after {timeout}s; terminating\n")
                exit_code = faults.EXIT_TIMEOUT
                if lbus is not None:
                    lbus.point("timeout_fired", timeout_s=timeout)
                raise _ChildFailed()
            if obs_sig is not None and time.monotonic() >= obs_sig_next:
                obs_sig_next = time.monotonic() + 1.0
                sig = activity_signature(obs_dir)
                if sig != obs_sig:
                    obs_sig = sig
                    heartbeat[0] = time.monotonic()
            if stop_check is not None:
                reason = stop_check()
                if reason:
                    sink.write(f"launch: world resize requested ({reason}); stopping the "
                               "world for relaunch\n")
                    exit_code = faults.EXIT_RESIZE
                    if lbus is not None:
                        lbus.point("resize_stop", reason=reason)
                    raise _ChildFailed()
            if hang_timeout and time.monotonic() - heartbeat[0] > hang_timeout:
                sink.write(f"launch: no output from any process for {hang_timeout}s — "
                           "declaring the world hung; terminating\n")
                exit_code = faults.EXIT_HUNG
                if lbus is not None:
                    lbus.point("watchdog_fired", silence_s=hang_timeout)
                raise _ChildFailed()
            time.sleep(0.1)
    except (_ChildFailed, KeyboardInterrupt):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        t_end = time.monotonic() + 10
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        if exit_code == 0:
            exit_code = faults.EXIT_INTERRUPTED
    finally:
        for t in pumps:
            t.join(timeout=5)
        if lbus is not None:
            lbus.point("world_exit", rc=exit_code)
            lbus.close()
            try:
                from distributeddeeplearning_tpu_torch.obs.report import merge_run_dir

                merged = merge_run_dir(obs_dir)
                if merged:
                    sink.write(f"launch: merged events -> {merged}\n")
            except Exception as e:  # merging must never mask the run's rc
                sink.write(f"launch: event merge failed: {e!r}\n")
    return exit_code


# ---------------------------------------------------------------------------
# Restart supervisor and elastic worlds
# ---------------------------------------------------------------------------

def _flight_reasons(obs_dir: str, attempt: int) -> List[str]:
    """The ``reason`` of every flight dump one attempt's processes left
    (``flight-p0.jsonl`` for attempt 0, ``flight-p0-r<k>.jsonl`` for
    restart k)."""
    tag = f"-r{attempt}" if attempt else ""
    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(obs_dir, "flight-*.jsonl"))):
        stem = os.path.basename(path)[len("flight-"):-len(".jsonl")]
        if attempt:
            if not stem.endswith(tag):
                continue
            stem = stem[: -len(tag)]
        elif "-r" in stem:
            continue
        try:
            with open(path) as fh:
                head = json.loads(fh.readline())
        except (OSError, json.JSONDecodeError):
            continue
        out.append(f"{stem}:{head.get('reason', '?')}")
    return out


def _elastic_world(full: int, available: int, min_world: int) -> int:
    """The world an elastic relaunch uses: the largest divisor of the
    FULL world (so the BATCHSIZE/ACCUM_STEPS rescale is an integer
    factor) that fits ``available``, never below ``min_world``. Below
    the floor, the floor's smallest divisor-compatible world anyway: the
    attempt fails fast and the restart budget bounds the retries."""
    divisors = [w for w in range(1, full + 1) if full % w == 0]
    fits = [w for w in divisors if min_world <= w <= max(available, 0)]
    if fits:
        return max(fits)
    floor = [w for w in divisors if w >= min_world]
    return min(floor) if floor else full


def _grow_checker(cap_file: str, full: int, cur: int, min_world: int, every_s: float):
    """``stop_check`` for a shrunken world: probes the capacity file
    every ``every_s`` seconds and asks for a resize stop once a LARGER
    divisor-compatible world fits."""
    state = {"next": 0.0}

    def check() -> Optional[str]:
        now = time.monotonic()
        if now < state["next"]:
            return None
        state["next"] = now + max(every_s, 0.1)
        available = faults.probe_capacity(cap_file, full, current=cur)
        target = _elastic_world(full, available, min_world)
        if target > cur:
            return f"capacity restored ({available} available): world {cur} -> {target}"
        return None

    return check


def launch_supervised(
    script: str,
    script_args: Sequence[str] = (),
    *,
    max_restarts: int = 0,
    restart_backoff: float = 1.0,
    backoff_cap: float = 60.0,
    elastic: bool = False,
    min_world_size: int = 1,
    grow_check_every_s: float = 30.0,
    env: Optional[Dict[str, str]] = None,
    obs_dir: Optional[str] = None,
    sink=None,
    **launch_kw,
) -> int:
    """Run :func:`launch_local` under a restart supervisor (JAX's
    ``launch_supervised``).

    A retryable world death (``faults.classify_exit``: a signal, a
    crash, the watchdog's 125) is classified, with the reasons of any
    flight dumps, and the whole world relaunched after
    ``restart_backoff * 2**restarts`` seconds (capped), at most
    ``max_restarts`` times. Every relaunch exports ``RESUME=True`` (the
    children resume from the newest valid checkpoint, mid-epoch with
    ``CHECKPOINT_EVERY_STEPS``), ``OBS_PROC_SUFFIX=-r<k>`` and
    ``DDL_RESTART=<k>``; ``COMPILATION_CACHE_DIR`` passes unchanged, so
    a restart loads the kernel libraries the first attempt built.
    Success, 121, 124 and 130 return at once; the return value is
    shell-normalized (a signal death -N becomes 128+N). ``--timeout``
    and ``--hang-timeout`` apply per attempt.

    ``elastic``: a retryable death probes the capacity file
    (``$ELASTIC_CAPACITY_FILE``, else ``<obs_dir>/capacity.json``) and
    the world relaunches at :func:`_elastic_world`'s size with
    ``ELASTIC=1``, ``DDL_WORLD_FULL``, ``LR_WORLD_SIZE`` pinned to the
    full world and ``BATCHSIZE``/``ACCUM_STEPS`` multiplied by
    ``full // world``; a shrunken world's grow poller stops it with
    ``faults.EXIT_RESIZE`` when capacity returns, and it relaunches at
    the restored size without spending the budget. ``attempt_start``
    records carry the world size; a resize emits an
    ``elastic.world_resized`` point.
    """
    sink = sink or sys.stdout
    base_env = dict(env or {})
    full_world = int(launch_kw.pop("num_processes", 2) or 2)
    cur_world = full_world
    cap_file = None
    base_batch = base_accum = 0
    if elastic:
        cap_file = base_env.get(faults.CAPACITY_FILE_ENV) or os.environ.get(
            faults.CAPACITY_FILE_ENV)
        if not cap_file and obs_dir:
            cap_file = os.path.join(os.path.abspath(obs_dir), "capacity.json")
        base_batch = int(base_env.get("BATCHSIZE") or os.environ.get("BATCHSIZE") or 64)
        base_accum = int(base_env.get("ACCUM_STEPS") or os.environ.get("ACCUM_STEPS") or 1)
        min_world_size = max(int(min_world_size), 1)
    sbus = None
    if obs_dir:
        from distributeddeeplearning_tpu_torch.obs import EventBus

        obs_dir = os.path.abspath(obs_dir)
        run_id = (base_env.get("OBS_RUN_ID") or os.environ.get("OBS_RUN_ID")
                  or f"run-{int(time.time())}")
        # One run id for every attempt: the supervisor owns the run.
        base_env["OBS_RUN_ID"] = run_id
        sbus = EventBus(directory=obs_dir, run_id=run_id, proc="supervisor")
    attempt = 0
    restarts_used = 0  # resizes are free; only failures spend the budget
    try:
        while True:
            extra = dict(base_env)
            if attempt:
                extra["OBS_PROC_SUFFIX"] = f"-r{attempt}"
                extra["DDL_RESTART"] = str(attempt)
                extra["RESUME"] = "True"
            stop_check = None
            if elastic:
                # The contract the children see: the capacity file, the
                # full world, a pinned LR world, and on a shrunken world
                # the integer BATCHSIZE/ACCUM_STEPS rescale that holds the
                # effective batch (and each card's microbatch) constant.
                extra["ELASTIC"] = "1"
                extra["DDL_WORLD_FULL"] = str(full_world)
                extra["LR_WORLD_SIZE"] = str(full_world)
                if cap_file:
                    extra[faults.CAPACITY_FILE_ENV] = cap_file
                scale = full_world // cur_world
                if scale > 1:
                    extra["BATCHSIZE"] = str(base_batch * scale)
                    extra["ACCUM_STEPS"] = str(base_accum * scale)
                    sink.write(
                        f"supervisor: elastic world {cur_world}/{full_world} processes — "
                        f"BATCHSIZE {base_batch}->{base_batch * scale}, ACCUM_STEPS "
                        f"{base_accum}->{base_accum * scale} (effective batch held constant)\n")
                if cur_world < full_world and cap_file:
                    stop_check = _grow_checker(cap_file, full_world, cur_world, min_world_size,
                                               grow_check_every_s)
            if sbus is not None:
                sbus.point("attempt_start", attempt=attempt, world_size=cur_world,
                           full_world=full_world if elastic else None)
                if elastic:
                    sbus.gauge("pool.train_world", float(cur_world))
                sbus.flush()
            rc = launch_local(
                script, script_args, num_processes=cur_world, env=extra, obs_dir=obs_dir,
                launcher_proc="launcher" if attempt == 0 else f"launcher-r{attempt}",
                stop_check=stop_check, sink=sink, **launch_kw)
            verdict = faults.classify_exit(rc)
            flight = _flight_reasons(obs_dir, attempt) if obs_dir else []
            if sbus is not None:
                sbus.point("attempt_exit", attempt=attempt, rc=rc, world_size=cur_world,
                           retryable=verdict.retryable, reason=verdict.reason,
                           flight=", ".join(flight) or None)
                sbus.flush()
            if rc == 0:
                return 0
            if elastic and rc == faults.EXIT_RESIZE:
                # Grow-back handover: relaunch at the restored size with
                # resume; no backoff, no budget.
                available = faults.probe_capacity(cap_file, full_world, current=cur_world)
                new_world = _elastic_world(full_world, available, min_world_size)
                sink.write(f"supervisor: world resize {cur_world} -> {new_world} ({available} "
                           "available); relaunching with resume (no restart budget consumed)\n")
                if sbus is not None:
                    sbus.point("elastic.world_resized", from_world=cur_world,
                               to_world=new_world, phase="grow", attempt=attempt + 1)
                    sbus.flush()
                cur_world = new_world
                attempt += 1
                continue
            if not verdict.retryable:
                sink.write(f"supervisor: rc={rc} ({verdict.reason}) is non-retryable; "
                           "giving up\n")
                return faults.normalize_rc(rc)
            if restarts_used >= max_restarts:
                sink.write(f"supervisor: restart budget exhausted ({max_restarts}); last "
                           f"failure rc={rc} ({verdict.reason})\n")
                return faults.normalize_rc(rc)
            next_world = cur_world
            if elastic:
                available = faults.probe_capacity(cap_file, full_world, current=cur_world)
                next_world = _elastic_world(full_world, available, min_world_size)
                if next_world != cur_world:
                    sink.write(
                        f"supervisor: capacity probe says {available} of {full_world} "
                        f"processes available — shrinking world {cur_world} -> {next_world} "
                        "for the relaunch (math preserved via the ACCUM_STEPS rescale)\n")
                    if sbus is not None:
                        sbus.point("elastic.world_resized", from_world=cur_world,
                                   to_world=next_world,
                                   phase="shrink" if next_world < cur_world else "grow",
                                   attempt=attempt + 1)
            delay = min(restart_backoff * (2 ** restarts_used), backoff_cap)
            sink.write(
                f"supervisor: attempt {attempt} failed (rc={rc}, {verdict.reason}"
                + (f"; flight: {', '.join(flight)}" if flight else "")
                + f"); restarting in {delay:g}s with resume enabled "
                f"(restart {restarts_used + 1}/{max_restarts})\n")
            if sbus is not None:
                sbus.counter("restarts")
                sbus.point("restart_scheduled", attempt=attempt + 1, backoff_s=delay, rc=rc,
                           reason=verdict.reason, world_size=next_world)
                sbus.flush()
            time.sleep(delay)
            cur_world = next_world
            attempt += 1
            restarts_used += 1
    finally:
        if sbus is not None:
            sbus.point("supervisor_exit")
            sbus.close()
            try:
                # Fold the supervisor's own record into the merged
                # timeline (launch_local merged before its last events).
                from distributeddeeplearning_tpu_torch.obs.report import merge_run_dir

                merge_run_dir(obs_dir)
            except Exception as e:  # merging must never mask the rc
                sink.write(f"supervisor: event merge failed: {e!r}\n")


def _truthy(value: str) -> bool:
    return value.strip().lower() in ("1", "true", "t", "yes", "y", "on")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributeddeeplearning_tpu_torch.launch",
        description="Launch a training script across local torch processes (one device "
                    "each), optionally under a restart supervisor with elastic worlds.")
    ap.add_argument("--num-processes", "-n", type=int, default=None)
    ap.add_argument("--devices-per-process", type=int, default=None,
                    help="accepted only as 1: a torch process drives one device")
    ap.add_argument("--platform", choices=PLATFORMS, default=None,
                    help="cpu: a gloo world on the CPU; gpu (the default): an NCCL world, "
                         "one card a process")
    ap.add_argument("--env", "-x", action="append", default=[], metavar="KEY=VALUE",
                    help="set env var in every process (mpirun -x equivalent)")
    ap.add_argument("--tpu", default=None,
                    help="pod mode: not in the port (the JAX launcher's; the orchestration "
                         "slice)")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--timeout", type=float, default=None)
    ap.add_argument("--hang-timeout", type=float, default=None,
                    help="kill the world if no process prints for this many seconds "
                         "(deadlocked-collective watchdog)")
    ap.add_argument("--obs-dir", default=os.environ.get("OBS_DIR") or None,
                    help="event-bus run directory: per-process events, launcher lifecycle "
                         "events, the merged events.jsonl (default: $OBS_DIR)")
    ap.add_argument("--max-restarts", type=int,
                    default=int(os.environ.get("MAX_RESTARTS", "0")),
                    help="relaunch the world up to N times after a retryable failure, "
                         "resuming from the newest checkpoint (default: $MAX_RESTARTS or 0)")
    ap.add_argument("--restart-backoff", type=float,
                    default=float(os.environ.get("RESTART_BACKOFF", "1.0")),
                    help="base seconds between restarts (base * 2^restart, capped at 60 s; "
                         "default: $RESTART_BACKOFF or 1.0)")
    ap.add_argument("--elastic", action="store_true",
                    default=_truthy(os.environ.get("ELASTIC", "")),
                    help="elastic worlds: relaunch at the surviving world size with "
                         "BATCHSIZE/ACCUM_STEPS rescaled, grow back when capacity returns "
                         "(default: $ELASTIC; requires --max-restarts)")
    ap.add_argument("--min-world-size", type=int,
                    default=int(os.environ.get("MIN_WORLD_SIZE", "1")),
                    help="elastic floor: never relaunch below this many processes "
                         "(default: $MIN_WORLD_SIZE or 1)")
    ap.add_argument("--grow-check-every-s", type=float,
                    default=float(os.environ.get("GROW_CHECK_EVERY_S", "30")),
                    help="how often a shrunken elastic world probes capacity for grow-back "
                         "(default: $GROW_CHECK_EVERY_S or 30)")
    ap.add_argument("--no-tag-output", action="store_true")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    if args.tpu:
        ap.error("--tpu (pod mode over gcloud TPU VMs) is the JAX launcher's "
                 "(python launch.py --tpu ...); the port brings it with the orchestration "
                 "slice")
    try:
        _check_devices_per_process(args.devices_per_process)
    except ValueError as e:
        ap.error(str(e))
    if args.elastic and args.max_restarts <= 0:
        ap.error("--elastic requires --max-restarts >= 1 (the supervisor)")
    extra_env = _parse_env_args(args.env)
    n = args.num_processes or 2
    if args.dry_run:
        print(f"launch: would fork {n} local processes of "
              f"{args.script} {' '.join(args.script_args)}")
        return 0
    local_kw = dict(num_processes=n, platform=args.platform,
                    tag_output=not args.no_tag_output, timeout=args.timeout,
                    hang_timeout=args.hang_timeout)
    try:
        if args.max_restarts > 0:
            return launch_supervised(
                args.script, args.script_args, max_restarts=args.max_restarts,
                restart_backoff=args.restart_backoff, elastic=args.elastic,
                min_world_size=args.min_world_size,
                grow_check_every_s=args.grow_check_every_s, env=extra_env,
                obs_dir=args.obs_dir, **local_kw)
        return launch_local(args.script, args.script_args, env=extra_env,
                            obs_dir=args.obs_dir, **local_kw)
    except RuntimeError as e:
        print(f"launch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
