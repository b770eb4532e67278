"""Light child for the port's supervisor, launcher and elastic tests: the
twin of ``tests/_fault_child.py`` that imports only the port's
``faults`` and ``obs`` (and ``ops._build`` for ``BUILD_LIBRARY``): no
torch, no JAX.

A stand-in training loop: it counts steps, persists its progress to a
per-rank state file (the checkpoint's analogue), consults the
``FAULT_PLAN`` injector after every step as ``loop.fit`` does, and emits
through the bus. Run under ``python -m distributeddeeplearning_tpu_torch.launch
--max-restarts`` it drives the crash, classify, back off, relaunch and
resume cycle in seconds.

Unlike the JAX child it never races its supervisor:

* its first line is printed before any import, so the hang watchdog's
  clock starts from a live process;
* in the first attempt, every process still alive after the step of a
  ``shrink`` directive (whichever rank it names) blocks there until the
  launcher stops the world, as a survivor blocked in a collective
  would: it never runs on to a later directive of the same plan;
* on a shrunken world (``DDL_NUM_PROCESSES`` < ``DDL_WORLD_FULL``) a
  process that fired ``restore_capacity`` blocks until the grow poller
  stops the world, so the shrunken world cannot finish first.

A block ends with exit 3 after ``BLOCK_DEADLINE_S`` (default 120): a
test fails instead of hanging.

Env contract: ``FAKE_STEPS`` (total steps, default 6), ``STATE_FILE``
(progress-file prefix; ``.{rank}`` appended), ``BUILD_LIBRARY`` (a
``csrc/*.cpp`` library to load through ``ops/_build`` first, printing
the cache's hits and misses), plus the launcher's ``DDL_*``,
``FAULT_PLAN`` and ``OBS_*``.
"""

import os
import sys
import time

print(f"FAULT_CHILD_START {os.environ.get('DDL_PROCESS_ID', '0')}", flush=True)

from distributeddeeplearning_tpu_torch import faults, obs  # noqa: E402


def _block(what: str) -> None:
    """Wait to be stopped by the launcher (SIGTERM); exit 3 at the
    deadline."""
    print(f"FAULT_CHILD_BLOCKED {what}", flush=True)
    deadline = time.monotonic() + float(os.environ.get("BLOCK_DEADLINE_S", "120"))
    while time.monotonic() < deadline:
        time.sleep(0.05)
    print(f"FAULT_CHILD_BLOCK_DEADLINE {what}", flush=True)
    sys.exit(3)


def _build_library(name: str, rank: int) -> None:
    from distributeddeeplearning_tpu_torch.ops import _build

    events = []
    _build.set_listener(lambda event, lib: events.append(event))
    _build.set_cache_dir(os.environ.get("COMPILATION_CACHE_DIR"))
    _build.load(name)
    print(f"FAULT_CHILD_CACHE {rank} hits={events.count('hit')} "
          f"misses={events.count('miss')}", flush=True)


def main() -> None:
    bus = obs.configure_from_env()
    rank = int(os.environ.get("DDL_PROCESS_ID", "0"))
    world = int(os.environ.get("DDL_NUM_PROCESSES", "1"))
    full_world = int(os.environ.get("DDL_WORLD_FULL", "0")) or world
    steps = int(os.environ.get("FAKE_STEPS", "6"))
    injector = faults.FaultInjector.from_env()
    first_attempt = not os.environ.get("DDL_RESTART")
    shrink_steps = {f.step for f in faults.parse_fault_plan(os.environ.get("FAULT_PLAN", ""))
                    if f.kind == "shrink"}
    state_file = os.environ.get("STATE_FILE")
    path = f"{state_file}.{rank}" if state_file else None

    cache = os.environ.get("COMPILATION_CACHE_DIR")
    if cache:
        print(f"FAULT_CHILD_CACHE_DIR {rank} {cache}", flush=True)
    if os.environ.get("BUILD_LIBRARY"):
        _build_library(os.environ["BUILD_LIBRARY"], rank)

    if os.environ.get("ELASTIC"):  # elastic drills assert the rescale
        print(f"FAULT_CHILD_WORLD rank={rank} world={world} "
              f"batch={os.environ.get('BATCHSIZE', '-')} "
              f"accum={os.environ.get('ACCUM_STEPS', '-')} "
              f"lr_world={os.environ.get('LR_WORLD_SIZE', '-')}", flush=True)

    start = 0
    if path and os.path.exists(path):
        with open(path) as fh:
            start = int(fh.read().strip() or 0)

    for step in range(start + 1, steps + 1):
        print(f"step {step} rank {rank}", flush=True)
        with bus.span("fake_step", step=step, rank=rank):
            time.sleep(0.05)
        if path:  # "checkpoint": durable before any fault can fire
            with open(path, "w") as fh:
                fh.write(str(step))
        restored = False
        if injector is not None and injector.due_after(step):
            restored = any(f.kind == "restore_capacity" and f.step == step
                           for f in injector.pending)
            bus.flush()
            injector.fire_after(step)  # a casualty of a shrink dies here
        if first_attempt and step in shrink_steps:
            _block(f"survivor step={step}")
        if restored and world < full_world:
            _block(f"restored step={step}")
    bus.flush()
    print(f"FAULT_CHILD_DONE {rank} start={start}", flush=True)


if __name__ == "__main__":
    main()
