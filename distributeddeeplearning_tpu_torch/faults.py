"""Failure taxonomy and deterministic fault injection: the port of the
JAX package's ``faults.py`` (it imports no JAX), with three changes:

* ``nan`` poisoning multiplies the batch's float tensors by NaN on their
  device (one elementwise op each, no host sync);
* :func:`checkpoint_steps` and :func:`corrupt_latest_checkpoint` read
  the port's checkpoint layout (``<MODEL_DIR>/<step>/``, see
  ``training/checkpoint.py``);
* the injector's rank and world are ``RANK`` and ``WORLD_SIZE``
  (torch's ``env://`` contract) when set, else ``DDL_PROCESS_ID`` and
  ``DDL_NUM_PROCESSES`` (the launcher's).

The module is the vocabulary the process tier speaks:

* **Exit codes** (:func:`classify_exit`, :func:`normalize_rc`): the
  restart supervisor (``launch.launch_supervised``) retries a hang
  (125), a signal death or a crash, and stops at a non-finite loss
  (121: a resume would replay the same NaN), a spent timeout (124) or
  an operator interrupt (130). A resize stop (95) is a handover.
* **Fault plan** (``FAULT_PLAN``, :class:`FaultInjector`): step-indexed,
  one-shot faults the training loop executes at step boundaries.
* **Capacity protocol** (:func:`write_capacity`, :func:`probe_capacity`):
  the file an elastic supervisor probes before it relaunches, which the
  ``shrink`` and ``restore_capacity`` verbs write.

Importing the module imports no ``torch``: the launcher and its
supervisor read the exit codes and the capacity file for free.

Fault-plan grammar (``docs/ROBUSTNESS.md``)::

    FAULT_PLAN  := directive (";" directive)*
    directive   := kind ":" key "=" value ("," key "=" value)*
    kind        := kill | term | hang | nan | exit | shrink | restore_capacity
    keys        := step (fires once N optimizer steps have completed,
                   after that step's checkpoint if one is due; required
                   except for restore_capacity), rank (default: every
                   process), secs (hang: its length; restore_capacity:
                   the wall-clock delay after the shrink), code (exit),
                   ranks (shrink: processes lost, default 1)

    FAULT_PLAN="shrink:step=3,ranks=1;restore_capacity:secs=30"
        # the top rank SIGKILLs itself after step 3 and the capacity
        # file records one process gone; 30 s later the probe reads
        # full capacity again
    FAULT_PLAN="shrink:step=3;restore_capacity:step=6"
        # the shrunken world itself announces full capacity once
        # step 6 completes (deterministic drills)

``nan`` poisons the batch whose dispatch makes ``step`` complete, so
the loss goes non-finite and the on-device guard trips at the epoch
boundary. Integer-only batches (token LMs) cannot carry a NaN.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time
from typing import List, Optional

from distributeddeeplearning_tpu_torch import obs

EXIT_OK = 0
#: Non-finite loss guard tripped (training/loop.py). Non-retryable: the
#: run is deterministic, so resuming from the last checkpoint replays
#: the same batches into the same NaN.
EXIT_NONFINITE = 121
#: Launcher wall-clock budget exhausted (``--timeout``). Non-retryable.
EXIT_TIMEOUT = 124
#: Hang watchdog fired (no child output for ``--hang-timeout``).
#: Retryable: a wedged collective is what a teardown and resume fix.
EXIT_HUNG = 125
#: Operator interrupt (Ctrl-C). Non-retryable.
EXIT_INTERRUPTED = 130
#: Elastic resize stop: the supervisor stopped a (shrunken) world to
#: relaunch it at another size. Retryable, and not counted against the
#: restart budget: a handover, not a failure.
EXIT_RESIZE = 95


@dataclasses.dataclass(frozen=True)
class ExitClass:
    """Verdict for one world exit code."""

    rc: int
    retryable: bool
    reason: str


def classify_exit(rc: int) -> ExitClass:
    """Map a world exit code onto the restart policy."""
    if rc == EXIT_OK:
        return ExitClass(rc, False, "success")
    if rc == EXIT_NONFINITE:
        return ExitClass(rc, False, "nonfinite_loss")
    if rc == EXIT_TIMEOUT:
        return ExitClass(rc, False, "timeout_budget_exhausted")
    if rc == EXIT_INTERRUPTED:
        return ExitClass(rc, False, "interrupted")
    if rc == EXIT_HUNG:
        return ExitClass(rc, True, "world_hung")
    if rc == EXIT_RESIZE:
        return ExitClass(rc, True, "world_resize")
    if rc < 0:
        # subprocess convention: -N = died on signal N (SIGKILL
        # preemption, OOM-kill, segfault), the canonical retryable case.
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = str(-rc)
        return ExitClass(rc, True, f"signal_{name}")
    return ExitClass(rc, True, f"crash_rc_{rc}")


def normalize_rc(rc: int) -> int:
    """Shell-presentable exit code: a signal death (-N) becomes 128+N."""
    return 128 - rc if rc < 0 else rc


class NonFiniteLossError(SystemExit):
    """Raised by the training loop when the on-device non-finite guard
    trips. A ``SystemExit`` carrying :data:`EXIT_NONFINITE`, so an
    uncaught escape exits the process with the code a supervisor
    classifies as non-retryable."""

    def __init__(self, epoch: int, steps: int):
        super().__init__(EXIT_NONFINITE)
        self.epoch = epoch
        self.nonfinite_steps = steps

    def __str__(self) -> str:  # SystemExit.__str__ would print the code
        return (
            f"non-finite loss in {self.nonfinite_steps} step(s) of epoch "
            f"{self.epoch} (exit {EXIT_NONFINITE}, non-retryable)"
        )


FAULT_KINDS = ("kill", "term", "hang", "nan", "exit", "shrink", "restore_capacity")
_INT_KEYS = ("step", "rank", "code", "ranks")


def split_plan(text: str, kinds) -> List:
    """Lexical layer of the grammar: ``(raw, kind, [(key, value_str),
    ...])`` triples, validating kind membership and key=value form."""
    out = []
    for raw in (text or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, rest = raw.partition(":")
        kind = kind.strip()
        if kind not in kinds:
            raise ValueError(
                f"unknown fault kind {kind!r} in {raw!r} (have {', '.join(kinds)})")
        pairs = []
        for pair in rest.split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(f"fault directive {raw!r}: expected key=value, got {pair!r}")
            k, v = (s.strip() for s in pair.split("=", 1))
            pairs.append((k, v))
        out.append((raw, kind, pairs))
    return out


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    step: int  # 0 only for restore_capacity's wall-clock (secs) form
    rank: Optional[int] = None  # None = every process
    secs: float = 3600.0  # hang duration / restore_capacity delay
    code: int = 1  # exit code for kind="exit"
    ranks: int = 1  # processes LOST by a shrink


def parse_fault_plan(text: str) -> List[Fault]:
    """Parse a ``FAULT_PLAN`` string (module docstring grammar), with
    the JAX package's validation."""
    faults: List[Fault] = []
    for raw, kind, pairs in split_plan(text, FAULT_KINDS):
        kw: dict = {}
        for k, v in pairs:
            if k not in ("step", "rank", "secs", "code", "ranks"):
                raise ValueError(f"fault directive {raw!r}: unknown key {k!r}")
            if k == "ranks" and kind != "shrink":
                raise ValueError(f"fault directive {raw!r}: ranks= applies to shrink only")
            kw[k] = int(v) if k in _INT_KEYS else float(v)
        if kind == "restore_capacity":
            if "secs" not in kw and "step" not in kw:
                raise ValueError(
                    f"fault directive {raw!r}: restore_capacity needs "
                    f"secs= (wall clock) or step= (step-indexed)")
            kw.setdefault("step", 0)
            if kw["step"] < 0:
                raise ValueError(f"fault directive {raw!r}: step must be >= 1")
        elif "step" not in kw:
            raise ValueError(f"fault directive {raw!r}: step= is required")
        elif kw["step"] < 1:
            raise ValueError(
                f"fault directive {raw!r}: step counts COMPLETED optimizer "
                f"steps and must be >= 1")
        if kw.get("ranks", 1) < 1:
            raise ValueError(f"fault directive {raw!r}: ranks= must be >= 1")
        faults.append(Fault(kind=kind, **kw))
    return faults


class FaultInjector:
    """Step-indexed fault execution for this process: the loop calls
    :meth:`poison` before dispatching a step and :meth:`fire_after` once
    a step (and its checkpoint, if due) completed. Each fault fires at
    most once per process, so a restarted world that resumes past the
    fault step recovers deterministically.

    The elasticity verbs read ``world`` (this world's processes),
    ``full_world`` (the world a ``restore_capacity`` announces) and
    ``capacity_file``: ``shrink`` records the surviving count in the
    capacity file, then SIGKILLs this process when it is one of the top
    ``ranks`` casualties; a step-indexed ``restore_capacity`` records
    full capacity and returns (the supervisor's grow poller stops the
    world)."""

    def __init__(self, faults: List[Fault], rank: int = 0, *, world: int = 1,
                 full_world: Optional[int] = None, capacity_file: Optional[str] = None):
        self.rank = rank
        self.world = max(int(world), 1)
        self.full_world = max(int(full_world or self.world), self.world)
        self.capacity_file = capacity_file
        # A wall-clock restore (secs only, step 0) never fires from the
        # step clock: the shrink folds it into the file as restore_at.
        self.restore_secs = next((f.secs for f in faults
                                  if f.kind == "restore_capacity" and f.step == 0), None)
        self.pending = [f for f in faults
                        if (f.rank is None or f.rank == rank)
                        and not (f.kind == "restore_capacity" and f.step == 0)]

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        """Build from ``FAULT_PLAN``: the rank from ``RANK``, else
        ``DDL_PROCESS_ID``; the world from ``WORLD_SIZE``, else
        ``DDL_NUM_PROCESSES``, and ``DDL_WORLD_FULL``; the capacity file from
        ``ELASTIC_CAPACITY_FILE``, else ``$OBS_DIR/capacity.json``.
        None when no plan targets this process."""
        e = os.environ if env is None else env
        plan = e.get("FAULT_PLAN")
        if not plan:
            return None
        rank = int(e.get("RANK", e.get("DDL_PROCESS_ID", "0")))
        cap = e.get(CAPACITY_FILE_ENV)
        if not cap and e.get("OBS_DIR"):
            cap = os.path.join(e["OBS_DIR"], "capacity.json")
        inj = cls(parse_fault_plan(plan), rank=rank,
                  world=int(e.get("WORLD_SIZE", e.get("DDL_NUM_PROCESSES", "1"))),
                  full_world=int(e.get("DDL_WORLD_FULL", "0")) or None, capacity_file=cap)
        return inj if inj.pending else None

    def _take(self, global_step: int, kinds) -> List[Fault]:
        due = [f for f in self.pending if f.step == global_step and f.kind in kinds]
        if due:
            self.pending = [f for f in self.pending if f not in due]
        return due

    def poison(self, global_step: int, batch):
        """NaN-poison ``batch`` (a tuple of tensors) when a ``nan`` fault
        targets the step this dispatch completes: each float tensor is
        multiplied by NaN on its device, no host sync."""
        if not self._take(global_step, ("nan",)):
            return batch
        obs.point("fault_fired", kind="nan", step=global_step, rank=self.rank)
        obs.flush()
        import torch

        return tuple(x * float("nan") if torch.is_tensor(x) and x.is_floating_point() else x
                     for x in batch)

    def due_after(self, global_step: int) -> bool:
        """True when a process-terminating (or capacity-changing) fault
        fires once ``global_step`` steps have completed (the loop drains
        pending checkpoints first, so the resume point is
        deterministic)."""
        return any(f.step == global_step and f.kind != "nan" for f in self.pending)

    def fire_after(self, global_step: int) -> None:
        """Execute the terminal fault(s) for ``global_step``: kill, term
        and exit do not return; hang sleeps silently; shrink records the
        lost capacity, then SIGKILLs the casualties; restore_capacity
        records full capacity and returns."""
        for f in self._take(global_step, ("shrink", "restore_capacity")):
            bus = obs.get_bus()
            bus.point("fault_fired", kind=f.kind, step=f.step, rank=self.rank,
                      ranks=f.ranks if f.kind == "shrink" else None)
            bus.flush()
            if f.kind == "restore_capacity":
                if self.capacity_file:
                    write_capacity(self.capacity_file, self.full_world, owner="fault")
                continue
            # Capacity is the cluster's: the full world lost f.ranks
            # processes, however often the directive fires. The
            # casualties are the top ranks of the current world.
            if self.capacity_file:
                restore_at = (time.time() + self.restore_secs
                              if self.restore_secs is not None else None)
                write_capacity(self.capacity_file, max(self.full_world - f.ranks, 0),
                               restore_at=restore_at, owner="fault")
            if self.rank >= max(self.world - f.ranks, 0):
                # A casualty: SIGKILL, like a real capacity loss, after
                # dumping the black box (SIGKILL is unhandleable).
                if bus.directory:
                    bus.dump_flight("fault_shrink")
                os.kill(os.getpid(), signal.SIGKILL)
        for f in self._take(global_step, ("kill", "term", "hang", "exit")):
            bus = obs.get_bus()
            bus.point("fault_fired", kind=f.kind, step=f.step, rank=self.rank)
            bus.flush()
            if f.kind == "kill":
                # SIGKILL is unhandleable: dump the black box ourselves.
                if bus.directory:
                    bus.dump_flight("fault_kill")
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "term":
                # Preemption rehearsal: an installed SIGTERM handler dumps
                # the flight ring and re-delivers the signal.
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(30)
            elif f.kind == "hang":
                time.sleep(f.secs)
            elif f.kind == "exit":
                sys.exit(f.code)


#: Env var naming the capacity file shared by the elastic supervisor and
#: the ``shrink``/``restore_capacity`` verbs.
CAPACITY_FILE_ENV = "ELASTIC_CAPACITY_FILE"

#: Env var: seconds beyond which a capacity file's mtime marks it stale
#: (a dead writer's leftover). 0, the default, disables the check. A
#: stale file reads as "no change", never as a shrink.
CAPACITY_STALE_ENV = "CAPACITY_STALE_S"

#: Owners the capacity file may name. ``None`` (a file without the
#: field) stays valid; any other owner marks the file invalid: a
#: foreign writer must never shrink the world.
CAPACITY_OWNERS = ("fault", "arbiter", "operator")


def write_capacity(path: str, available: int, restore_at: Optional[float] = None,
                   owner: Optional[str] = None) -> None:
    """Atomically record cluster capacity: ``available`` schedulable
    processes, back to full at wall-clock ``restore_at`` when given.
    Written to a temporary file and renamed into place, so a reader
    never sees half a file."""
    import json

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"available": int(available), "restore_at": restore_at, "owner": owner}, fh)
    os.replace(tmp, path)


def probe_capacity(path: Optional[str], full: int, *, current: Optional[int] = None) -> int:
    """How many processes can be scheduled now. No file means full
    capacity; a ``restore_at`` in the past means capacity came back. An
    invalid file (torn or malformed JSON, staler than
    ``CAPACITY_STALE_S``, an unknown ``owner``) reads as "no change"
    (``current`` when given, else ``full``) with a
    ``capacity_file_invalid`` point: it never crashes the supervisor or
    shrinks the world."""
    import json

    if not path:
        return full
    fallback = full if current is None else current

    def _invalid(reason: str) -> int:
        obs.point("capacity_file_invalid", reason=reason, path=str(path))
        return fallback

    try:
        with open(path) as fh:
            raw = fh.read()
    except FileNotFoundError:
        return full
    except OSError:
        return _invalid("unreadable")
    try:
        d = json.loads(raw)
    except ValueError:
        return _invalid("malformed")
    if not isinstance(d, dict):
        return _invalid("malformed")
    try:
        stale_s = float(os.environ.get(CAPACITY_STALE_ENV, "0") or 0)
    except ValueError:
        stale_s = 0.0
    if stale_s > 0:
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            age = None
        if age is not None and age > stale_s:
            return _invalid("stale")
    owner = d.get("owner")
    if owner is not None and owner not in CAPACITY_OWNERS:
        return _invalid("unknown_owner")
    try:
        restore_at = d.get("restore_at")
        if restore_at is not None and time.time() >= float(restore_at):
            return full
        return max(min(int(d.get("available", full)), full), 0)
    except (TypeError, ValueError):
        return _invalid("malformed")


def checkpoint_steps(directory: str) -> List[int]:
    """Committed checkpoint steps under ``directory`` (numeric
    directories; the temporary directory of a save in progress is
    excluded)."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit())


def corrupt_latest_checkpoint(directory: str, truncate_to: int = 1) -> Optional[str]:
    """Truncate every file of the NEWEST checkpoint step, the on-disk
    state a preemption mid-write leaves behind. Returns the corrupted
    step directory (None when there is none)."""
    steps = checkpoint_steps(directory)
    if not steps:
        return None
    target = os.path.join(directory, str(steps[-1]))
    for root, _, files in os.walk(target):
        for name in files:
            path = os.path.join(root, name)
            try:
                with open(path, "r+b") as fh:
                    fh.truncate(min(truncate_to, os.path.getsize(path)))
            except OSError:
                pass
    return target
