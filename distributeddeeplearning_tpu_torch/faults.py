"""The training loop's part of the JAX package's ``faults.py``: the
non-finite exit code, the ``FAULT_PLAN`` grammar, the step-indexed fault
injector and the checkpoint-corruption rehearsal.

Copied from the JAX module (it imports no JAX), with two changes:

* ``nan`` poisoning multiplies the batch's float tensors by NaN on their
  device (one elementwise op each, no host sync);
* :func:`checkpoint_steps` and :func:`corrupt_latest_checkpoint` read
  the port's checkpoint layout (``<MODEL_DIR>/<step>/``, see
  ``training/checkpoint.py``).

``kill``, ``term``, ``hang``, ``exit`` and ``nan`` fire as in JAX. The
elasticity verbs (``shrink``, ``restore_capacity``) parse, and the
injector raises ``NotImplementedError`` on them: their capacity file
and probes come with the process tier (``launch.py``).

Fault-plan grammar (``docs/ROBUSTNESS.md``)::

    FAULT_PLAN  := directive (";" directive)*
    directive   := kind ":" key "=" value ("," key "=" value)*
    kind        := kill | term | hang | nan | exit | shrink | restore_capacity
    keys        := step (fires once N optimizer steps have completed,
                   after that step's checkpoint if one is due), rank
                   (default: every process), secs (hang), code (exit),
                   ranks (shrink)

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

import torch

from distributeddeeplearning_tpu_torch import obs

#: Non-finite loss guard tripped (training/loop.py). Non-retryable: the
#: run is deterministic, so resuming from the last checkpoint replays
#: the same batches into the same NaN.
EXIT_NONFINITE = 121


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
_PROCESS_TIER = ("shrink", "restore_capacity")


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
    fault step recovers deterministically."""

    def __init__(self, faults: List[Fault], rank: int = 0):
        tier = sorted({f.kind for f in faults if f.kind in _PROCESS_TIER})
        if tier:
            raise NotImplementedError(
                f"FAULT_PLAN {', '.join(tier)}: the elasticity verbs come with the "
                f"process tier (launch.py, the capacity probes)")
        self.rank = rank
        self.pending = [f for f in faults if f.rank is None or f.rank == rank]

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        """Build from ``FAULT_PLAN`` (the rank from ``RANK``, else
        ``DDL_PROCESS_ID``); None when no plan targets this process."""
        e = os.environ if env is None else env
        plan = e.get("FAULT_PLAN")
        if not plan:
            return None
        rank = int(e.get("RANK", e.get("DDL_PROCESS_ID", "0")))
        inj = cls(parse_fault_plan(plan), rank=rank)
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
        return tuple(x * float("nan") if torch.is_tensor(x) and x.is_floating_point() else x
                     for x in batch)

    def due_after(self, global_step: int) -> bool:
        """True when a process-terminating fault fires once
        ``global_step`` steps have completed (the loop drains pending
        checkpoints first, so the resume point is deterministic)."""
        return any(f.step == global_step and f.kind != "nan" for f in self.pending)

    def fire_after(self, global_step: int) -> None:
        """Execute the terminal fault(s) for ``global_step``: kill, term
        and exit do not return; hang sleeps silently."""
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
