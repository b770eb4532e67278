"""Liveness heartbeats for quiet-but-alive phases (long compiles): the
JAX package's ``utils/heartbeat.py``, copied as it is (it imports no
JAX). In the port the silent phases are the kernel builds
(``ops/_build.build``, wherever the first launch falls), the graph
capture (``training/warmup.py``) and the first step (library load,
cuDNN algorithm choice).

The launcher's hang watchdog (``launch.py --hang-timeout``) counts child
stdout bytes as liveness — the only signal that works for a world whose
processes are alive but wedged in a collective. Its false-positive mode:
a long AOT compile (or a cold first-step compile at pod scale) is
silent for minutes, and a healthy, compiling world gets killed at
``hang_timeout``.

Fix: during *known host-bound* phases the child emits a magic heartbeat
line every ``DDL_HEARTBEAT_EVERY_S`` seconds. The launcher exports that
knob automatically alongside ``--hang-timeout`` (a third of it) and its
log pump recognises the magic prefix: the line ticks the watchdog but is
suppressed from the streamed output, so operator logs stay clean.

Deliberately scoped: the heartbeat thread runs ONLY inside
:func:`during` blocks (kernel builds, graph capture, the run's first
dispatch).
A process blocked in a device collective releases the GIL, so an
always-on heartbeat thread would keep printing from a genuinely hung
world and the watchdog could never catch a real deadlock — exactly the
failure class it exists for.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Iterator, Optional

#: Line prefix the launcher's log pump recognises (and swallows).
MAGIC = "__ddl_heartbeat__"
ENV_VAR = "DDL_HEARTBEAT_EVERY_S"


def interval(env=None) -> float:
    """The configured heartbeat period in seconds (0 = disarmed)."""
    e = os.environ if env is None else env
    try:
        return max(float(e.get(ENV_VAR, "0") or 0), 0.0)
    except ValueError:
        return 0.0


@contextlib.contextmanager
def during(
    what: str, *, interval_s: Optional[float] = None, sink=None
) -> Iterator[None]:
    """Emit heartbeats while the wrapped (host-bound, silent) block runs.

    No-op unless ``DDL_HEARTBEAT_EVERY_S`` (or ``interval_s``) is > 0 —
    runs outside the launcher cost one env read. ``what`` names the phase
    in the heartbeat line for anyone tailing the raw child stream.
    """
    iv = interval() if interval_s is None else max(float(interval_s), 0.0)
    if iv <= 0:
        yield
        return
    out = sink or sys.stdout
    stop = threading.Event()

    def _pump() -> None:
        while not stop.wait(iv):
            try:
                out.write(f"{MAGIC} {what}\n")
                out.flush()
            except Exception:
                return  # a closed sink must never crash the compile

    t = threading.Thread(
        target=_pump, daemon=True, name=f"ddl-heartbeat-{what}"
    )
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(timeout=iv + 1.0)
