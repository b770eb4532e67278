"""Incremental event-file tailer — the read side of a *running* world.

Copied whole from ``distributeddeeplearning_tpu/obs/tail.py`` (it never
imported jax); the port's launcher reads :func:`activity_signature` as
the hang watchdog's telemetry liveness.

``obs/report.py`` merges event files post-mortem; this module follows
them while the run is alive. A :class:`Tailer` points at a run
directory and, on every :meth:`poll`, returns the events appended since
the last poll across **all** part files — including files that appear
mid-run (a restart attempt's ``events-p0-r1.jsonl``, a late-joining
process, the launcher's own ``events-launcher.jsonl``).

Correctness details a naive ``tail -f`` gets wrong:

* **Per-file byte offsets** — each file is re-opened per poll (robust to
  rotation/truncation) and read from its recorded offset; only bytes up
  to the last complete ``\\n`` are consumed, so a *partial final line*
  (a process flushed mid-record, or we raced the writer) is left in the
  file and picked up whole on a later poll — never emitted torn, never
  emitted twice.
* **Truncation reset** — a file that shrank below its offset was
  rewritten (a process restarted *without* the supervisor's
  ``OBS_PROC_SUFFIX`` identity); the cursor resets to 0 and the file's
  meta line is re-read.
* **Clock alignment** — every event is placed on one wall timeline via
  *its own file's* meta clock pair (``wall = wall0 + (t - mono0)``), so
  files from different hosts/processes/attempts interleave correctly
  even when their monotonic clocks share nothing.
* **Undecodable lines** are counted (``errors``) and skipped, never
  raised — the tailer must survive anything a dying process can write.

The tailer is jax-free and does no device work; it is safe to run in a
supervisor, a dashboard, or inside the serving process itself.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Tuple

#: The launcher's world-exit merge output — never tailed (it duplicates
#: every part file the tailer already follows).
MERGED_BASENAME = "events.jsonl"


class _FileCursor:
    """Tail state for one part file: byte offset + its meta clock pair."""

    __slots__ = ("path", "offset", "meta", "errors")

    def __init__(self, path: str) -> None:
        self.path = path
        self.offset = 0
        self.meta: Optional[dict] = None
        self.errors = 0

    def read_new(self) -> List[dict]:
        """Parse the complete lines appended since the last call."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self.offset:
            # Truncated/rewritten underneath us: start over (and drop the
            # stale clock pair — the rewriter owns the file now).
            self.offset = 0
            self.meta = None
        if size == self.offset:
            return []
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self.offset)
                data = fh.read(size - self.offset)
        except OSError:
            return []
        # Consume only up to the last complete line; a torn tail stays in
        # the file for the next poll.
        nl = data.rfind(b"\n")
        if nl < 0:
            return []
        self.offset += nl + 1
        out: List[dict] = []
        for raw in data[: nl + 1].splitlines():
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except (json.JSONDecodeError, UnicodeDecodeError):
                self.errors += 1
                continue
            if not isinstance(rec, dict):
                self.errors += 1
                continue
            if rec.get("kind") in ("meta", "flight_meta"):
                if self.meta is None:
                    self.meta = rec
                continue
            out.append(rec)
        return out


class Tailer:
    """Follow every ``events-*.jsonl`` part file in a run directory.

    :meth:`poll` returns the newly appended events (wall-stamped, sorted
    by wall time); files discovered between polls join seamlessly. The
    merged ``events.jsonl`` and ``flight-*.jsonl`` dumps are excluded —
    both duplicate events the part files already carry.
    """

    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)
        self._cursors: Dict[str, _FileCursor] = {}
        #: events returned over the tailer's lifetime (all polls)
        self.events_seen = 0

    def _discover(self) -> List[str]:
        paths = []
        for p in sorted(
            glob.glob(os.path.join(self.directory, "events-*.jsonl"))
        ):
            if os.path.basename(p) != MERGED_BASENAME:
                paths.append(p)
        return paths

    @property
    def files(self) -> List[str]:
        """The part files currently being followed."""
        return sorted(self._cursors)

    @property
    def errors(self) -> int:
        """Lines that failed to decode across all files (skipped)."""
        return sum(c.errors for c in self._cursors.values())

    def poll(self) -> List[dict]:
        """New events since the last poll, each stamped with ``wall``
        (its file's meta clock pair applied; ``None`` when the file has
        no meta line yet), sorted onto the one wall timeline."""
        events: List[dict] = []
        for path in self._discover():
            cur = self._cursors.get(path)
            if cur is None:
                cur = self._cursors[path] = _FileCursor(path)
            fresh = cur.read_new()
            if not fresh:
                continue
            m = cur.meta
            for e in fresh:
                t = e.get("t")
                if m is not None and t is not None:
                    e["wall"] = m["wall0"] + (t - m["mono0"])
                else:
                    e.setdefault("wall", None)
            events.extend(fresh)
        events.sort(key=lambda e: (e["wall"] is None, e.get("wall") or 0.0))
        self.events_seen += len(events)
        return events

    def positions(self) -> Dict[str, int]:
        """Per-file byte offsets (diagnostics / tests)."""
        return {p: c.offset for p, c in self._cursors.items()}


def activity_signature(directory: str) -> Tuple[Tuple[str, int], ...]:
    """A cheap, comparable fingerprint of a run directory's event files:
    ``((basename, size), ...)``. Two different signatures mean some
    process appended telemetry in between — the launcher's watchdog uses
    this as a liveness signal (a world that stopped printing but still
    emits events is *working*, not hung). stat() only; no file reads, no
    JSON parsing — safe to call from a 10 Hz supervisor loop."""
    sig: List[Tuple[str, int]] = []
    for p in sorted(
        glob.glob(os.path.join(directory, "events-*.jsonl"))
        + glob.glob(os.path.join(directory, "flight-*.jsonl"))
    ):
        if os.path.basename(p) == MERGED_BASENAME:
            continue
        try:
            sig.append((os.path.basename(p), os.path.getsize(p)))
        except OSError:
            continue
    return tuple(sig)
