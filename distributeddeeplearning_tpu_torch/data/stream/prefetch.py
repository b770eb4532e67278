"""Host-side overlapped prefetch for streamed datasets.

``prefetch_to_device`` (data/pipeline.py) overlaps the host→device
*transfer* with compute; for streamed shards there is a second leg to
hide — the host *read/assemble* work (memmap gathers, normalization).
``host_prefetch`` runs the dataset iterator on a bounded background
thread so that leg overlaps the step dispatch too, and instruments the
data plane through the obs bus (docs/OBSERVABILITY.md):

* ``data.wait`` span per batch — how long the consumer blocked on the
  reader (p50/p99 in obs_report/obs_watch; ~0 when prefetch keeps up,
  ~batch read time when the pipeline is the bottleneck);
* ``data.buffer_depth`` gauge — staged batches remaining after each
  take (persistently 0 = reader-bound, persistently full = step-bound);
* ``data.bytes`` counter + ``data.bytes_per_s`` gauge — delivered
  host-batch bytes and the running delivery rate.

Math-neutral and sync-free by construction: batches pass through
untouched and in order, and everything here is numpy + host clocks —
it adds no host sync (``utils/hostsync``'s accountant counts none).
Composes as ``prefetch_to_device(host_prefetch(ds.epoch(e)))``: the
training loop wires it automatically for datasets carrying the
``host_prefetch`` marker (``PREFETCH_HOST_BATCHES`` deep).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator

import numpy as np

from distributeddeeplearning_tpu_torch import obs


def _batch_nbytes(batch: Any) -> int:
    """Total numpy payload bytes of one host batch (tuples/lists/dicts
    of arrays; non-array leaves count 0)."""
    if isinstance(batch, np.ndarray):
        return batch.nbytes
    if isinstance(batch, dict):
        return sum(_batch_nbytes(v) for v in batch.values())
    if isinstance(batch, (tuple, list)):
        return sum(_batch_nbytes(v) for v in batch)
    return 0


def host_prefetch(
    it: Iterable[Any], *, depth: int = 2
) -> Iterator[Any]:
    """Yield ``it``'s batches unchanged, read ``depth`` ahead on a
    daemon thread. ``depth <= 0`` is a transparent passthrough (no
    thread, no instrumentation)."""
    if depth <= 0:
        yield from it
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list = []
    cancelled = threading.Event()

    def _put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if not _put(batch):
                    return  # consumer gone: stop reading
        except Exception as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(
        target=producer, daemon=True, name="ddl-host-prefetch"
    )
    t.start()
    total_bytes = 0
    t0 = time.monotonic()
    try:
        while True:
            wait_t0 = time.perf_counter()
            item = q.get()
            wait_s = time.perf_counter() - wait_t0
            if item is _END:
                if err:
                    raise err[0]
                return
            obs.span_event("data.wait", wait_s)
            obs.gauge("data.buffer_depth", float(q.qsize()))
            nbytes = _batch_nbytes(item)
            if nbytes:
                total_bytes += nbytes
                obs.counter("data.bytes", nbytes)
                elapsed = time.monotonic() - t0
                if elapsed > 0:
                    obs.gauge("data.bytes_per_s", total_bytes / elapsed)
            yield item
    finally:
        # Consumer abandoned the generator: unblock + stop the reader so
        # the thread and its staged batches are released.
        cancelled.set()
