"""Structured observability for the port: the JAX package's event bus
and flight recorder (``obs/bus.py``), same schema and knobs
(``OBS_DIR``, ``OBS_RUN_ID``, ``OBS_RING_SIZE``, ``OBS_FLUSH_EVERY_S``);
the incremental tailer (``obs/tail.py``: ``Tailer``,
``activity_signature``, the launcher's telemetry liveness) and the run
report (``obs/report.py``: ``merge_run_dir``, the launcher's host-0
merge, ``summarize``, ``render``), both copies. Rollups, SLOs and the
trace plane are not ported yet."""

from distributeddeeplearning_tpu_torch.obs.bus import (
    DEFAULT_RING_SIZE,
    EventBus,
    TraceContext,
    bind_bus,
    bound_bus,
    configure,
    configure_from_env,
    counter,
    current_bus,
    current_trace,
    flush,
    gauge,
    get_bus,
    install_crash_handlers,
    new_span_id,
    new_trace_id,
    point,
    reset,
    span,
    span_event,
    trace_close,
    trace_ctx,
    trace_open,
)
from distributeddeeplearning_tpu_torch.obs.report import merge_run_dir, render, summarize
from distributeddeeplearning_tpu_torch.obs.tail import Tailer, activity_signature

__all__ = [
    "DEFAULT_RING_SIZE",
    "EventBus",
    "Tailer",
    "TraceContext",
    "activity_signature",
    "bind_bus",
    "bound_bus",
    "configure",
    "configure_from_env",
    "counter",
    "current_bus",
    "current_trace",
    "flush",
    "gauge",
    "get_bus",
    "install_crash_handlers",
    "merge_run_dir",
    "new_span_id",
    "new_trace_id",
    "point",
    "render",
    "reset",
    "span",
    "span_event",
    "summarize",
    "trace_close",
    "trace_ctx",
    "trace_open",
]
