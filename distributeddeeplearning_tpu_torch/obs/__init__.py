"""Structured observability for the port: the JAX package's event bus
and flight recorder (``obs/bus.py``), same schema and knobs
(``OBS_DIR``, ``OBS_RUN_ID``, ``OBS_RING_SIZE``, ``OBS_FLUSH_EVERY_S``);
the incremental tailer (``obs/tail.py``: ``Tailer``,
``activity_signature``, the launcher's telemetry liveness) and the run
report (``obs/report.py``: ``merge_run_dir``, the launcher's host-0
merge, ``summarize``, ``render``, its trace section included); and the
live plane: windowed rollups and their atomic snapshot
(``obs/rollup.py``: ``WindowedAggregator``, ``LivePlane``), the SLO
engine (``obs/slo.py``: ``SLO_SPEC``, burn rates, ``slo_breach`` /
``slo_recover``) and per-request critical paths (``obs/traces.py``:
``reconstruct``). All copies of the JAX package's jax-free modules."""

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
from distributeddeeplearning_tpu_torch.obs.rollup import (
    LivePlane,
    WindowedAggregator,
    read_snapshot,
    write_snapshot,
)
from distributeddeeplearning_tpu_torch.obs.slo import (
    Objective,
    SloEngine,
    parse_slo_spec,
)
from distributeddeeplearning_tpu_torch.obs.tail import Tailer, activity_signature
from distributeddeeplearning_tpu_torch.obs.traces import reconstruct

__all__ = [
    "DEFAULT_RING_SIZE",
    "EventBus",
    "LivePlane",
    "Objective",
    "SloEngine",
    "Tailer",
    "TraceContext",
    "WindowedAggregator",
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
    "parse_slo_spec",
    "point",
    "read_snapshot",
    "reconstruct",
    "render",
    "reset",
    "span",
    "span_event",
    "summarize",
    "trace_close",
    "trace_ctx",
    "trace_open",
    "write_snapshot",
]
