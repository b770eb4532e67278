"""The kernel-library cache and AOT warm-up as CUDA-graph capture: the
port of the JAX package's ``training/warmup.py``.

* :func:`enable_persistent_cache` points the kernel builds at a
  directory (config ``compilation_cache_dir`` / env
  ``COMPILATION_CACHE_DIR``): a re-run loads the libraries built there
  instead of running ``nvcc`` again, as JAX deserializes executables
  from its on-disk cache. Without it they go to the package's
  ``_build/``.
* :func:`cache_stats` counts the cache's hits (a library loaded without
  a compiler) and misses (a build), so a warm start can be *proved*
  (hits > 0 on a second process against a warm cache) instead of
  inferred from the wall clock; each event also goes on the bus as
  ``xla_cache_hit`` / ``xla_cache_miss``, the names the bus's readers
  key on.
* :func:`warmup_engine`, behind ``Engine.warmup()``, captures the train
  step (and the eval step when given ``eval_batch``) as CUDA graphs
  before the data flows (``metrics.StepFn.aot_compile``: warm-up steps
  on the capture stream, then one graph a phase), logs the capture
  seconds and the FLOPs of the eager warm-up step, and installs the
  graphs on the steps so the loop's calls replay them. On the CPU there
  is no graph: the warm-up step runs alone.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.utils import heartbeat
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

_stats = {"hits": 0, "misses": 0}
_listener_lock = threading.Lock()
_listener_installed = False


def _on_event(event: str, name: str) -> None:
    # The build module's load events are the ground truth for the
    # cache's behaviour; mirror them onto the event bus.
    if event == "hit":
        _stats["hits"] += 1
        obs.counter("xla_cache_hit")
    elif event == "miss":
        _stats["misses"] += 1
        obs.counter("xla_cache_miss")


def install_cache_listener() -> bool:
    """Subscribe to the kernel builds' hit/miss events (idempotent)."""
    global _listener_installed
    with _listener_lock:
        if not _listener_installed:
            _build.set_listener(_on_event)
            _listener_installed = True
        return True


def cache_stats() -> Tuple[int, int]:
    """(library cache hits, misses) observed so far this process."""
    return _stats["hits"], _stats["misses"]


def enable_persistent_cache(cache_dir: Optional[str]) -> None:
    """Build kernel libraries to, and load them from, ``cache_dir``;
    ``None``/empty goes back to the package's ``_build/``. Libraries
    already loaded in this process stay loaded. Each library's name
    carries the hash of its sources and flags, so a stale one never
    loads."""
    _build.set_cache_dir(cache_dir or None)
    if cache_dir:
        install_cache_listener()


def cost_analysis_flops(compiled: Any) -> Optional[float]:
    """FLOPs per step from the warm-up's count (None if there is none:
    advisory, never load-bearing, as XLA's cost analysis is in JAX)."""
    try:
        ca = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    if isinstance(ca, dict):
        flops = ca.get("flops", 0.0)
        return float(flops) if flops else None
    return None


def warmup_engine(eng, batch: Any, *, acc: Any = None, eval_batch: Any = None
                  ) -> Dict[str, float]:
    """Capture ``eng``'s steps against ``batch``'s signature.

    ``batch`` is a staged (device-resident) batch; ``acc`` non-None
    captures the accumulating train-step variant (what ``loop.fit``
    runs). Returns JAX's keys (the capture's seconds as
    ``train_compile_sec``/``eval_compile_sec``/``compile_sec``,
    ``train_flops_per_step``, ``accum_steps``, the cache hit/miss delta)
    and ``graphs_captured``, and logs a one-line summary."""
    log = get_logger()
    install_cache_listener()
    hits0, misses0 = cache_stats()
    info: Dict[str, float] = {}
    graphs, warm = 0, 0.0

    step = eng.train_step
    accum_steps = int(getattr(step, "accum_steps", 1))
    if accum_steps > 1:
        info["accum_steps"] = float(accum_steps)
    if hasattr(step, "aot_compile"):
        # Heartbeat while the capture works: the first kernel builds
        # are silent for minutes, and the launcher's hang watchdog
        # counts stdout as liveness (utils/heartbeat.py).
        with obs.span("compile", what="train_step", engine=eng.name,
                      accum_steps=accum_steps), heartbeat.during("aot_compile:train_step"):
            compiled, secs = step.aot_compile(eng.state, batch, acc, count_flops=True)
        info["train_compile_sec"] = secs
        graphs += compiled.graphs
        warm += compiled.warmup_sec
        flops = cost_analysis_flops(compiled)
        if flops is not None:
            info["train_flops_per_step"] = flops
    if eval_batch is not None and hasattr(eng.eval_step, "aot_compile"):
        with obs.span("compile", what="eval_step", engine=eng.name), \
                heartbeat.during("aot_compile:eval_step"):
            compiled, secs = eng.eval_step.aot_compile(eng.state, eval_batch)
        info["eval_compile_sec"] = secs
        graphs += compiled.graphs
        warm += compiled.warmup_sec

    hits1, misses1 = cache_stats()
    info["persistent_cache_hits"] = float(hits1 - hits0)
    info["persistent_cache_misses"] = float(misses1 - misses0)
    info["compile_sec"] = info.get("train_compile_sec", 0.0) + info.get("eval_compile_sec", 0.0)
    info["graphs_captured"] = float(graphs)
    flops = info.get("train_flops_per_step")
    log.info(
        "warmup(%s%s): captured %d graph(s) in %.2fs (eager warm-up steps %.2fs)%s "
        "(library cache: %d hit, %d miss)",
        eng.name, f", accum_steps={accum_steps}" if accum_steps > 1 else "", graphs,
        info["compile_sec"], warm, f", {flops / 1e9:.2f} GFLOP/step" if flops else "",
        hits1 - hits0, misses1 - misses0,
    )
    return info
