"""The training engine's loop: the port of the JAX package's
``training/loop.py`` (``FitResult``, ``resolve_engine``, ``fit``,
``_run_eval``, ``evaluate``), with JAX's order of events.

``fit`` builds the state (deterministic seeded init, the broadcast),
resumes from a checkpoint when there is one (the manifest's effective
batch checked; mid-epoch by replaying the epoch's first batches, or by
seeking a dataset that offers ``epoch_at``/``cursor``, the streamed
shards of ``data/stream/``, whose position goes into every manifest as
``data_cursor``), runs epochs of batches, read ahead on the host
(``PREFETCH_HOST_BATCHES``, for a dataset with the ``host_prefetch``
marker) and prefetched onto the device, through the step with the
on-device metric accumulator, saves step-granular checkpoints, executes the fault plan,
fires callbacks with the metrics still on the device, materialises ONE
tensor an epoch (the epoch means and the non-finite counter), applies
the non-finite guard, optionally evaluates, and prints the throughput
block (``utils/logging.log_summary``).

``ELASTIC`` turns the resume's effective-batch check from a warning
into a refusal, and ``LR_WORLD_SIZE`` sets the world of the LR
schedule's linear scaling (``launch.py``'s elastic supervisor pins it to
the full world). ``COMPILATION_CACHE_DIR`` points the kernel builds at a cache before the
engine is built; ``AOT_WARMUP`` captures the step as CUDA graphs on the
first staged batch, outside the dispatch clock (``training/warmup.py``;
``compile_sec``, ``graphs_captured`` and the steps that found no graph,
``eager_steps``, go into ``perf``); ``TRACE_EVERY_N_EPOCHS`` and
``TRACE_ON_SIGNAL`` start and stop ``torch.profiler`` captures at epoch
boundaries (``obs/trace.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import faults, obs
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.pipeline import prefetch_to_device
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.training.accum import resolve_accum_steps
from distributeddeeplearning_tpu_torch.training.callbacks import (
    Callback,
    CallbackList,
    LoggerCallback,
    ModelCheckpointCallback,
)
from distributeddeeplearning_tpu_torch.training.checkpoint import (
    CheckpointManager,
    build_manifest,
)
from distributeddeeplearning_tpu_torch.models.sharding import rules_table
from distributeddeeplearning_tpu_torch.parallel.mesh import dp_size
from distributeddeeplearning_tpu_torch.training.engines import (
    build_engine,
    build_eval_step,
    check_engine,
    resolve_mesh,
)
from distributeddeeplearning_tpu_torch.training.metrics import (
    accumulator_logs,
    finalize_accumulator,
    init_accumulator,
)
from distributeddeeplearning_tpu_torch.training.optimizer import create_optimizer
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.utils import heartbeat, hostsync
from distributeddeeplearning_tpu_torch.utils.device import resolve_device
from distributeddeeplearning_tpu_torch.utils.logging import get_logger, log_summary
from distributeddeeplearning_tpu_torch.utils.timer import Timer


class EpochDataset(Protocol):
    """The loop's dataset protocol (the synthetic datasets satisfy it)."""

    steps_per_epoch: int

    def epoch(self, epoch_index: int) -> Iterable[Tuple[np.ndarray, ...]]: ...

    def __len__(self) -> int: ...


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]]
    images_per_sec: float
    # Host-sync accounting for the run (utils/hostsync.py): the step's
    # host time p50/p99 (``dispatch_*``: eager, a step's whole host time,
    # every launch of it; captured, a graph replay's enqueue), wait
    # time, host_sync_count, accum_steps, effective_batch; with
    # AOT_WARMUP the warm-up's keys (training/warmup.py) and eager_steps.
    perf: Dict[str, float] = dataclasses.field(default_factory=dict)


def resolve_engine(config: TrainConfig, device=None) -> Tuple[str, torch.device]:
    """Validate the loop's settings and resolve the device (``None``
    means CUDA, and raises without it): ``(engine_name, device)``. The
    mesh of a mesh engine comes from ``engines.resolve_mesh``."""
    check_engine(config.engine)
    # The rules table's name (raises for an unknown one), and JAX's
    # refusal of FSDP outside pjit: the other engines keep parameters
    # replicated, so the user would silently not get ZeRO-3.
    rules_table(config.param_sharding)
    if config.engine != "pjit" and config.param_sharding == "fsdp":
        raise ValueError(f"PARAM_SHARDING={config.param_sharding!r} requires ENGINE=pjit "
                         f"(the {config.engine} engine keeps parameters replicated)")
    if config.pp_schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown PP_SCHEDULE {config.pp_schedule!r} (have gpipe, 1f1b)")
    resolve_accum_steps(config)
    if config.nonfinite_action not in ("abort", "warn", "off"):
        raise ValueError(f"NONFINITE_ACTION={config.nonfinite_action!r} (have abort, warn, off)")
    if config.data_topology not in ("process", "global"):
        raise ValueError(f"DATA_TOPOLOGY={config.data_topology!r} (have process, global)")
    if config.stream_shuffle_block < 1:
        raise ValueError(
            f"STREAM_SHUFFLE_BLOCK must be >= 1, got {config.stream_shuffle_block}")
    if config.prefetch_host_batches < 0:
        raise ValueError(
            f"PREFETCH_HOST_BATCHES must be >= 0, got {config.prefetch_host_batches}")
    if config.lr_world_size is not None and config.lr_world_size < 1:
        raise ValueError(f"LR_WORLD_SIZE must be >= 1, got {config.lr_world_size}")
    if config.checkpoint_every_steps < 0:
        raise ValueError(
            f"CHECKPOINT_EVERY_STEPS must be >= 0, got {config.checkpoint_every_steps}")
    if config.checkpoint_keep < 1:
        raise ValueError(f"CHECKPOINT_KEEP must be >= 1, got {config.checkpoint_keep}")
    return config.engine, resolve_device(device)


def fit(
    model,
    config: TrainConfig,
    train_data: EpochDataset,
    *,
    device=None,
    tx=None,
    epochs: Optional[int] = None,
    callbacks: Sequence[Callback] = (),
    eval_data: Optional[EpochDataset] = None,
    checkpoint_manager: Optional[CheckpointManager] = None,
    add_default_logger: bool = True,
    state: Optional[TrainState] = None,
    initial_epoch: int = 0,
    process_group=None,
    mesh=None,
) -> FitResult:
    """Train ``model`` for ``epochs`` over ``train_data`` on ``device``
    (``None`` means CUDA, and raises without it), data parallel over
    ``process_group`` (default: the ``torch.distributed`` world when one
    is initialised), or under a mesh engine over ``mesh`` (default: the
    config's, ``engines.resolve_mesh``). JAX's ``fit``, event for event
    (module docstring). ``train_data`` yields this rank's batches (its
    data shard's, ``Engine.batch_shard``)."""
    log = get_logger()
    # OBS_DIR turns on JSONL capture; without it every emit below is a
    # host-side append to the flight ring. Either way no device work.
    bus = obs.configure_from_env()
    from distributeddeeplearning_tpu_torch.obs import trace as obs_trace

    tracer = obs_trace.from_env()
    if config.compilation_cache_dir:
        # Before any kernel build (engine init included): re-runs load
        # the libraries built there instead of running nvcc again.
        from distributeddeeplearning_tpu_torch.training.warmup import enable_persistent_cache

        enable_persistent_cache(config.compilation_cache_dir)
    engine_name, dev = resolve_engine(config, device)
    if tracer is not None:
        tracer.cuda = dev.type == "cuda"
    epochs = epochs if epochs is not None else config.epochs
    steps_per_epoch = train_data.steps_per_epoch
    mesh = resolve_mesh(config, mesh)
    # Batch shards of the resolved mesh: the LR's linear scaling and the
    # throughput accounting (JAX's dp_size(mesh)).
    world = collectives.world_size(process_group) if mesh is None else dp_size(mesh)
    if tx is None:
        # An elastic world pins LR_WORLD_SIZE to the full world, so the
        # schedule (the linear-scaling rule) is the same at any size.
        tx, _ = create_optimizer(config, steps_per_epoch,
                                 world_size=config.lr_world_size or world)
    eng = build_engine(model, config, tx, state=state, device=dev,
                       process_group=process_group, mesh=mesh)
    state, model = eng.state, eng.model

    cbs = list(callbacks)
    if add_default_logger and not any(isinstance(c, LoggerCallback) for c in cbs):
        cbs.append(LoggerCallback())
    callback_list = CallbackList(cbs, context={
        "config": config, "device": dev, "steps_per_epoch": steps_per_epoch,
        "checkpoint_manager": checkpoint_manager,
    })

    # One manager per directory: an explicit manager, else the
    # checkpoint callback's (shared: the loop resumes from it, the
    # callback saves to it), else one from config.model_dir.
    ckpt_cb = next((c for c in cbs if isinstance(c, ModelCheckpointCallback)), None)
    ckpt = checkpoint_manager
    if ckpt is None and ckpt_cb is not None:
        ckpt = ckpt_cb.manager()
    if ckpt is None and config.model_dir:
        ckpt = CheckpointManager(
            config.model_dir, max_to_keep=config.checkpoint_keep,
            save_every_epochs=config.checkpoint_every_epochs,
            save_every_steps=config.checkpoint_every_steps,
            async_save=config.checkpoint_async)
    engine_saves = ckpt is not None and ckpt_cb is None

    # Resume: the checkpoint's position wins if it is further along than
    # initial_epoch; step keys resume mid-epoch (skip_steps batches of
    # the resume epoch were trained already).
    start_epoch = initial_epoch
    skip_steps = 0
    if ckpt is not None and ckpt.enabled and config.resume:
        state, ckpt_epoch, ckpt_skip = ckpt.maybe_restore_at(state, steps_per_epoch)
        manifest = ckpt.last_manifest
        elastic = config.elastic
        if manifest and manifest.get("effective_batch"):
            saved_eff = int(manifest["effective_batch"])
            have_eff = config.batch_size_per_device * world
            if saved_eff != have_eff:
                msg = (f"checkpoint was trained at effective batch {saved_eff} (world "
                       f"{manifest.get('world_size')}, accum {manifest.get('accum_steps')}) "
                       f"but this topology delivers {have_eff} "
                       f"({config.batch_size_per_device}/device x {world} shards) — rescale "
                       f"BATCHSIZE and ACCUM_STEPS together to hold the effective batch "
                       f"constant")
                if elastic:
                    raise ValueError(f"ELASTIC resume refused: {msg}")
                log.warning("%s (continuing: ELASTIC is off)", msg)
            elif (manifest.get("steps_per_epoch")
                  and int(manifest["steps_per_epoch"]) != steps_per_epoch and elastic):
                raise ValueError(
                    f"ELASTIC resume refused: checkpoint epoch geometry is "
                    f"{manifest['steps_per_epoch']} steps/epoch, this dataset delivers "
                    f"{steps_per_epoch} — the data cursor would be meaningless")
        if (ckpt_epoch, ckpt_skip) > (start_epoch, 0):
            start_epoch, skip_steps = ckpt_epoch, ckpt_skip
        if start_epoch or skip_steps:
            log.info("resuming from epoch %d step %d", start_epoch, skip_steps)
            bus.point("resume", epoch=start_epoch, step_in_epoch=skip_steps)
    # Host count of completed optimizer steps: the checkpoint key and the
    # fault plan's clock.
    global_step = start_epoch * steps_per_epoch + skip_steps
    injector = faults.FaultInjector.from_env()

    # A dataset offering epoch_at + cursor seeks to (epoch, step) instead
    # of replaying the epoch's prefix, and records its position in the
    # manifest (duck-typed, as in JAX; the synthetic datasets replay).
    supports_cursor = (callable(getattr(train_data, "epoch_at", None))
                       and callable(getattr(train_data, "cursor", None)))
    if supports_cursor and ckpt is not None and config.resume:
        saved_cursor = (ckpt.last_manifest or {}).get("data_cursor")
        if saved_cursor:
            live = train_data.cursor(start_epoch, skip_steps)
            drift = {k: (saved_cursor.get(k), live.get(k))
                     for k in ("seed", "records", "shuffle_block", "global_batch")
                     if saved_cursor.get(k) is not None and saved_cursor.get(k) != live.get(k)}
            if drift:
                log.warning("checkpoint data_cursor describes a different stream (%s) — "
                            "resume position is kept, but the continued stream is NOT the "
                            "one the checkpoint was trained on",
                            ", ".join(f"{k}: saved {a} != live {b}"
                                      for k, (a, b) in drift.items()))

    train_step = eng.train_step
    accum_steps = int(getattr(train_step, "accum_steps", config.accum_steps))

    def make_manifest(step_key: int):
        """The manifest of a checkpoint at ``step_key``, as a zero-arg
        callable: the manager builds it only for saves that are due
        (host ints only, no device work)."""

        def _build():
            return build_manifest(
                global_step=step_key, steps_per_epoch=steps_per_epoch,
                effective_batch=int(global_batch), accum_steps=accum_steps,
                data_cursor=(train_data.cursor(step_key // steps_per_epoch,
                                               step_key % steps_per_epoch)
                             if supports_cursor else None),
                world_size=world)

        return _build

    eval_step = eng.eval_step if eval_data is not None else None
    # A hand-rolled step without the accumulator contract keeps the
    # last-step-metrics epoch summary.
    accumulates = getattr(train_step, "accumulates_metrics", False)
    clock = hostsync.StepClock()
    sync_start = hostsync.accountant().count
    warmup_pending = config.aot_warmup
    warmup_info: Dict[str, float] = {}
    eager_start = getattr(train_step, "eager_calls", 0)

    # Host read-ahead for datasets that offer it (the streamed shard
    # readers set the marker; synthetic pools gain nothing from a thread).
    host_prefetch_depth = (config.prefetch_host_batches
                           if getattr(train_data, "host_prefetch", False) else 0)
    if host_prefetch_depth:
        from distributeddeeplearning_tpu_torch.data.stream import prefetch as stream_prefetch

    history: List[Dict[str, float]] = []
    # Throughput counts what the dataset delivers (the staged batch's
    # leading dim, shape metadata only) times the ranks.
    global_batch = config.batch_size_per_device * world
    run_timer = Timer().start()
    total_images = 0
    callback_list.on_train_begin({"state": state})
    bus.point("run_begin", engine=engine_name, model=config.model, epochs=epochs,
              start_epoch=start_epoch, start_step_in_epoch=skip_steps,
              steps_per_epoch=steps_per_epoch, devices=world, accum_steps=accum_steps)
    metrics: Dict[str, Any] = {}
    first_dispatch = True
    for epoch in range(start_epoch, epochs):
        if tracer is not None:
            tracer.maybe_start(epoch)
        epoch_t0 = time.monotonic()
        callback_list.on_epoch_begin(epoch)
        step_in_epoch = 0
        # A fresh on-device accumulator an epoch.
        acc = init_accumulator(dev) if accumulates else None
        if epoch == start_epoch and skip_steps and supports_cursor:
            seek_t0 = time.monotonic()
            batches = train_data.epoch_at(epoch, skip_steps)
            seek_s = time.monotonic() - seek_t0
            bus.span_event("data.resume_seek", seek_s, epoch=epoch, offset=skip_steps)
            bus.gauge("data.resume_skip_batches", 0.0)
            bus.gauge("data.resume_skip_ms", seek_s * 1000.0)
            bus.point("resume_seek", epoch=epoch, offset=skip_steps)
            log.info("resume sought to epoch %d step %d in %.2f ms", epoch, skip_steps,
                     seek_s * 1000.0)
        else:
            batches = train_data.epoch(epoch)
            if epoch == start_epoch and skip_steps:
                # Mid-epoch resume: the epoch stream is deterministic in
                # (seed, epoch), so dropping its first batches, before
                # any staging, replays exactly what the checkpoint had
                # not covered yet. Consumed eagerly and timed.
                skip_t0 = time.monotonic()
                batches = iter(batches)
                skipped = sum(1 for _ in itertools.islice(batches, skip_steps))
                skip_s = time.monotonic() - skip_t0
                bus.span_event("data.resume_skip", skip_s, epoch=epoch, skipped=skipped)
                bus.gauge("data.resume_skip_batches", float(skipped))
                bus.gauge("data.resume_skip_ms", skip_s * 1000.0)
                bus.point("resume_skip", epoch=epoch, skipped=skip_steps)
                log.info("resume replayed %d skipped batch(es) in %.1f ms", skipped,
                         skip_s * 1000.0)
        if host_prefetch_depth:
            # The shard read and batch assembly on a background thread
            # (data.wait, data.buffer_depth, data.bytes_per_s);
            # prefetch_to_device below still stages onto the device.
            batches = stream_prefetch.host_prefetch(batches, depth=host_prefetch_depth)
        for batch in prefetch_to_device(batches, dev, size=config.prefetch_batches):
            global_batch = int(batch[0].shape[0]) * world
            if warmup_pending:
                # Capture against the real staged signature, OUTSIDE the
                # dispatch clock: the capture's time is compile_sec, not
                # step time.
                warmup_info = eng.warmup(batch, acc=acc)
                warmup_pending = False
            if injector is not None:
                # FAULT_PLAN nan:step=N poisons the batch whose dispatch
                # completes step N: an on-device multiply, no host sync.
                batch = injector.poison(global_step + 1, batch)
            t0 = time.perf_counter()
            # The run's first step loads libraries, picks cuDNN
            # algorithms and builds kernels: heartbeat through it.
            with (heartbeat.during("first_step_compile") if first_dispatch
                  else contextlib.nullcontext()):
                if accumulates:
                    state, metrics, acc = train_step(state, batch, acc)
                else:
                    state, metrics = train_step(state, batch)
            first_dispatch = False
            dispatch_s = time.perf_counter() - t0
            clock.note_dispatch(dispatch_s)
            bus.span_event("step", dispatch_s, epoch=epoch)
            step_in_epoch += 1
            global_step += 1
            if ckpt is not None and ckpt.step_granular:
                # A due step-granular save copies the state to the host:
                # the durability-vs-sync trade (off by default).
                ckpt.save_step(global_step, state, manifest=make_manifest(global_step))
            if injector is not None and injector.due_after(global_step):
                # Make pending saves durable first, so the kill point is
                # deterministic relative to the resume point, then die.
                if ckpt is not None:
                    ckpt.wait()
                bus.flush()
                injector.fire_after(global_step)
            if config.log_every_steps and step_in_epoch % config.log_every_steps == 0:
                # The metrics and the accumulator stay on the device: a
                # callback that reads them pays (and owns) that sync.
                callback_list.on_step_end(step_in_epoch, {
                    "metrics": metrics, "state": state, "metric_accumulator": acc})
        epoch_images = step_in_epoch * global_batch
        total_images += epoch_images
        # THE one host sync an epoch: the on-device epoch means and the
        # non-finite count (or, for a step without the accumulator, the
        # last step's metrics) in one device_get.
        epoch_values = finalize_accumulator(acc) if accumulates else metrics
        with clock.waiting(), bus.span("epoch_materialize", epoch=epoch):
            host = hostsync.device_get(epoch_values, label="epoch_metrics")
            epoch_logs: Dict[str, Any] = (accumulator_logs(host) if accumulates
                                          else {k: float(v) for k, v in host.items()})
        # The non-finite guard: the accumulator counted NaN/Inf-loss
        # steps on the device; the count came with the sync above.
        nonfinite_steps = int(epoch_logs.pop("nonfinite_steps", 0.0))
        if not accumulates:
            loss_v = epoch_logs.get("loss")
            nonfinite_steps = int(loss_v is not None and not np.isfinite(loss_v))
        if nonfinite_steps and config.nonfinite_action != "off":
            bus.point("nonfinite_loss", epoch=epoch, steps=nonfinite_steps,
                      action=config.nonfinite_action)
            bus.flush()
            if config.nonfinite_action == "abort":
                log.error("non-finite loss in %d step(s) of epoch %d — aborting with exit %d "
                          "(non-retryable: a resume would replay the same batches into the "
                          "same NaN)", nonfinite_steps, epoch, faults.EXIT_NONFINITE)
                if bus.directory:
                    bus.dump_flight("nonfinite_loss")
                if ckpt is not None:
                    ckpt.wait()
                raise faults.NonFiniteLossError(epoch, nonfinite_steps)
            log.warning("non-finite loss in %d step(s) of epoch %d "
                        "(NONFINITE_ACTION=warn: continuing)", nonfinite_steps, epoch)
        epoch_logs["epoch_images"] = epoch_images
        epoch_logs["global_step"] = global_step

        if eval_step is not None and eval_data is not None and config.validation:
            eval_metrics = _run_eval(eval_step, state, eval_data, dev, config)
            epoch_logs.update({f"val_{k}": v for k, v in eval_metrics.items()})

        history.append({k: v for k, v in epoch_logs.items() if k != "state"})
        for k, v in epoch_logs.items():
            if isinstance(v, (int, float)):
                bus.gauge(f"epoch.{k}", float(v), epoch=epoch)
        epoch_logs["state"] = state
        epoch_logs["ckpt_manifest"] = make_manifest(global_step)
        callback_list.on_epoch_end(epoch, epoch_logs)
        if engine_saves:
            ckpt.save_epoch_end(epoch, state, global_step=global_step,
                                manifest=make_manifest(global_step))
        bus.span_event("epoch", time.monotonic() - epoch_t0, t=epoch_t0, epoch=epoch,
                       steps=step_in_epoch)
        if tracer is not None:
            tracer.maybe_stop(epoch)
        bus.flush()  # epoch boundary: the one place events hit disk

    run_timer.stop()
    callback_list.on_train_end({"state": state})
    if ckpt is not None:
        ckpt.wait()

    perf = clock.summary()
    perf["host_sync_count"] = float(hostsync.accountant().count - sync_start)
    perf.update(warmup_info)
    if warmup_info:
        # Steps that found no graph for their signature (a padded tail
        # batch) and ran eager: the only steps that do once graphs exist.
        perf["eager_steps"] = float(getattr(train_step, "eager_calls", 0) - eager_start)
    # One dispatch is one optimizer step on the whole staged batch, with
    # or without in-step accumulation: the delivered batch IS the
    # effective batch.
    perf["accum_steps"] = float(accum_steps)
    perf["effective_batch"] = float(global_batch)
    extra: Dict[str, Any] = {
        "host_sync_count": int(perf["host_sync_count"]),
        "dispatch_p50_ms": round(perf["dispatch_p50_ms"], 3),
        "dispatch_p99_ms": round(perf["dispatch_p99_ms"], 3),
    }
    if accum_steps > 1:
        extra["accum_steps"] = accum_steps
        extra["effective_batch"] = int(global_batch)
    if "compile_sec" in perf:
        extra["compile_sec"] = round(perf["compile_sec"], 3)
        extra["graphs_captured"] = int(perf["graphs_captured"])
    images_per_sec = log_summary(
        data_length=total_images, duration_s=run_timer.elapsed,
        batch_size_per_device=config.batch_size_per_device, num_devices=world,
        dataset_kind="synthetic" if config.fake else "real", extra_fields=extra)
    for k, v in perf.items():
        bus.gauge(f"perf.{k}", float(v))
    bus.point("run_end", images_per_sec=round(images_per_sec, 1))
    bus.flush()
    return FitResult(state=state, history=history, images_per_sec=images_per_sec, perf=perf)


def _run_eval(eval_step, state, eval_data, device, config) -> Dict[str, float]:
    """Sample-exact evaluation: each batch's means re-weighted by its
    real-sample ``count``, so padded tail batches and full batches
    combine into metrics over exactly the dataset. One materialisation
    an eval batch (boundary work, not the hot loop)."""
    totals: Dict[str, float] = {}
    samples = 0.0
    for batch in prefetch_to_device(eval_data.epoch(0), device, size=config.prefetch_batches):
        host = hostsync.device_get(eval_step(state, batch), label="eval_batch")
        m = {k: float(v) for k, v in host.items()}
        count = m.pop("count", None)
        if count is None:  # an eval step without counts: unweighted means
            count = 1.0
        samples += count
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + v * count
    out = {k: v / max(samples, 1.0) for k, v in totals.items()}
    out["samples"] = samples
    return out


def evaluate(model, config: TrainConfig, eval_data: EpochDataset, state: TrainState, *,
             device=None, process_group=None, mesh=None) -> Dict[str, float]:
    """Standalone evaluation (the reference's ``validate()``) of
    ``state`` over ``eval_data`` on ``device`` (``None`` means CUDA)."""
    _, dev = resolve_engine(config, device)
    if state.layout is not None:  # a mesh engine's model is the state's
        model = state.model
    _, eval_step = build_eval_step(model, config, device=dev, process_group=process_group,
                                   mesh=mesh)
    return _run_eval(eval_step, state, eval_data, dev, config)
