"""Callback machinery: the port of the JAX package's
``training/callbacks.py``, every class, parity with the reference Keras
path's hooks.

The reference's richest feature set lives in Keras callbacks
(``imagenet_keras_horovod.py:194-227``): ``BroadcastGlobalVariables``,
``MetricAverage``, 5-epoch LR warmup, stepwise LR schedule, a
``LoggerCallback`` printing per-epoch throughput (``:230-244``), and
rank-0 ``ModelCheckpoint`` (``:316-318``). Same surface here, with the
same division of labour as in JAX:

* Warmup/schedule callbacks are **declarative markers**: a front-end
  reads them when it builds the schedule, which the optimizer evaluates
  on the host at its count (no per-step callback pokes an LR).
* ``MetricAverageCallback`` and ``BroadcastGlobalVariablesCallback`` are
  satisfied by construction (the step's all-reduce mean; deterministic
  seeded init): they validate and document rather than move bytes.
* ``LoggerCallback`` / ``ModelCheckpointCallback`` do what the reference
  ones do, the latter on the port's ``CheckpointManager``.

No callback here reads a device tensor: ``on_step_end`` hands over the
metrics still on the device, and a callback that materialises them pays
(and owns) that host sync.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.utils.logging import get_logger
from distributeddeeplearning_tpu_torch.utils.timer import Timer

Logs = Dict[str, Any]


class Callback:
    """Base callback. ``set_context`` receives a dict with keys like
    ``config``, ``device``, ``steps_per_epoch``, ``checkpoint_manager``."""

    def set_context(self, context: Dict[str, Any]) -> None:
        self.context = context

    def on_train_begin(self, logs: Optional[Logs] = None) -> None: ...

    def on_epoch_begin(self, epoch: int, logs: Optional[Logs] = None) -> None: ...

    def on_step_end(self, step: int, logs: Optional[Logs] = None) -> None: ...

    def on_epoch_end(self, epoch: int, logs: Optional[Logs] = None) -> None: ...

    def on_train_end(self, logs: Optional[Logs] = None) -> None: ...


class CallbackList:
    def __init__(self, callbacks: Sequence[Callback], context: Dict[str, Any]):
        self.callbacks = list(callbacks)
        for cb in self.callbacks:
            cb.set_context(context)

    def __iter__(self):
        return iter(self.callbacks)

    def on_train_begin(self, logs=None):
        for cb in self.callbacks:
            cb.on_train_begin(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_begin(epoch, logs)

    def on_step_end(self, step, logs=None):
        for cb in self.callbacks:
            cb.on_step_end(step, logs)

    def on_epoch_end(self, epoch, logs=None):
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, logs)

    def on_train_end(self, logs=None):
        for cb in self.callbacks:
            cb.on_train_end(logs)


class LoggerCallback(Callback):
    """Per-epoch loss/metrics + throughput (reference ``LoggerCallback``,
    ``imagenet_keras_horovod.py:230-244``)."""

    def __init__(self):
        self._timer = Timer()
        self._log = get_logger()

    def on_epoch_begin(self, epoch, logs=None):
        self._timer = Timer().start()

    def on_epoch_end(self, epoch, logs=None):
        self._timer.stop()
        logs = logs or {}
        duration = self._timer.elapsed
        images = logs.get("epoch_images", 0)
        parts = [
            f"{k}={float(v):.4f}"
            for k, v in logs.items()
            if k not in ("epoch_images",) and _is_number(v)
        ]
        if images and duration > 0:
            parts.append(f"images/sec={images / duration:.1f}")
        parts.append(f"duration={duration:.2f}s")
        self._log.info(" ".join(parts), extra={"epoch": epoch})


class ModelCheckpointCallback(Callback):
    """Rank-0-written checkpoint each ``save_every_epochs`` (reference
    Keras ``ModelCheckpoint`` ``:316-318``), on the port's manager."""

    def __init__(self, directory: Optional[str] = None, save_every_epochs: int = 1):
        self.directory = directory
        self.save_every_epochs = save_every_epochs
        self._mgr = None

    def manager(self):
        if self._mgr is None:
            # Share the engine-provided manager when there is one: a
            # directory must never have two live managers.
            shared = self.context.get("checkpoint_manager")
            if shared is not None:
                self._mgr = shared
                return self._mgr
            from distributeddeeplearning_tpu_torch.training.checkpoint import (
                CheckpointManager,
            )

            cfg = self.context.get("config")
            directory = self.directory or (cfg.model_dir if cfg else None)
            # Honour the config's robustness contract so a callback-owned
            # manager keys checkpoints exactly like an engine-owned one
            # (CHECKPOINT_EVERY_STEPS / CHECKPOINT_ASYNC — the loop's
            # mid-epoch saves and resume go through this same manager).
            self._mgr = CheckpointManager(
                directory,
                max_to_keep=getattr(cfg, "checkpoint_keep", 3) if cfg else 3,
                save_every_epochs=self.save_every_epochs,
                save_every_steps=getattr(cfg, "checkpoint_every_steps", 0)
                if cfg else 0,
                async_save=getattr(cfg, "checkpoint_async", True)
                if cfg else True,
            )
        return self._mgr

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        state = logs.get("state")
        if state is not None:
            # save_epoch_end keeps the key space consistent when the
            # shared manager is step-granular (CHECKPOINT_EVERY_STEPS);
            # plain epoch keying otherwise.
            self.manager().save_epoch_end(
                epoch, state, global_step=logs.get("global_step"),
                manifest=logs.get("ckpt_manifest"),
            )

    def on_train_end(self, logs=None):
        if self._mgr is not None:
            self._mgr.wait()


class LearningRateWarmupCallback(Callback):
    """Declarative marker: N-epoch linear warmup (reference ``:211-213``).
    Consumed when the schedule is built; at run time this callback only
    logs the configuration."""

    def __init__(self, warmup_epochs: int = 5, verbose: bool = False):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        if self.verbose and collectives.is_master():
            get_logger().info(
                "LR warmup over %d epochs (built into the schedule)",
                self.warmup_epochs,
            )


class LearningRateScheduleCallback(Callback):
    """Declarative marker: multiply LR by ``multiplier`` from
    ``start_epoch`` on (reference builds the 30/60/80 staircase from four
    of these, ``:215-224``). Consumed when the schedule is built."""

    def __init__(self, multiplier: float, start_epoch: int):
        self.multiplier = multiplier
        self.start_epoch = start_epoch


class BroadcastGlobalVariablesCallback(Callback):
    """Parity shim for Horovod's broadcast (reference ``:202``): with
    deterministic seeded init every process already holds identical
    parameters, and every rank restores the same checkpoint. At train
    begin this checks, with a host all-reduce, that the step counter (a
    host int in the port) is equal on every rank, rather than moving
    bytes."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None):
        state = (logs or {}).get("state")
        if state is None:
            return
        step = int(state.step)
        mean = collectives.allreduce_host_scalar(float(step), average=True)
        if mean != float(step):
            raise RuntimeError(
                f"state diverged across processes: step {step} here, mean {mean}")


class MetricAverageCallback(Callback):
    """Parity shim for Horovod's metric averaging (reference ``:207``):
    metrics are already averaged over the ranks inside the step (one
    all-reduce, ``train_step.py``), so there is nothing to do at epoch
    end; kept so reference callback lists port 1:1."""


def _is_number(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
