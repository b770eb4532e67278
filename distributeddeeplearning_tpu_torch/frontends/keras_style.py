"""Keras-style front-end — compile/fit with callbacks: the port of the
JAX package's ``frontends/keras_style.py``.

Parity with the reference Keras mainline (``imagenet_keras_horovod.py:
273-353``): ``model.compile(optimizer, loss, metrics)`` then
``model.fit(data, epochs, callbacks=[...])`` with the callback set the
reference uses (Broadcast, MetricAverage, warmup, schedule, logger,
checkpoint — see ``training/callbacks.py``). The warmup/schedule
callbacks are read HERE, at fit time, to build the schedule the
optimizer evaluates — the declarative-marker design that keeps the hot
loop free of per-step callbacks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.training import loop as engine
from distributeddeeplearning_tpu_torch.training.callbacks import (
    Callback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
)
from distributeddeeplearning_tpu_torch.training.optimizer import create_optimizer
from distributeddeeplearning_tpu_torch.training.state import TrainState


class Model:
    """``module_or_name`` is a model of the port's zoo by name (built on
    ``device``, ``None`` meaning CUDA) or a module already built."""

    def __init__(self, module_or_name, config: Optional[TrainConfig] = None, *,
                 device=None, process_group=None):
        self.config = config or TrainConfig()
        self.device = device
        self.process_group = process_group
        self.module = (
            get_model(module_or_name, **self.config.model_kwargs(), device=device)
            if isinstance(module_or_name, str)
            else module_or_name
        )
        self._compiled = False
        self._state: Optional[TrainState] = None

    def compile(
        self,
        optimizer: str = "sgd",
        loss: str = "sparse_categorical_crossentropy",
        metrics: Sequence[str] = ("accuracy",),
    ) -> "Model":
        """Record compile-time choices. The optimizer is built at
        ``fit`` time when steps_per_epoch and schedule-affecting
        callbacks are known (the reference builds its optimizer at
        ``:155-166`` and layers warmup/decay on via callbacks later —
        same information, one construction point here)."""
        if optimizer not in ("sgd", "momentum"):
            raise ValueError(f"unsupported optimizer {optimizer!r} (have sgd)")
        if loss not in (
            "sparse_categorical_crossentropy",
            # one-hot labels — the reference Keras compile() choice
            # (imagenet_keras_horovod.py:307); the engine's loss accepts
            # both label shapes.
            "categorical_crossentropy",
        ):
            raise ValueError(f"unsupported loss {loss!r}")
        self._compiled = True
        return self

    def fit(
        self,
        data: engine.EpochDataset,
        epochs: Optional[int] = None,
        callbacks: Sequence[Callback] = (),
        validation_data: Optional[engine.EpochDataset] = None,
        initial_epoch: int = 0,
    ) -> engine.FitResult:
        if not self._compiled:
            raise RuntimeError("call compile() before fit()")
        cfg = self.config
        # Consume declarative schedule callbacks (reference :211-224).
        warmups = [c for c in callbacks if isinstance(c, LearningRateWarmupCallback)]
        scheds = [c for c in callbacks if isinstance(c, LearningRateScheduleCallback)]
        if warmups:
            cfg = cfg.replace(warmup_epochs=warmups[0].warmup_epochs)
        if scheds:
            # Reference semantics (Horovod LearningRateScheduleCallback):
            # each callback's multiplier is ABSOLUTE w.r.t. the base LR
            # from its start_epoch on. The piecewise schedule multiplies
            # factors cumulatively, so convert: per-boundary factor =
            # this multiplier / previous multiplier.
            ordered = sorted(scheds, key=lambda c: c.start_epoch)
            decay_epochs = tuple(c.start_epoch for c in ordered)
            mults = [c.multiplier for c in ordered]
            ratios = tuple(m / (mults[i - 1] if i else 1.0) for i, m in enumerate(mults))
            cfg = cfg.replace(lr_decay_epochs=decay_epochs, lr_decay_factors=ratios)
        from distributeddeeplearning_tpu_torch.parallel.mesh import dp_size
        from distributeddeeplearning_tpu_torch.training.engines import resolve_mesh

        mesh = resolve_mesh(cfg)  # a mesh engine's; its batch shards scale the LR
        world = collectives.world_size(self.process_group) if mesh is None else dp_size(mesh)
        tx, self.lr_schedule = create_optimizer(cfg, data.steps_per_epoch, world_size=world)
        result = engine.fit(
            self.module,
            cfg,
            data,
            device=self.device,
            process_group=self.process_group,
            mesh=mesh,
            tx=tx,
            epochs=epochs,
            callbacks=callbacks,
            eval_data=validation_data,
            state=self._state,
            initial_epoch=initial_epoch,
        )
        self._state = result.state
        self.config = cfg
        return result

    def evaluate(self, data: engine.EpochDataset) -> Dict[str, float]:
        if self._state is None:
            raise RuntimeError("fit() (or load) before evaluate()")
        return engine.evaluate(self.module, self.config, data, self._state,
                               device=self.device, process_group=self.process_group)

    def save_weights(self, directory: str, epoch: int = 0) -> None:
        from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager

        mgr = CheckpointManager(directory)
        mgr.save(epoch, self._state, force=True)
        mgr.close()

    def load_weights(self, directory: str) -> "Model":
        from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager
        from distributeddeeplearning_tpu_torch.training.state import create_train_state

        if self._state is None:
            _, dev = engine.resolve_engine(self.config, self.device)
            tx, _ = create_optimizer(self.config, steps_per_epoch=1)
            self._state = create_train_state(self.module, self.config, tx, device=dev)
        mgr = CheckpointManager(directory)
        self._state, _ = mgr.maybe_restore(self._state)
        mgr.close()
        return self

    @property
    def state(self) -> Optional[TrainState]:
        return self._state
