"""Estimator-style front-end: the port of the JAX package's
``frontends/estimator.py``, parity with the reference TF path.

Reference shape (``imagenet_estimator_tf_horovod.py:413-455``): build a
``RunConfig`` (``_get_runconfig`` :348-361), an ``Estimator(model_fn,
model_dir, params)`` (:436-438), then ``model.train(input_fn, steps,
hooks)`` / ``model.evaluate(input_fn)`` (:444-455). Same surface here:
``model_fn`` returns the model (from the port's zoo or any module with
its interface) or names one; ``input_fn`` returns an engine dataset;
hooks are callbacks.

What the reference's pieces became:
* ``_get_runconfig`` GPU pinning (:352-358) → ``RunConfig.device`` (one
  process per GPU; ``parallel/distributed.maybe_initialize`` pins it).
* ``_get_model_dir`` rank-0/temp-dir split (:364-374) → the checkpoint
  manager writes from rank 0; one directory.
* ``BroadcastGlobalVariablesHook(0)`` (:380) → deterministic seeded init.
* ``steps // hvd.size()`` (:446) → the dataset yields this process's
  share of each global batch; steps_per_epoch already accounts for the
  world size.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import loop as engine
from distributeddeeplearning_tpu_torch.training.callbacks import Callback
from distributeddeeplearning_tpu_torch.training.state import TrainState


@dataclasses.dataclass
class RunConfig:
    """Reference ``_get_runconfig`` equivalent: run-level knobs that are
    not hyperparameters. ``device`` (``None`` means CUDA) and
    ``process_group`` take the place of JAX's ``mesh``."""

    model_dir: Optional[str] = None
    save_checkpoints_epochs: int = 1
    keep_checkpoint_max: int = 3
    device: object = None
    process_group: object = None


class Estimator:
    def __init__(
        self,
        model_fn: Callable[[TrainConfig], object] | str,
        config: Optional[TrainConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        self.config = config or TrainConfig()
        self.run_config = run_config or RunConfig(model_dir=self.config.model_dir)
        if isinstance(model_fn, str):
            name = model_fn
            device = self.run_config.device
            model_fn = lambda cfg: get_model(name, **cfg.model_kwargs(), device=device)  # noqa: E731
        self.model = model_fn(self.config)
        self._state: Optional[TrainState] = None
        self._ckpt = None
        if self.run_config.model_dir:
            from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(
                self.run_config.model_dir,
                max_to_keep=self.run_config.keep_checkpoint_max,
                save_every_epochs=self.run_config.save_checkpoints_epochs,
            )

    def train(
        self,
        input_fn: Callable[[TrainConfig], engine.EpochDataset],
        epochs: Optional[int] = None,
        hooks: Sequence[Callback] = (),
    ) -> "Estimator":
        data = input_fn(self.config)
        result = engine.fit(
            self.model,
            self.config,
            data,
            device=self.run_config.device,
            process_group=self.run_config.process_group,
            epochs=epochs,
            callbacks=hooks,
            checkpoint_manager=self._ckpt,
            state=self._state,
        )
        self._state = result.state
        self.last_result = result
        return self

    def evaluate(
        self, input_fn: Callable[[TrainConfig], engine.EpochDataset]
    ) -> Dict[str, float]:
        if self._state is None:
            raise RuntimeError("call train() before evaluate(), or restore")
        return engine.evaluate(
            self.model,
            self.config,
            input_fn(self.config),
            self._state,
            device=self.run_config.device,
            process_group=self.run_config.process_group,
        )

    @property
    def state(self) -> Optional[TrainState]:
        return self._state
