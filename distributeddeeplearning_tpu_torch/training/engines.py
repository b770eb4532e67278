"""Engine construction: the dp part of the JAX package's
``training/engines.py`` (``Engine`` :46-68, ``build_engine`` :148,
``build_eval_step`` :251).

The port has one engine so far, ``dp``: replicated state (every rank
builds the same seeded model, the broadcast), the step's one all-reduce
over ``torch.distributed``, one process per GPU, each staging its own
slice of the global batch. ``pjit``, ``pp`` and ``sp`` raise
``NotImplementedError`` naming the mesh/engine slice, as the port's
``config.py`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.training.accum import validate_accum_config
from distributeddeeplearning_tpu_torch.training.state import TrainState, create_train_state
from distributeddeeplearning_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device

ENGINES = ("dp",)
_LATER_ENGINES = ("pjit", "pp", "sp")


def check_engine(engine: str) -> None:
    """Raise for an engine the port does not run."""
    if engine in _LATER_ENGINES:
        raise NotImplementedError(
            f"ENGINE={engine}: the port has {ENGINES} so far; {engine} comes with "
            f"the mesh/engine slice (pjit, pp, sp)")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (have {', '.join(ENGINES)})")


@dataclasses.dataclass
class Engine:
    """What one engine choice implies: the device, the model, the state
    and the two steps."""

    name: str
    device: torch.device
    model: Any
    state: TrainState
    train_step: Callable
    eval_step: Callable
    process_group: Any = None

    def warmup(self, batch, *, acc=None, eval_batch=None):
        """Capture the steps against ``batch``'s signature before the
        data flows (``AOT_WARMUP``): CUDA graphs installed on the steps,
        the capture seconds, the warm-up step's FLOPs and the library
        cache's hit/miss delta. See ``training/warmup.py``."""
        from distributeddeeplearning_tpu_torch.training.warmup import warmup_engine

        return warmup_engine(self, batch, acc=acc, eval_batch=eval_batch)


def build_engine(model, config: TrainConfig, tx, *, state: Optional[TrainState] = None,
                 device=None, process_group=None) -> Engine:
    """Build (state, train_step, eval_step) for ``config.engine`` on
    ``device`` (``None`` means CUDA, and raises without it). A given
    ``state`` is used as it is, not re-initialised."""
    check_engine(config.engine)
    dev = resolve_device(device)
    validate_accum_config(config, collectives.world_size(process_group))
    if state is None:
        state = create_train_state(model, config, tx, device=dev)
    return Engine(
        name=config.engine, device=dev, model=model, state=state,
        train_step=make_train_step(model, tx, config, process_group=process_group, device=dev),
        eval_step=make_eval_step(model, process_group=process_group, device=dev),
        process_group=process_group,
    )


def build_eval_step(model, config: TrainConfig, *, device=None, process_group=None):
    """Eval-only dispatch (``loop.evaluate`` with an existing state):
    ``(model, eval_step)``."""
    check_engine(config.engine)
    return model, make_eval_step(model, process_group=process_group, device=device)
