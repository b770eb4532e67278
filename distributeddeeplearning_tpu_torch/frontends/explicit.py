"""Explicit-loop front-end — the PyTorch-style path: you own the loop.
The port of the JAX package's ``frontends/explicit.py``.

Parity with the reference's hand-written loop (``imagenet_pytorch_horovod
.py:204-239``: ``train()`` iterating the loader with zero_grad/forward/
backward/step, ``validate()``), minus what the engine makes unnecessary:
no ``.cuda(non_blocking=True)`` (prefetch stages to the card), no
``DistributedOptimizer`` (the all-reduce is inside the step), no
``set_epoch`` on a sampler (datasets take the epoch index directly).

Usage::

    pieces, state = explicit.setup(model, config)
    for epoch in range(config.epochs):
        state = explicit.train_epoch(pieces, state, dataset, epoch)
        metrics = explicit.validate(pieces, state, val_dataset)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.pipeline import prefetch_to_device
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.training.optimizer import create_optimizer
from distributeddeeplearning_tpu_torch.training.schedules import Schedule
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.utils import hostsync
from distributeddeeplearning_tpu_torch.utils.logging import get_logger
from distributeddeeplearning_tpu_torch.utils.timer import Timer


@dataclasses.dataclass
class Pieces:
    """The built artifacts the explicit loop drives."""

    model: object
    config: TrainConfig
    device: torch.device
    tx: object
    train_step: Callable
    eval_step: Callable
    lr_schedule: Schedule
    process_group: object = None


def setup(
    model,
    config: TrainConfig,
    *,
    device=None,
    process_group=None,
    steps_per_epoch: Optional[int] = None,
) -> Tuple[Pieces, TrainState]:
    """Build the optimizer, the steps and the initial state on
    ``device`` (``None`` means CUDA) — the explicit analogue of
    reference ``main()`` setup (:267-338). ``config.engine`` selects the
    runtime exactly as in ``loop.fit``: both route through
    ``training.engines.build_engine``, the one dispatch point."""
    from distributeddeeplearning_tpu_torch.training.engines import build_engine
    from distributeddeeplearning_tpu_torch.training.loop import resolve_engine

    _, dev = resolve_engine(config, device)
    spe = steps_per_epoch or config.steps_per_epoch()
    tx, schedule = create_optimizer(config, spe,
                                    world_size=collectives.world_size(process_group))
    eng = build_engine(model, config, tx, device=dev, process_group=process_group)
    pieces = Pieces(model=eng.model, config=config, device=dev, tx=tx,
                    train_step=eng.train_step, eval_step=eng.eval_step,
                    lr_schedule=schedule, process_group=process_group)
    return pieces, eng.state


def train_epoch(
    pieces: Pieces,
    state: TrainState,
    data,
    epoch: int,
    log_every: Optional[int] = None,
) -> TrainState:
    """One epoch (reference ``train()`` :204-221, incl. its per-100-steps
    duration/loss logging, each a host read of the loss)."""
    log = get_logger()
    cfg = pieces.config
    log_every = log_every if log_every is not None else cfg.log_every_steps
    timer = Timer().start()
    for i, batch in enumerate(prefetch_to_device(data.epoch(epoch), pieces.device,
                                                 size=cfg.prefetch_batches)):
        state, metrics = pieces.train_step(state, batch)
        if log_every and (i + 1) % log_every == 0:
            loss = float(hostsync.device_get(metrics["loss"], label="explicit_log"))
            log.info("step %d loss=%.4f elapsed=%.2fs", i + 1, loss, timer.elapsed,
                     extra={"epoch": epoch})
    return state


def validate(pieces: Pieces, state: TrainState, data) -> Dict[str, float]:
    """Full-dataset eval (reference ``validate()`` :224-239)."""
    from distributeddeeplearning_tpu_torch.training.loop import _run_eval

    return _run_eval(pieces.eval_step, state, data, pieces.device, pieces.config)
