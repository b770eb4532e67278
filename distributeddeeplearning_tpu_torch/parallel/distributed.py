"""Multi-process initialization, the ``hvd.init()`` / mpirun-rendezvous
equivalent: the port of the JAX package's ``parallel/distributed.py``
on ``torch.distributed`` (one process per GPU).

Env contract (set by a launcher), the JAX package's:
  ``DDL_COORDINATOR`` — ``host:port`` of process 0 (the TCP store)
  ``DDL_NUM_PROCESSES`` / ``DDL_PROCESS_ID``
  ``DDL_PLATFORM`` — ``cpu`` forms a gloo world on the CPU; anything
  else (the default) an NCCL world, each process pinned to its card
  (``LOCAL_RANK`` when set, else the process id modulo the cards).
Without ``DDL_*``, ``DISTRIBUTED=True`` (the reference's own flag) asks
for torch's ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them): the counterpart of
JAX's TPU-metadata autodetect. :func:`default_device` is the device
the examples train on: the CPU under ``DDL_PLATFORM=cpu``, else the card.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.utils.logging import get_logger

_initialized = False
_ENV_RENDEZVOUS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _truthy(value: Optional[str]) -> bool:
    return (value or "").strip().lower() in {"1", "true", "t", "yes"}


def maybe_initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialise the process group if configured; a no-op for one
    process. Returns True if a process group is up (this call or an
    earlier one formed it). Safe to call more than once (like
    ``hvd.init()``)."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        return True
    log = get_logger()

    coordinator_address = coordinator_address or os.environ.get("DDL_COORDINATOR")
    if num_processes is None and "DDL_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DDL_NUM_PROCESSES"])
    if process_id is None and "DDL_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DDL_PROCESS_ID"])
    platform = os.environ.get("DDL_PLATFORM", "")

    explicit = coordinator_address is not None
    from_env = (_truthy(os.environ.get("DISTRIBUTED"))
                and all(k in os.environ for k in _ENV_RENDEZVOUS))
    if not explicit and not from_env:
        return False

    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("DDL_COORDINATOR needs DDL_NUM_PROCESSES and DDL_PROCESS_ID")
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
        rank = process_id
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    if platform == "cpu":
        backend = "gloo"
    else:
        # The card's world: NCCL, each process on its own card. Without
        # CUDA this raises (no quiet move to the CPU).
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: an NCCL world needs the card; set "
                               "DDL_PLATFORM=cpu for a gloo world on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        backend = "nccl"
    dist.init_process_group(backend=backend, **kwargs)
    _initialized = True
    log.info("distributed initialized: process %d/%d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)
    return True


def default_device() -> torch.device:
    """The device this process trains on: the CPU when the launcher
    asked for it (``DDL_PLATFORM=cpu``), else its card (the one
    :func:`maybe_initialize` pinned); without CUDA that raises."""
    from distributeddeeplearning_tpu_torch.utils.device import resolve_device

    if os.environ.get("DDL_PLATFORM") == "cpu":
        return torch.device("cpu")
    return resolve_device("cuda")


def shutdown() -> None:
    """Tear the process group down, if this module formed it."""
    global _initialized
    if _initialized:
        if dist.is_initialized():
            dist.destroy_process_group()
        _initialized = False
