"""Host-side collectives of the port: the two helpers of the JAX
package's ``parallel/collectives.py`` that the callbacks use
(``is_master`` :66, ``allreduce_host_scalar`` :171), over
``torch.distributed`` (one process per GPU). Without an initialised
process group the process is its own world of one."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if _world() else 0


def size() -> int:
    """The default group's size (1 without one)."""
    return dist.get_world_size() if _world() else 1


def world_size(process_group=None) -> int:
    """The size of ``process_group`` (default: the world when a process
    group is initialised, else 1): the data-parallel width."""
    if process_group is None:
        return size()
    return dist.get_world_size(process_group)


def is_master(r: Optional[int] = None) -> bool:
    """The reference's ``_is_master``: rank 0."""
    return (rank() if r is None else r) == 0


def allreduce_host_scalar(value: float, average: bool = True) -> float:
    """Average (or sum) a Python scalar across the processes: a float64
    all-reduce on the backend's device (the CUDA device for NCCL),
    boundary work, never per step."""
    if size() == 1:
        return float(value)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    total = float(t.cpu()[0])
    return total / size() if average else total


def barrier() -> None:
    """Wait for every process of the default group (a no-op alone)."""
    if size() > 1:
        dist.barrier()
