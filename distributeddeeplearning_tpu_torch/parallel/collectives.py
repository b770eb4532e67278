"""Collectives of the port: the JAX package's ``parallel/collectives.py``
over ``torch.distributed`` (one process per rank).

* Topology (Horovod's nouns): :func:`rank`, :func:`size`,
  :func:`local_rank`, :func:`local_size`, :func:`num_processes`,
  :func:`is_master`.
* In-step collectives over a process group (a mesh axis's,
  ``parallel/mesh.Mesh.group``; ``None`` is a group of one and every
  call is the identity): :func:`all_reduce`, :func:`all_gather`,
  :func:`reduce_scatter`, :func:`exchange` (point to
  point, the counterpart of ``lax.ppermute``), and the Horovod ops on
  them, :func:`allreduce_gradients`, :func:`allreduce_metrics`,
  :func:`allreduce_sum`, :func:`hierarchical_allreduce_gradients`.
* Autograd-aware sums: :func:`psum_keepgrad` (JAX's ``psum`` whose
  transpose is the broadcast: forward sum, backward identity; the
  row-parallel output of tensor parallelism), :func:`copy_to_group`
  (forward identity, backward sum: the column-parallel input),
  :func:`sum_both_ways` (forward and backward sums: sync BatchNorm's
  batch sums) and :func:`all_gather_keepgrad` (forward gather, backward
  this rank's slice: a sharded weight read whole by every rank, as the
  expert-parallel router is).
* Host-level: :func:`broadcast_from_master`, :func:`allreduce_host_scalar`,
  :func:`barrier`.

A gloo group holding CUDA tensors (ranks that share one card) takes
them as they are in its collectives; its point to point stages through
pinned host buffers (:func:`exchange`: a gloo send of a CUDA tensor
aborts the process). Without an initialised process group the process
is its own world of one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def num_processes() -> int:
    return size()


def local_size() -> int:
    """Ranks on this node (``LOCAL_WORLD_SIZE``, else the world)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", size()))


def local_rank() -> int:
    """This rank's index on its node (``LOCAL_RANK``, else the rank
    modulo :func:`local_size`)."""
    return int(os.environ.get("LOCAL_RANK", rank() % max(local_size(), 1)))


def world_size(process_group=None) -> int:
    """The size of ``process_group`` (default: the world when a process
    group is initialised, else 1): the data-parallel width."""
    if process_group is None:
        return size()
    return dist.get_world_size(process_group)


def group_size(group) -> int:
    """The size of a mesh group (``None`` is a group of one)."""
    return 1 if group is None else dist.get_world_size(group)


def is_master(r: Optional[int] = None) -> bool:
    """The reference's ``_is_master``: rank 0."""
    return (rank() if r is None else r) == 0


# ---------------------------------------------------------------------------
# In-step collectives
# ---------------------------------------------------------------------------

@torch.no_grad()
def all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """In place sum (or ``op``) of ``t`` over ``group``; returns ``t``."""
    if group is None:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


@torch.no_grad()
def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's shards of ``t`` concatenated along ``dim``, in group
    rank order (JAX's ``all_gather(..., tiled=True)``)."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    full = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                       device=src.device)
    dist.all_gather_into_tensor(full, src, group=group)
    return full.movedim(0, dim)


@torch.no_grad()
def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the group's sum of ``t``."""
    n = group_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {n} ranks")
    part = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                       device=src.device)
    dist.reduce_scatter_tensor(part, src, group=group)
    return part.movedim(0, dim)


# gloo point to point of CUDA tensors: cached pinned host buffers
_PINNED: Dict[Tuple, torch.Tensor] = {}


def _host(shape, dtype, slot) -> torch.Tensor:
    """A cached pinned host buffer of ``shape``/``dtype`` (one a slot)."""
    key = (tuple(shape), dtype, slot)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(shape, dtype=dtype, pin_memory=True)
    return buf


def _to_host(t: torch.Tensor, slot) -> torch.Tensor:
    buf = _host(t.shape, t.dtype, slot)
    buf.copy_(t)
    return buf


@torch.no_grad()
def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Point to point, all at once (``lax.ppermute``'s counterpart):
    each ``(tensor, peer)`` of ``sends`` goes to global rank ``peer``;
    each ``(buffer, peer)`` of ``recvs`` is filled from ``peer``, in
    place. NCCL batches them (``batch_isend_irecv``); gloo on CUDA
    tensors stages each through a pinned host buffer."""
    if not sends and not recvs:
        return
    if dist.get_backend() == "nccl":
        ops = [dist.P2POp(dist.isend, t.contiguous(), peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, buf, peer) for buf, peer in recvs]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return
    staged = any(t.is_cuda for t, _ in list(sends) + list(recvs))
    works, landing = [], []
    for i, (t, peer) in enumerate(sends):
        src = _to_host(t.contiguous(), ("send", i)) if staged else t.contiguous()
        works.append(dist.isend(src, peer))
    for i, (buf, peer) in enumerate(recvs):
        dst = _host(buf.shape, buf.dtype, ("recv", i)) if staged else buf
        works.append(dist.irecv(dst, peer))
        landing.append((buf, dst))
    for w in works:
        w.wait()
    for buf, dst in landing:
        if dst is not buf:
            buf.copy_(dst)


# ---------------------------------------------------------------------------
# Autograd-aware sums
# ---------------------------------------------------------------------------

class _PsumKeepgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _SumBothWays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _AllGatherKeepgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def psum_keepgrad(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` whose gradient passes through unchanged (JAX's
    ``psum_keepgrad``: the transpose of a psum inside the loss is the
    broadcast)."""
    return x if group is None else _PsumKeepgrad.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` (the input of a
    column-parallel matmul: every rank's partial input gradient adds)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def all_gather_keepgrad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's shards of ``x`` concatenated along ``dim``, whose
    gradient is this rank's slice of the whole one (every rank computes
    the same whole gradient, so no sum: the transpose of a gather whose
    result every rank uses alike)."""
    return x if group is None else _AllGatherKeepgrad.apply(x, group, dim)


def sum_both_ways(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in the forward and of the gradients in the
    backward (sync BatchNorm's batch sums: every rank's loss depends on
    every rank's rows)."""
    return x if group is None else _SumBothWays.apply(x, group)


# ---------------------------------------------------------------------------
# The Horovod ops
# ---------------------------------------------------------------------------

def _flat_mean(tensors: List[torch.Tensor], group, mean: bool) -> List[torch.Tensor]:
    n = group_size(group)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce(flat, group)
    if mean:
        flat /= n
    pieces = torch.split(flat, [t.numel() for t in tensors])
    return [p.view_as(t).to(t.dtype) for p, t in zip(pieces, tensors)]


def allreduce_gradients(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Mean of a gradient list over ``group`` (one flat f32 all-reduce:
    ``lax.pmean``)."""
    return _flat_mean(grads, group, mean=True)


def allreduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Mean of the metric scalars over ``group``."""
    keys = list(metrics)
    vals = _flat_mean([metrics[k].reshape(1) for k in keys], group, mean=True)
    return {k: v[0] for k, v in zip(keys, vals)}


def allreduce_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    return _flat_mean(tensors, group, mean=False)


def hierarchical_allreduce_gradients(grads: List[torch.Tensor], ici_group,
                                     dcn_group) -> List[torch.Tensor]:
    """Mean within the node first, then across nodes: the same numbers
    as one mean over both (equal groups), the slow links carrying the
    reduced tensor only."""
    return allreduce_gradients(allreduce_gradients(grads, ici_group), dcn_group)


# ---------------------------------------------------------------------------
# Host-level collectives
# ---------------------------------------------------------------------------

def _comm_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def broadcast_from_master(tree: Any) -> Any:
    """A picklable host tree from rank 0 to every rank
    (``hvd.broadcast_parameters``); one process: the identity."""
    if size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def allreduce_host_scalar(value: float, average: bool = True) -> float:
    """Average (or sum) a Python scalar across the processes: a float64
    all-reduce on the backend's device (the CUDA device for NCCL),
    boundary work, never per step."""
    if size() == 1:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    total = float(t.cpu()[0])
    return total / size() if average else total


def barrier(group=None) -> None:
    """Wait for every process of ``group`` (default: the world; a
    no-op alone)."""
    if size() > 1:
        dist.barrier(group=group)
