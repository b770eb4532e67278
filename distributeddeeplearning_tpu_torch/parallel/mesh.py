"""The rank mesh: the port of the JAX package's ``parallel/mesh.py``.

JAX lays its devices out in a ``jax.sharding.Mesh``; the port runs one
process per rank under ``torch.distributed`` and lays the world's ranks
out the same way: ``np.arange(world).reshape(shape)``, row-major in
rank order, as JAX reshapes ``jax.devices()`` (``:94-96``). Each axis
(and each set of axes a step reduces over) gets one process group per
line of the mesh, made on every rank in the same order (``new_group``
is collective); a rank keeps the groups it belongs to. A world of one
process (or no process group) is a mesh of size 1 with no groups.

Axes, outer to inner: ``replica`` (the slow links between nodes),
``data`` (batch), ``model`` (tensor parallel), ``seq`` (ring attention),
``expert`` (MoE experts, ``training/pjit_step.py``), ``pipe`` (pipeline
stages). Only ``replica`` × ``data`` shard the batch (:func:`batch_axes`,
JAX's): ranks along ``model`` and ``expert`` hold the same rows.
:func:`mesh_from_config` reads ``MESH_AXES``/``MESH_SHAPE`` with one
``-1`` wildcard; a leading ``replica`` axis builds the hybrid mesh,
whose slice count JAX reads from ``Device.slice_index`` and the port
from the node count: the world over ``LOCAL_WORLD_SIZE`` (ranks a
node), when the launcher exports it.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.parallel import collectives

REPLICA_AXIS = "replica"
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
CANONICAL_AXES = (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS, PIPE_AXIS)
BATCH_AXES = (REPLICA_AXIS, DATA_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh spec; ``shape[i] == -1`` means "all remaining"."""

    axes: Tuple[str, ...] = (DATA_AXIS,)
    shape: Tuple[int, ...] = (-1,)

    def resolve_shape(self, n_devices: int) -> Tuple[int, ...]:
        shape = list(self.shape)
        if len(shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} vs shape {self.shape} length mismatch")
        fixed = math.prod(s for s in shape if s != -1)
        n_wild = shape.count(-1)
        if n_wild > 1:
            raise ValueError("at most one -1 wildcard in mesh shape")
        if n_wild == 1:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            shape[shape.index(-1)] = n_devices // fixed
        if math.prod(shape) != n_devices:
            raise ValueError(f"mesh shape {tuple(shape)} does not cover {n_devices} devices")
        return tuple(shape)


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The world's ranks laid out on named axes, with this rank's
    coordinates and a process group for every subset of the axes of
    size > 1 (:meth:`group`).

    ``devices`` is the ``[*shape]`` array of global ranks (JAX's
    ``mesh.devices``); ``shape`` maps axis to size, ``axis_names`` the
    order; ``coords`` this rank's index on each axis."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 rank: Optional[int] = None) -> None:
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.shape} ranks vs axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        world, me = _world()
        self.rank = me if rank is None else rank
        if self.devices.size != world:
            raise ValueError(f"mesh of {self.devices.size} ranks over a world of {world}")
        where = np.argwhere(self.devices == self.rank)
        self.coords: Dict[str, int] = dict(zip(self.axis_names, map(int, where[0])))
        self._groups: Dict[Tuple[str, ...], object] = {}
        if world > 1:
            self._make_groups()

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _make_groups(self) -> None:
        """One group per mesh line of every axis subset that spans more
        than one rank, created on every rank in one order."""
        live = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                idx = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(self.axis_names)) if i not in idx]
                moved = np.moveaxis(self.devices, idx + rest, list(range(len(idx) + len(rest))))
                lines = moved.reshape(math.prod(self.shape[a] for a in axes), -1)
                for j in range(lines.shape[1]):
                    members = sorted(int(r) for r in lines[:, j])
                    g = dist.new_group(members)
                    if self.rank in members:
                        self._groups[axes] = g

    def group(self, axes) -> Optional[object]:
        """The process group of this rank's line over ``axes`` (one name
        or a tuple; absent and size-1 axes drop out), or ``None`` when
        that line is this rank alone."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        live = tuple(a for a in self.axis_names if a in axes and self.shape[a] > 1)
        if not live:
            return None
        return self._groups[live]

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (JAX's
        ``flat_axis_index``: absent axes count as size 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx

    def peer(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along ``axis`` (cyclic)."""
        where = [self.coords[a] for a in self.axis_names]
        i = self.axis_names.index(axis)
        where[i] = (where[i] + offset) % self.shape[axis]
        return int(self.devices[tuple(where)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def create_mesh(config: Optional[MeshConfig] = None, *, axes: Optional[Sequence[str]] = None,
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """A named mesh over the whole world in rank order; no arguments is
    every rank on ``data`` (the reference's sync-DP world)."""
    if config is None:
        resolved_axes = tuple(axes) if axes is not None else (DATA_AXIS,)
        if shape is not None:
            resolved_shape = tuple(shape)
        else:
            # axes only: every rank on the LAST axis, the others of size 1
            resolved_shape = (1,) * (len(resolved_axes) - 1) + (-1,)
        config = MeshConfig(axes=resolved_axes, shape=resolved_shape)
    world, _ = _world()
    resolved = config.resolve_shape(world)
    return Mesh(np.arange(world).reshape(resolved), config.axes)


def create_hybrid_mesh(num_slices: int, *, axes: Sequence[str] = (DATA_AXIS,),
                       shape: Optional[Sequence[int]] = None) -> Mesh:
    """Multi-node mesh: ``replica`` outermost (one slice a node group,
    ranks contiguous in rank order, as the launcher numbers them node by
    node) × the inner axes."""
    world, _ = _world()
    if num_slices <= 0 or world % num_slices:
        raise ValueError(f"{world} devices do not split into {num_slices} slices")
    per_slice = world // num_slices
    inner_axes = tuple(axes)
    if REPLICA_AXIS in inner_axes:
        raise ValueError("'replica' is implicit (outermost); pass inner axes only")
    if shape is not None:
        inner_shape = tuple(shape)
    elif inner_axes:
        inner_shape = (1,) * (len(inner_axes) - 1) + (-1,)
    else:
        inner_shape = ()
    resolved = MeshConfig(axes=inner_axes, shape=inner_shape).resolve_shape(per_slice)
    return Mesh(np.arange(world).reshape((num_slices,) + resolved), (REPLICA_AXIS,) + inner_axes)


def mesh_from_config(config) -> Mesh:
    """The mesh a ``TrainConfig`` describes: ``mesh_axes`` ×
    ``mesh_shape`` when set, axes only otherwise (every rank on the last
    axis), else every rank on ``data``; a leading ``replica`` builds
    the hybrid mesh (JAX's rules, the slice count from the nodes)."""
    axes = tuple(config.mesh_axes)
    if axes[:1] == (REPLICA_AXIS,):
        inner_axes = axes[1:]
        if config.mesh_shape is not None:
            if len(config.mesh_shape) != len(axes):
                raise ValueError(f"MESH_SHAPE {config.mesh_shape} and MESH_AXES {axes} must "
                                 "have the same length")
            num_slices, inner_shape = config.mesh_shape[0], config.mesh_shape[1:]
        else:
            world, _ = _world()
            if inner_axes and "LOCAL_WORLD_SIZE" in os.environ:
                num_slices = world // collectives.local_size()
            elif inner_axes:
                raise ValueError(
                    f"MESH_AXES={','.join(axes)} without MESH_SHAPE: no LOCAL_WORLD_SIZE "
                    "tells the ranks a node, so the slice count cannot be derived — set "
                    "MESH_SHAPE=<slices>,<per-slice …> explicitly")
            else:
                num_slices = world
            inner_shape = None
        return create_hybrid_mesh(num_slices, axes=inner_axes, shape=inner_shape)
    if config.mesh_shape is not None:
        if len(config.mesh_shape) != len(axes):
            raise ValueError(f"MESH_SHAPE {config.mesh_shape} and MESH_AXES {axes} must have "
                             "the same length")
        return create_mesh(axes=axes, shape=config.mesh_shape)
    return create_mesh(axes=axes)


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh's batch-sharding axes (``replica`` × ``data``)."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def batch_sharding(mesh: Mesh) -> Tuple[int, int]:
    """Where this rank's rows of a global batch come from: ``(shard,
    shards)``, the leading dim split over every batch axis (JAX's
    ``P(("replica", "data"))``); other axes take the same rows."""
    axes = batch_axes(mesh)
    return mesh.axis_index(axes), mesh.axis_size(axes)


def dp_size(mesh: Mesh) -> int:
    return mesh.axis_size(batch_axes(mesh))
