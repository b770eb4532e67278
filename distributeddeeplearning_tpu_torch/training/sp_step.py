"""Sequence-parallel LM training, DP × SP over a ``(data, seq)`` mesh:
the port of the JAX package's ``training/sp_step.py``.

Tokens ``[B, T]`` are sharded over both axes: each rank takes its data
shard's rows (the batch the loop stages for it) and the ``1/n_seq``
slice of their sequence that its ``seq`` index names. Every op but
attention is per token and runs on that slice; attention is ring
attention over the ``seq`` group (the model built with
``attn_impl="ring"``, ``seq_axis="seq"``: ``parallel/ring_attention``),
with positions and the causal mask in global coordinates. The loss is
each rank's mean over its tokens; gradients (through
``training/overlap.GradReducer``) and metrics are averaged over
``(data, seq)``, which with equal shards is the gradient of the global
per-token mean. Dropout draws per ``(data, seq)`` rank. The eval step
sums the weighted metric sums over both axes, each sample's weight on
each of its sequence shards' tokens.

The refusals are JAX's (``:60-82, 127-151, 283-287``): a model without
``seq_axis="seq"`` or not ``attn_impl="ring"``, and a global sequence
longer than ``max_seq_len``.
"""

from __future__ import annotations

import contextlib

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.parallel.mesh import Mesh
from distributeddeeplearning_tpu_torch.parallel.ring_attention import ring_axis
from distributeddeeplearning_tpu_torch.training import accum
from distributeddeeplearning_tpu_torch.training.pjit_step import (
    MeshLayout,
    make_mesh_eval_step,
    make_mesh_train_step,
)

DATA_AXIS, SEQ_AXIS = "data", "seq"


def _check_model(model, seq_axis: str, what: str) -> None:
    if getattr(model, "seq_axis", None) != seq_axis:
        raise ValueError(
            f"model.seq_axis={getattr(model, 'seq_axis', None)!r} must equal the step's "
            f"seq_axis={seq_axis!r} (build the model with seq_axis=... and attn_impl='ring')")
    if getattr(model, "attn_impl", None) != "ring":
        raise ValueError(
            f"model.attn_impl={getattr(model, 'attn_impl', None)!r}: sequence-parallel {what} "
            "requires attn_impl='ring'")


def _slicer(model, mesh: Mesh, seq_axis: str):
    n, i = mesh.shape.get(seq_axis, 1), mesh.coords.get(seq_axis, 0)

    def slice_batch(tensors):
        tokens, labels = tensors[0], tensors[1]
        t = tokens.shape[1]
        if t % n:
            raise ValueError(f"sequence {t} does not split over {n} seq shards")
        if t > model.max_seq_len:
            raise ValueError(f"global sequence {t} ({t // n} a shard x {n} shards) exceeds "
                             f"model.max_seq_len {model.max_seq_len}")
        w = t // n
        out = (tokens[:, i * w:(i + 1) * w], labels[:, i * w:(i + 1) * w])
        return out + tuple(tensors[2:])

    return slice_batch


def _ctx(mesh: Mesh, seq_axis: str):
    group = mesh.group(seq_axis)

    @contextlib.contextmanager
    def ctx():
        with ring_axis(group):
            yield

    return ctx


def make_sp_train_step(model, tx, mesh: Mesh, config: TrainConfig, layout: MeshLayout, *,
                       device, data_axis: str = DATA_AXIS, seq_axis: str = SEQ_AXIS):
    """The DP × SP train step (module docstring); ``layout`` replicated."""
    _check_model(model, seq_axis, "training")
    axes = (data_axis, seq_axis)
    accum.validate_accum_config(config, mesh.axis_size(data_axis))
    return make_mesh_train_step(model, tx, config, layout, device=device,
                                data_group=mesh.group(axes), n_data=mesh.axis_size(axes),
                                dropout_rank=mesh.axis_index(axes),
                                forward_ctx=_ctx(mesh, seq_axis),
                                slice_batch=_slicer(model, mesh, seq_axis))


def make_sp_eval_step(model, mesh: Mesh, *, device, data_axis: str = DATA_AXIS,
                      seq_axis: str = SEQ_AXIS):
    """Eval with the engines' exact-coverage weighted metrics, summed
    over ``(data, seq)``."""
    _check_model(model, seq_axis, "eval")
    return make_mesh_eval_step(model, device=device, sum_group=mesh.group((data_axis, seq_axis)),
                               forward_ctx=_ctx(mesh, seq_axis),
                               slice_batch=_slicer(model, mesh, seq_axis),
                               batch_group=mesh.group(data_axis))
