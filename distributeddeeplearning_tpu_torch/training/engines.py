"""Engine construction, the one dispatch point for dp / pjit / pp / sp:
the port of the JAX package's ``training/engines.py`` (``Engine``
:46-68, ``adapt_model`` :76-134, ``build_engine`` :148-248,
``build_eval_step`` :251).

The same script runs data parallel, tensor/FSDP parallel, pipeline
parallel or sequence parallel purely through ``ENGINE`` and ``MESH_*``:
every front-end builds its state and steps here.

============ ========================= ======================= ==============
engine       state                     steps                   batch a rank
============ ========================= ======================= ==============
``dp``       replicated                ``train_step.make_*``   its rank's rows
``pjit``     laid out by the rules     ``pjit_step.make_*``    its data shard
``pp``       a stage a ``pipe`` rank   ``pp_step.make_*``      its data shard
``sp``       replicated                ``sp_step.make_*``      its data shard,
                                                               its seq slice
============ ========================= ======================= ==============

One process per rank (``torch.distributed``: NCCL with one card a rank,
gloo on the CPU or for ranks sharing a card). The mesh engines lay the
world out on ``MESH_AXES``/``MESH_SHAPE`` (``parallel/mesh.py``;
:func:`resolve_mesh` picks the engines' defaults: ``pp`` puts
``PP_STAGES`` ranks on ``pipe``, ``sp`` every rank on ``seq``). ``pp``
and ``sp`` adapt the model the front-end built: a dense
``TransformerLM`` becomes this rank's stage of a ``PipelineLM`` (its
depth rounded up to equal stages) or runs with ``attn_impl="ring"`` and
``seq_axis="seq"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    create_mesh,
    dp_size,
    mesh_from_config,
)
from distributeddeeplearning_tpu_torch.training.accum import validate_accum_config
from distributeddeeplearning_tpu_torch.training.state import TrainState, create_train_state
from distributeddeeplearning_tpu_torch.training.train_step import (
    make_eval_step,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.utils.device import resolve_device
from distributeddeeplearning_tpu_torch.utils.logging import get_logger

SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
ENGINES = ("dp", "pjit", "pp", "sp")


def check_engine(engine: str) -> None:
    """Raise for an engine the port does not know."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (have {', '.join(ENGINES)})")


@dataclasses.dataclass
class Engine:
    """What one engine choice implies: the device, the mesh (``None``
    for dp), the engine's model, the state and the two steps."""

    name: str
    device: torch.device
    model: Any
    state: TrainState
    train_step: Callable
    eval_step: Callable
    process_group: Any = None
    mesh: Optional[Mesh] = None

    def batch_shard(self) -> Tuple[int, int]:
        """``(index, count)``: which rows of each global batch this rank
        takes (its data shard; other axes take the same rows)."""
        if self.mesh is None:
            return collectives.rank(), collectives.world_size(self.process_group)
        return batch_sharding(self.mesh)

    def warmup(self, batch, *, acc=None, eval_batch=None):
        """Capture the steps against ``batch``'s signature before the
        data flows (``AOT_WARMUP``, the dp engine): CUDA graphs installed
        on the steps, the capture seconds, the warm-up step's FLOPs and
        the library cache's hit/miss delta. See ``training/warmup.py``."""
        from distributeddeeplearning_tpu_torch.training.warmup import warmup_engine

        return warmup_engine(self, batch, acc=acc, eval_batch=eval_batch)


def resolve_mesh(config: TrainConfig, mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The mesh of a mesh engine (``None`` for dp): ``mesh`` if given,
    else the config's, else the engine's default, with JAX's checks
    (``loop.resolve_engine``)."""
    if config.engine == "dp":
        return None
    if mesh is None:
        unset = config.mesh_shape is None and tuple(config.mesh_axes) == ("data",)
        if config.engine == "pp" and unset:
            stages = config.pp_stages or collectives.size()
            mesh = create_mesh(axes=("data", PIPE_AXIS), shape=(-1, stages))
        elif config.engine == "sp" and unset:
            mesh = create_mesh(axes=("data", SEQ_AXIS), shape=(1, -1))
        else:
            mesh = mesh_from_config(config)
    if config.engine == "pp":
        if PIPE_AXIS not in mesh.axis_names:
            raise ValueError(f"ENGINE=pp needs a 'pipe' mesh axis; got {mesh.axis_names} "
                             "(set MESH_AXES=data,pipe MESH_SHAPE=<dp>,<stages>)")
        if config.pp_stages and mesh.shape[PIPE_AXIS] != config.pp_stages:
            raise ValueError(f"PP_STAGES={config.pp_stages} != mesh pipe axis "
                             f"{mesh.shape[PIPE_AXIS]}")
    if config.engine == "sp" and SEQ_AXIS not in mesh.axis_names:
        raise ValueError(f"ENGINE=sp needs a 'seq' mesh axis; got {mesh.axis_names} "
                         "(set MESH_AXES=data,seq MESH_SHAPE=<dp>,<sp>)")
    return mesh


def adapt_model(model, engine: str, mesh: Optional[Mesh], config: TrainConfig, device=None):
    """The model the engine runs (module docstring)."""
    from distributeddeeplearning_tpu_torch.models.pipeline_lm import PipelineLM
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.models.vit import Attention

    if engine == "sp":
        if not isinstance(model, TransformerLM):
            raise ValueError(f"ENGINE=sp needs a sequence model with attn_impl/seq_axis "
                             f"fields (the LM family); got {type(model).__name__}")
        model.attn_impl, model.seq_axis = "ring", SEQ_AXIS
        for m in model.modules():
            if isinstance(m, Attention):
                m.attn_impl = "ring"
        return model
    if engine == "pp":
        if isinstance(model, PipelineLM):
            return model
        if not isinstance(model, TransformerLM):
            raise ValueError(f"ENGINE=pp supports the LM family (TransformerLM or a pre-built "
                             f"PipelineLM); got {type(model).__name__}")
        if model.moe_experts:
            raise ValueError("ENGINE=pp supports the dense LM family; routed (MoE) FFNs are "
                             "not stage-partitioned — use ENGINE=pjit with an 'expert' mesh "
                             "axis for expert parallelism")
        stages = mesh.shape[PIPE_AXIS]
        depth = model.depth
        n_layers = -(-depth // stages) * stages  # round up to equal stages
        if n_layers != depth:
            get_logger().warning(
                "ENGINE=pp: %s depth %d is not divisible by %d stages — building %d layers "
                "(a deeper model than the dense %s; not comparable to its baseline)",
                model.variant, depth, stages, n_layers, model.variant)
        dev = device if device is not None else model.tok_embed.device
        return PipelineLM(variant=model.variant, vocab_size=model.vocab_size,
                          max_seq_len=model.max_seq_len, num_stages=stages, n_layers=n_layers,
                          dtype=model.dtype,
                          # ring is the sp impl; inside a stage plain attention applies
                          attn_impl="xla" if model.attn_impl == "ring" else model.attn_impl,
                          dropout=model.dropout, remat=model.remat,
                          stage=mesh.coords[PIPE_AXIS], device=dev)
    return model


def build_engine(model, config: TrainConfig, tx, *, state: Optional[TrainState] = None,
                 device=None, process_group=None, mesh: Optional[Mesh] = None) -> Engine:
    """Build (state, train_step, eval_step) for ``config.engine`` on
    ``device`` (``None`` means CUDA, and raises without it). A given
    ``state`` is used as it is, not re-initialised. The mesh engines run
    over ``mesh`` (default: :func:`resolve_mesh`)."""
    check_engine(config.engine)
    dev = resolve_device(device)
    engine = config.engine
    if engine == "dp":
        validate_accum_config(config, collectives.world_size(process_group))
        if state is None:
            state = create_train_state(model, config, tx, device=dev)
        return Engine(
            name=engine, device=dev, model=model, state=state,
            train_step=make_train_step(model, tx, config, process_group=process_group,
                                       device=dev),
            eval_step=make_eval_step(model, process_group=process_group, device=dev),
            process_group=process_group)

    mesh = resolve_mesh(config, mesh)
    validate_accum_config(config, dp_size(mesh))
    model = adapt_model(model, engine, mesh, config, dev)
    if engine == "pjit":
        from distributeddeeplearning_tpu_torch.training import pjit_step

        if state is None:
            state = pjit_step.build_pjit_state(model, config, tx, mesh, device=dev)
        return Engine(name=engine, device=dev, model=model, state=state,
                      train_step=pjit_step.make_pjit_train_step(model, tx, mesh, config,
                                                                state.layout, device=dev),
                      eval_step=pjit_step.make_pjit_eval_step(model, mesh, config, device=dev),
                      mesh=mesh)
    if engine == "pp":
        from distributeddeeplearning_tpu_torch.training import pp_step

        if state is None:
            state = pp_step.create_pp_state(model, config, tx, mesh, device=dev)
        return Engine(name=engine, device=dev, model=model, state=state,
                      train_step=pp_step.make_pp_train_step(
                          model, tx, mesh, config, state.layout, device=dev,
                          num_microbatches=config.pp_microbatches,
                          schedule=config.pp_schedule),
                      eval_step=pp_step.make_pp_eval_step(model, mesh, device=dev), mesh=mesh)
    from distributeddeeplearning_tpu_torch.training import pjit_step, sp_step

    if state is None:
        state = create_train_state(model, config, tx, device=dev)
    if state.layout is None:
        state.layout = pjit_step.layout_model(model, mesh, "dp")
    return Engine(name=engine, device=dev, model=model, state=state,
                  train_step=sp_step.make_sp_train_step(model, tx, mesh, config, state.layout,
                                                        device=dev),
                  eval_step=sp_step.make_sp_eval_step(model, mesh, device=dev), mesh=mesh)


def build_eval_step(model, config: TrainConfig, *, device=None, process_group=None,
                    mesh: Optional[Mesh] = None):
    """Eval-only dispatch (``loop.evaluate`` with an existing state):
    ``(model, eval_step)``, the model the engine runs."""
    check_engine(config.engine)
    dev = resolve_device(device)
    if config.engine == "dp":
        return model, make_eval_step(model, process_group=process_group, device=dev)
    mesh = resolve_mesh(config, mesh)
    model = adapt_model(model, config.engine, mesh, config, dev)
    if config.engine == "pjit":
        from distributeddeeplearning_tpu_torch.training.pjit_step import make_pjit_eval_step

        return model, make_pjit_eval_step(model, mesh, config, device=dev)
    if config.engine == "pp":
        from distributeddeeplearning_tpu_torch.training.pp_step import make_pp_eval_step

        return model, make_pp_eval_step(model, mesh, device=dev)
    from distributeddeeplearning_tpu_torch.training.sp_step import make_sp_eval_step

    return model, make_sp_eval_step(model, mesh, device=dev)
