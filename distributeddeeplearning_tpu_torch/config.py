"""Typed training configuration: the port's twin of the JAX package's
``config.TrainConfig`` for the fields the data-parallel ResNet, LM, ViT
and EfficientNet training slices and the training loop read (``MODEL``
names any model of ``models.get_model``, ``efficientnet_b0`` …
``efficientnet_b7`` too): accumulation (``ACCUM_STEPS``,
``GRAD_ACCUM_STEPS``), validation, prefetch depth, the non-finite guard
and checkpointing (``MODEL_DIR``/``AZ_BATCHAI_OUTPUT_MODEL``,
``RESUME``, ``CHECKPOINT_*``), the warm-up (``AOT_WARMUP``: CUDA-graph
capture of the step, ``training/warmup.py``), the library cache
(``COMPILATION_CACHE_DIR``: built kernel libraries, ``ops/_build.py``),
``DISTRIBUTED`` (``parallel/distributed.py``) and the elastic-worlds
contract the launcher's supervisor exports (``ELASTIC``,
``LR_WORLD_SIZE``; ``launch.py``), and the real-data plane: ``FAKE``,
``DATA_DIR``/``AZ_BATCHAI_INPUT_TRAIN``, ``VAL_DATA_DIR``/
``AZ_BATCHAI_INPUT_TEST`` (the Batch AI spellings win), ``DATA_FORMAT``
(``data.make_dataset``: ``auto`` | ``stream`` | ``imagefolder`` |
``tfrecord`` | ``tfrecord-native``), ``NUM_WORKERS``, ``WORKER_MODE`` (or
the reference's ``MULTIPROCESSING``), ``STREAM_SHUFFLE_BLOCK`` and
``PREFETCH_HOST_BATCHES`` (``data/imagenet.py``, ``data/stream/``), and
the model and optimizer knobs: ``MOE_EXPERTS`` (``models/moe.py``),
``REMAT`` (gradient checkpointing of each block), ``OPTIMIZER=adamw``
with ``DECOUPLED_WEIGHT_DECAY`` (``training/optimizer.AdamW``), and the
mesh engines: ``ENGINE`` (``dp``, ``pjit``, ``pp``, ``sp``),
``MESH_AXES``/``MESH_SHAPE``, ``PP_STAGES``, ``PP_MICROBATCHES``,
``PP_SCHEDULE``, ``PARAM_SHARDING``, ``ALLOW_SYNC_BN``,
``ASYNC_COLLECTIVES`` and ``ATTN_IMPL=ring`` (``training/engines.py``).

Field names, defaults and ``from_env`` parsing are the JAX package's.
An ``expert`` mesh axis shards the MoE experts under ``ENGINE=pjit``
(``training/pjit_step.py``); an explicit ``MESH_SHAPE`` whose ``expert``
size does not divide ``MOE_EXPERTS`` raises ``ValueError``.
``AOT_WARMUP=1`` with a mesh engine raises ``NotImplementedError``
naming the slice that brings it. ``FUSED_DENSE_GRAD`` is no field in either
package: ``models/vit._dense`` reads it whenever a Dense is built, as the
JAX package's ``_dense`` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional, Tuple

import torch

# ImageNet preprocessing constants: the reference's per-channel means and
# the torchvision mean/sd pair (the JAX package's config.py:28-30).
IMAGENET_RGB_MEAN_255 = (123.68, 116.78, 103.94)
IMAGENET_RGB_MEAN = (0.485, 0.456, 0.406)
IMAGENET_RGB_SD = (0.229, 0.224, 0.225)
IMAGENET_TRAIN_LENGTH = 1_281_167  # FAKE_DATA_LENGTH default

# A setting of a later slice raises NotImplementedError naming the slice
# that brings it: a CUDA-graph warm-up of a mesh engine captures NCCL
# collectives.
_AOT_MESH_SLICE = "the slice that captures NCCL worlds' collectives as CUDA graphs"

_ATTN = ("xla", "pallas", "fused", "auto", "ring")


def check_expert_split(experts: int, n_expert: int) -> None:
    """Raise unless ``experts`` split evenly over an ``expert`` axis of
    ``n_expert`` ranks (``-1``, the wildcard, is checked on the mesh)."""
    if n_expert > 0 and experts % n_expert:
        raise ValueError(f"{experts} experts do not split over expert={n_expert} ranks: "
                         "MOE_EXPERTS must be a multiple of the mesh's 'expert' size")


def _str_to_bool(value: str) -> bool:
    """Strict boolean env parsing, as the JAX package's."""
    return value.strip().lower() in {"1", "true", "t", "yes", "y", "on"}


@dataclasses.dataclass
class TrainConfig:
    """What the data-parallel training slice reads, in one typed object."""

    # Model / task
    model: str = "resnet50"
    num_classes: int = 1000
    image_size: int = 224
    compute_dtype: str = "bfloat16"  # params and BN statistics stay float32
    # Host->device image staging: "auto" (the compute dtype) | "uint8"
    # (raw RGB bytes, normalised on the device) | "float32" | "bfloat16".
    input_staging: str = "auto"
    # Attention of the attention models (LM, ViT): "xla" plain masked
    # softmax | "pallas" the flash kernels (ops/flash.py) | "fused" the
    # packed-QKV kernels (ops/flash_packed.py) | "auto" fused where it
    # applies on the card, else xla.
    attn_impl: str = "xla"
    # Mixture-of-Experts width of the LM family (models/moe.py): None
    # keeps each model's own default (8 for lm_moe_*, dense for lm_*).
    moe_experts: Optional[int] = None
    # Gradient checkpointing of each block (ViT, LM): activations are
    # recomputed in the backward (torch.utils.checkpoint).
    remat: bool = False

    # Optimization: LR 0.001 x world size, momentum 0.9, L2 5e-5 on
    # kernels, 5-epoch warmup, x0.1 at 30/60/80.
    batch_size_per_device: int = 64
    base_lr: float = 0.001
    # "sgd" (the reference's) | "adamw" (decoupled decay on the kernels,
    # the betas below; pair it with weight_decay=0).
    optimizer: str = "sgd"
    momentum: float = 0.9
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    decoupled_weight_decay: float = 0.0
    grad_accum_steps: int = 1
    accum_steps: int = 1
    weight_decay: float = 5e-5
    label_smoothing: float = 0.0
    epochs: int = 1
    warmup_epochs: int = 5
    lr_schedule: str = "step"  # step | cosine | constant
    lr_decay_epochs: Tuple[int, ...] = (30, 60, 80)
    lr_decay_factor: float = 0.1
    lr_decay_factors: Optional[Tuple[float, ...]] = None
    scale_lr_by_world_size: bool = True

    # Data
    fake: bool = True
    fake_data_length: int = IMAGENET_TRAIN_LENGTH
    data_dir: Optional[str] = None
    val_data_dir: Optional[str] = None
    # Real-data pipeline (data.make_dataset): "auto" detects stream
    # shards (a stream_index.json in DATA_DIR) vs TFRecord shards vs an
    # ImageFolder tree; force with "stream" (data/stream/: the O(1)
    # checkpointable shuffle cursor) | "imagefolder" | "tfrecord"
    # (tf.data) | "tfrecord-native" (TF-free, the native/ tier).
    data_format: str = "auto"
    # Streamed shards' shuffle block (STREAM_SHUFFLE_BLOCK): records mix
    # globally at block granularity and exactly within blocks; >= the
    # record count is one exact global permutation.
    stream_shuffle_block: int = 256
    # Host read-ahead of assembled batches (PREFETCH_HOST_BATCHES; 0 =
    # off) for datasets that offer it (data/stream/prefetch.py, the
    # data.* gauges); prefetch_batches stages batches onto the device.
    prefetch_host_batches: int = 2
    num_workers: int = 4  # Keras NUM_WORKERS (:44-46): decode workers
    # "thread" | "process": the reference Keras MULTIPROCESSING knob.
    worker_mode: str = "thread"
    # "process": disjoint per-process streams; "global": one stream,
    # each process taking its contiguous share of every global batch.
    data_topology: str = "process"

    validation: bool = False
    prefetch_batches: int = 2

    # Distribution: DISTRIBUTED asks parallel/distributed.maybe_initialize
    # for torch's env:// rendezvous when no DDL_* variables are set.
    distributed: bool = False
    mesh_shape: Optional[Tuple[int, ...]] = None  # None -> all ranks on 'data'
    mesh_axes: Tuple[str, ...] = ("data",)
    # Training engine (training/engines.py): "dp" replicated data
    # parallel; "pjit" parameters laid out by the rules table
    # PARAM_SHARDING names over the mesh ("tp" Megatron over 'model',
    # "fsdp" ZeRO-3 over 'data', "dp" replicated); "pp" GPipe/1F1B over
    # a 'pipe' axis (LM); "sp" ring attention over a 'seq' axis (LM).
    engine: str = "dp"
    pp_stages: Optional[int] = None
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"
    param_sharding: str = "tp"
    # BatchNorm under ENGINE=pjit: per data shard by default (the dp
    # engine's statistics); ALLOW_SYNC_BN=1 all-reduces the batch sums
    # over the data axis (required by ResNet(fused=True)).
    allow_sync_bn: bool = False
    # ASYNC_COLLECTIVES: the mesh engines' gradient all-reduces go out
    # bucket by bucket during the backward (training/overlap.py); off,
    # one synchronous pass after it. The same bits either way.
    async_collectives: bool = True

    # Cheap-restart knobs: the directory built kernel libraries go to and
    # load from (COMPILATION_CACHE_DIR; None = the package's _build/), and
    # AOT warm-up (AOT_WARMUP): capture the train step as CUDA graphs on
    # the first staged batch (training/warmup.py).
    compilation_cache_dir: Optional[str] = None
    aot_warmup: bool = False

    # Bookkeeping
    seed: int = 42
    model_dir: Optional[str] = None  # AZ_BATCHAI_OUTPUT_MODEL equivalent
    checkpoint_every_epochs: int = 1
    # Step-granular checkpointing (CHECKPOINT_EVERY_STEPS; 0 = epoch
    # boundaries only): keys become global step counts and a resume
    # re-enters mid-epoch. Each due save copies the state to the host
    # (a deliberate host sync, booked as "checkpoint").
    checkpoint_every_steps: int = 0
    checkpoint_keep: int = 3
    # CHECKPOINT_ASYNC (default on): off makes every save durable
    # before it returns.
    checkpoint_async: bool = True
    resume: bool = True  # env RESUME (the supervisor re-asserts it)
    # Elastic worlds (ELASTIC): this run may be a resized relaunch of a
    # larger world; the loop then refuses a resume whose effective batch
    # differs from the checkpoint's, where it otherwise only warns.
    elastic: bool = False
    # Peak-LR world size (LR_WORLD_SIZE): the linear-scaling rule's
    # world, pinned by the elastic supervisor to the full world so a
    # resized relaunch keeps the schedule (None: the process group's).
    lr_world_size: Optional[int] = None
    # The on-device non-finite-loss guard (NONFINITE_ACTION): "abort"
    # raises faults.NonFiniteLossError at the epoch boundary, "warn"
    # logs and continues, "off" ignores the counter.
    nonfinite_action: str = "abort"
    log_every_steps: int = 100

    def __post_init__(self):
        self.mesh_axes = tuple(self.mesh_axes)
        if self.mesh_shape is not None:
            self.mesh_shape = tuple(self.mesh_shape)
        if "expert" in self.mesh_axes and self.mesh_shape is not None and self.moe_experts:
            check_expert_split(self.moe_experts,
                               dict(zip(self.mesh_axes, self.mesh_shape)).get("expert", 1))
        if self.aot_warmup and self.engine != "dp":
            raise NotImplementedError(
                f"AOT_WARMUP=1 with ENGINE={self.engine}: the port captures the dp "
                f"step only; the mesh engines' capture comes with {_AOT_MESH_SLICE}")
        if self.attn_impl not in _ATTN:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.compute_dtype)

    @property
    def data_parallel_width(self) -> int:
        """The batch width this config describes, before any mesh
        exists (JAX's): under dp and pjit every rank is a batch slot
        (the ``torch.distributed`` world, 1 without one; pjit's model
        axis takes replicated batches); under pp and sp only the
        ``replica``/``data`` axes shard the batch. Holders of a resolved
        mesh use ``parallel.mesh.dp_size(mesh)`` instead."""
        dist = torch.distributed
        n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if self.engine not in ("pp", "sp"):
            return n
        if self.mesh_shape is not None:
            from distributeddeeplearning_tpu_torch.parallel.mesh import MeshConfig

            shape = MeshConfig(axes=self.mesh_axes, shape=self.mesh_shape).resolve_shape(n)
            width = 1
            for axis, size in zip(self.mesh_axes, shape):
                if axis in ("replica", "data"):
                    width *= size
            return width
        # The engines' default meshes (loop.resolve_engine): pp puts
        # PP_STAGES (or every rank) on pipe; sp puts every rank on seq.
        if self.engine == "pp":
            return n // (self.pp_stages or n)
        return 1

    @property
    def global_batch_size(self) -> int:
        return self.batch_size_per_device * self.data_parallel_width

    def model_kwargs(self) -> dict:
        """The ``get_model`` kwargs this config implies, as the JAX
        package's ``model_kwargs`` (``get_model`` hands ``attn_impl`` to
        the attention models only, ``moe_experts`` to the LM family and
        ``remat`` to ViT and the LMs), plus ``image_size``, which sizes
        ViT's ``pos_embed`` (flax infers it from the first input) and
        which ``get_model`` hands to ViT only."""
        kw = dict(num_classes=self.num_classes, dtype=self.compute_dtype,
                  attn_impl=self.attn_impl, image_size=self.image_size)
        if self.moe_experts is not None:
            kw["moe_experts"] = self.moe_experts
        if self.remat:
            kw["remat"] = True
        return kw

    def steps_per_epoch(self, data_length: Optional[int] = None) -> int:
        n = data_length if data_length is not None else self.fake_data_length
        return max(n // self.global_batch_size, 1)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None, **overrides) -> "TrainConfig":
        """Build a config from the JAX package's env-var contract, for the
        vars of this slice; a var of a later slice raises."""
        e = os.environ if env is None else env
        kw = {}
        parse = {
            "DISTRIBUTED": ("distributed", _str_to_bool),
            "FAKE": ("fake", _str_to_bool),
            "FAKE_DATA_LENGTH": ("fake_data_length", int),
            "EPOCHS": ("epochs", int),
            "BATCHSIZE": ("batch_size_per_device", int),
            "LR": ("base_lr", float),
            "MODEL": ("model", str),
            "COMPUTE_DTYPE": ("compute_dtype", str),
            "ATTN_IMPL": ("attn_impl", str),
            "MOE_EXPERTS": ("moe_experts", int),
            "REMAT": ("remat", _str_to_bool),
            "DECOUPLED_WEIGHT_DECAY": ("decoupled_weight_decay", float),
            "OPTIMIZER": ("optimizer", str),
            "LR_SCHEDULE": ("lr_schedule", str),
            "INPUT_STAGING": ("input_staging", str),
            "GRAD_ACCUM_STEPS": ("grad_accum_steps", int),
            "ACCUM_STEPS": ("accum_steps", int),
            "WEIGHT_DECAY": ("weight_decay", float),
            "ENGINE": ("engine", str),
            "PP_STAGES": ("pp_stages", int),
            "PP_MICROBATCHES": ("pp_microbatches", int),
            "PP_SCHEDULE": ("pp_schedule", str),
            "PARAM_SHARDING": ("param_sharding", str),
            "ALLOW_SYNC_BN": ("allow_sync_bn", _str_to_bool),
            "ASYNC_COLLECTIVES": ("async_collectives", _str_to_bool),
            "SEED": ("seed", int),
            "DATA_TOPOLOGY": ("data_topology", str),
            "IMAGE_SIZE": ("image_size", int),
            "NUM_CLASSES": ("num_classes", int),
            "VALIDATION": ("validation", _str_to_bool),
            "PREFETCH_BATCHES": ("prefetch_batches", int),
            "CHECKPOINT_EVERY_STEPS": ("checkpoint_every_steps", int),
            "CHECKPOINT_KEEP": ("checkpoint_keep", int),
            "CHECKPOINT_ASYNC": ("checkpoint_async", _str_to_bool),
            "RESUME": ("resume", _str_to_bool),
            "NONFINITE_ACTION": ("nonfinite_action", str),
            "AOT_WARMUP": ("aot_warmup", _str_to_bool),
            "ELASTIC": ("elastic", _str_to_bool),
            "LR_WORLD_SIZE": ("lr_world_size", int),
            "NUM_WORKERS": ("num_workers", int),
            "WORKER_MODE": ("worker_mode", str),
            "DATA_FORMAT": ("data_format", str),
            "STREAM_SHUFFLE_BLOCK": ("stream_shuffle_block", int),
            "PREFETCH_HOST_BATCHES": ("prefetch_host_batches", int),
        }
        for var, (field, conv) in parse.items():
            if var in e:
                kw[field] = conv(e[var])
        # Mesh topology (e.g. ENGINE=pjit MESH_AXES=data,model MESH_SHAPE=2,4)
        if "MESH_AXES" in e:
            kw["mesh_axes"] = tuple(a.strip() for a in e["MESH_AXES"].split(",") if a.strip())
        if "MESH_SHAPE" in e:
            kw["mesh_shape"] = tuple(int(x) for x in e["MESH_SHAPE"].split(",") if x.strip())
        if "WORKER_MODE" not in e and "MULTIPROCESSING" in e:  # the reference's spelling
            kw["worker_mode"] = "process" if _str_to_bool(e["MULTIPROCESSING"]) else "thread"
        # The Batch AI spellings take precedence (as in JAX).
        data_dir = e.get("AZ_BATCHAI_INPUT_TRAIN") or e.get("DATA_DIR")
        val_dir = e.get("AZ_BATCHAI_INPUT_TEST") or e.get("VAL_DATA_DIR")
        if data_dir:
            kw["data_dir"] = data_dir
        if val_dir:
            kw["val_data_dir"] = val_dir
        if "COMPILATION_CACHE_DIR" in e:
            kw["compilation_cache_dir"] = e["COMPILATION_CACHE_DIR"] or None
        model_dir = e.get("AZ_BATCHAI_OUTPUT_MODEL") or e.get("MODEL_DIR")
        if model_dir:
            kw["model_dir"] = model_dir
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
