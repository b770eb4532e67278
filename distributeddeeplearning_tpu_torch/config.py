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
``LR_WORLD_SIZE``; ``launch.py``).

Field names, defaults and ``from_env`` parsing are the JAX package's. A
field of a later slice that the dataclass carries (``engine``,
``optimizer``, ``fake``) must keep its default; any other value raises
``NotImplementedError`` naming the slice that brings it. An env var of
the JAX contract whose field the port does not carry yet raises the
same way from :meth:`from_env`: no setting is silently ignored. ``FUSED_DENSE_GRAD`` is no field in either
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

# Fields of later slices: (default, the slice that implements the rest).
_GATED = {
    "engine": ("dp", "the mesh/engine slice (pjit, pp, sp)"),
    "optimizer": ("sgd", "the adamw optimizer (a later slice)"),
    "fake": (True, "the real-data pipeline (data/imagenet.py, data/stream/)"),
}

# Env vars of the JAX contract whose fields this slice does not carry.
_LATER_ENV = {
    "NUM_WORKERS": "the real-data pipeline", "WORKER_MODE": "the real-data pipeline",
    "MULTIPROCESSING": "the real-data pipeline", "DATA_FORMAT": "the real-data pipeline",
    "STREAM_SHUFFLE_BLOCK": "the real-data pipeline",
    "PREFETCH_HOST_BATCHES": "the real-data pipeline",
    "AZ_BATCHAI_INPUT_TRAIN": "the real-data pipeline", "DATA_DIR": "the real-data pipeline",
    "AZ_BATCHAI_INPUT_TEST": "the real-data pipeline", "VAL_DATA_DIR": "the real-data pipeline",
    "MOE_EXPERTS": "the MoE slice (models/moe.py)",
    "REMAT": "the gradient-checkpointing slice",
    "DECOUPLED_WEIGHT_DECAY": "the adamw optimizer (a later slice)",
    "PP_STAGES": "the mesh/engine slice", "PP_MICROBATCHES": "the mesh/engine slice",
    "PP_SCHEDULE": "the mesh/engine slice", "PARAM_SHARDING": "the mesh/engine slice",
    "ALLOW_SYNC_BN": "the mesh/engine slice", "MESH_AXES": "the mesh/engine slice",
    "MESH_SHAPE": "the mesh/engine slice",
    "ASYNC_COLLECTIVES": "the mesh/engine slice",
}


# Attention implementations: the port's, and those of later slices.
_ATTN = ("xla", "pallas", "fused", "auto")
_LATER_ATTN = {"ring": "the sp engine (parallel/ring_attention.py)"}


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

    # Optimization: LR 0.001 x world size, momentum 0.9, L2 5e-5 on
    # kernels, 5-epoch warmup, x0.1 at 30/60/80.
    batch_size_per_device: int = 64
    base_lr: float = 0.001
    optimizer: str = "sgd"
    momentum: float = 0.9
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
    # "process": disjoint per-process streams; "global": one stream,
    # each process taking its contiguous share of every global batch.
    data_topology: str = "process"

    validation: bool = False
    prefetch_batches: int = 2

    # Distribution: DISTRIBUTED asks parallel/distributed.maybe_initialize
    # for torch's env:// rendezvous when no DDL_* variables are set.
    distributed: bool = False
    engine: str = "dp"

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
        for name, (default, later) in _GATED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r}: the port supports only "
                    f"{default!r} so far; the rest comes with {later}"
                )
        if self.attn_impl in _LATER_ATTN:
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: the port has {_ATTN} so far; "
                f"{self.attn_impl!r} comes with {_LATER_ATTN[self.attn_impl]}"
            )
        if self.attn_impl not in _ATTN:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return getattr(torch, self.compute_dtype)

    @property
    def data_parallel_width(self) -> int:
        """Batch shards: the ``torch.distributed`` world size when a
        process group is up, else 1 (one process per GPU)."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    @property
    def global_batch_size(self) -> int:
        return self.batch_size_per_device * self.data_parallel_width

    def model_kwargs(self) -> dict:
        """The ``get_model`` kwargs this config implies, as the JAX
        package's ``model_kwargs`` (``get_model`` hands ``attn_impl`` to
        the attention models only), plus ``image_size``, which sizes
        ViT's ``pos_embed`` (flax infers it from the first input) and
        which ``get_model`` hands to ViT only."""
        return dict(num_classes=self.num_classes, dtype=self.compute_dtype,
                    attn_impl=self.attn_impl, image_size=self.image_size)

    def steps_per_epoch(self, data_length: Optional[int] = None) -> int:
        n = data_length if data_length is not None else self.fake_data_length
        return max(n // self.global_batch_size, 1)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None, **overrides) -> "TrainConfig":
        """Build a config from the JAX package's env-var contract, for the
        vars of this slice; a var of a later slice raises."""
        e = os.environ if env is None else env
        later = sorted(k for k in e if k in _LATER_ENV)
        if later:
            raise NotImplementedError(
                "the port does not read these settings yet: "
                + ", ".join(f"{k} ({_LATER_ENV[k]})" for k in later)
            )
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
            "OPTIMIZER": ("optimizer", str),
            "LR_SCHEDULE": ("lr_schedule", str),
            "INPUT_STAGING": ("input_staging", str),
            "GRAD_ACCUM_STEPS": ("grad_accum_steps", int),
            "ACCUM_STEPS": ("accum_steps", int),
            "WEIGHT_DECAY": ("weight_decay", float),
            "ENGINE": ("engine", str),
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
        }
        for var, (field, conv) in parse.items():
            if var in e:
                kw[field] = conv(e[var])
        if "COMPILATION_CACHE_DIR" in e:
            kw["compilation_cache_dir"] = e["COMPILATION_CACHE_DIR"] or None
        model_dir = e.get("AZ_BATCHAI_OUTPUT_MODEL") or e.get("MODEL_DIR")
        if model_dir:
            kw["model_dir"] = model_dir
        kw.update(overrides)
        return cls(**kw)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
