"""The pjit engine of the port: the JAX package's
``training/pjit_step.py`` (``logical_shardings``,
``create_sharded_train_state`` ``:109``, ``make_pjit_train_step``
``:183-394``, ``make_pjit_eval_step`` ``:396``, ``build_pjit_state``
``:461``) on one process per rank.

JAX annotates the weights with logical axes, maps them to mesh axes with
a rules table and lets GSPMD partition the program. The port reads the
same logical axes (``models/sharding.py``) and lays each parameter out
by hand (:class:`MeshLayout`):

* ``tp`` (``heads``/``mlp`` over ``model``): Megatron tensor
  parallelism. Every ``Attention`` keeps its heads' share (``qkv`` is
  column parallel over the q, k and v blocks of its heads, ``proj``
  row parallel), every ``MlpBlock`` its ``mlp`` columns (``fc1`` column
  parallel, ``fc2`` row parallel); a column-parallel input sums its
  gradient over ``model`` (``collectives.copy_to_group``), a
  row-parallel output is summed over ``model`` once in the forward
  (``collectives.psum_keepgrad``), the bias added after. A dropout mask
  of the sharded GELU output is drawn full width and sliced, so the
  ranks draw what one rank would.
* ``fsdp`` (``embed`` over ``data``): ZeRO-3. Each annotated parameter
  keeps the ``1/n`` slice of its ``embed`` dim (JAX's dim, not FSDP2's
  dim 0); a parametrization all-gathers it where the module reads it,
  and the backward reduce-scatters its gradient. Biases of ``qkv`` and
  ``fc1``, LayerNorm and every ResNet parameter stay replicated, as in
  JAX.
* ``expert`` (``expert`` over ``expert``, under the ``tp`` rules): expert
  parallelism. Every MoE block keeps ``E / n`` experts (``w1``, ``b1``,
  ``w2``, ``b2`` on dim 0, the router on its ``E`` dim) and runs them on
  the tokens it shares with its expert group, the combine summed over
  the group (``models/moe.py``). With a ``model`` axis too, each
  expert's ``mlp`` dim is split over it as well (a leaf split two ways:
  :class:`Shards`); under ``fsdp`` the experts' ``embed`` dims go over
  ``data`` like every annotated kernel's.
* ``dp``: replicated.

Seeded init is sharded at birth: the parameters are drawn in the dp
init's order and each rank keeps its slice of each as it is drawn, so
no rank ever holds the whole model (one full tensor at a time), and the
values are the dp engine's. Optimizer moments take their parameter's
layout. Gradients of replicated parameters and tensor-parallel shards
are averaged over the batch axes (``training/overlap.GradReducer``,
bucketed during the backward with ``ASYNC_COLLECTIVES``); FSDP shards,
summed by their reduce-scatter, are divided by the data size.

BatchNorm: per data shard by default (each rank normalises its own
rows, the dp engine's statistics; the running statistics are averaged
over the data axis only, so model ranks of one shard count once), or
over the whole batch with ``ALLOW_SYNC_BN=1`` (``models/norm.sync_bn``).
A model whose BatchNorm cannot keep per-replica statistics
(``per_replica_bn_capable`` False: the fused ResNet) is refused without
it. Dropout draws per data shard (``(seed, step, data index)``).

Each rank runs its own local tensors eagerly, so a ``FusedGradDense``
keeps its dW+db kernel under ``dp`` and ``fsdp`` (there on the gathered
weight, its dW reduce-scattered by the gather's backward); ``tp``
replaces the blocks' Dense layers by its column- and row-parallel
halves. (JAX's GSPMD step takes the plain dense instead, because the
SPMD partitioner cannot split a Pallas call; the numbers are the same.)

The step is the dp step's :class:`~.metrics.StepFn` (eager only:
``AOT_WARMUP`` with a mesh engine waits for its slice).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import parametrize

from distributeddeeplearning_tpu_torch.config import TrainConfig, check_expert_split
from distributeddeeplearning_tpu_torch.data.pipeline import normalize_staged_images, to_device
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.efficientnet import EfficientNet
from distributeddeeplearning_tpu_torch.models.moe import MoEMlpBlock
from distributeddeeplearning_tpu_torch.models.norm import sync_bn
from distributeddeeplearning_tpu_torch.models.sharding import (
    mesh_axes_of,
    rules_for_mesh,
    rules_table,
)
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.models.vit import Attention, Dense, MlpBlock, ViT
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import Mesh, batch_axes, dp_size
from distributeddeeplearning_tpu_torch.training import accum
from distributeddeeplearning_tpu_torch.training.metrics import EvalStepFn, StepFn, StepParts
from distributeddeeplearning_tpu_torch.training.overlap import GradReducer
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.training.train_step import (
    cross_entropy_loss,
    dropout_seed,
    eval_metrics_fn,
    hard_labels,
    sown_aux_loss,
)


# ---------------------------------------------------------------------------
# Layout: where each parameter's slices live
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Shard:
    """One parameter split ``n`` ways along ``dim`` over ``group``, this
    rank holding part ``index``; ``packed`` equal blocks along ``dim``
    (``qkv``'s q, k, v) are each split so (Megatron's layout)."""

    dim: int
    group: Any
    n: int
    index: int
    packed: int = 1

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor (a copy)."""
        if full.shape[self.dim] % (self.n * self.packed):
            raise ValueError(f"dim {self.dim} of {tuple(full.shape)} does not split over "
                             f"{self.n} ranks")
        parts = full.unflatten(self.dim, (self.packed, self.n, -1))
        return parts.select(self.dim + 1, self.index).flatten(self.dim, self.dim + 1).clone()

    def join(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (collective)."""
        got = collectives.all_gather(local.contiguous(), self.group, self.dim)
        if self.packed == 1:
            return got
        parts = got.unflatten(self.dim, (self.n, self.packed, -1))
        return parts.transpose(self.dim, self.dim + 1).flatten(self.dim, self.dim + 2)


@dataclasses.dataclass
class Shards:
    """One parameter split over several mesh axes in turn (an expert
    weight's dim 0 over ``expert``, then its ``mlp`` dim over ``model``);
    ``group`` spans all of them (a norm's partial sums add over it once)."""

    parts: Tuple[Shard, ...]
    group: Any

    def take(self, full: torch.Tensor) -> torch.Tensor:
        for part in self.parts:
            full = part.take(full)
        return full

    def join(self, local: torch.Tensor) -> torch.Tensor:
        for part in reversed(self.parts):
            local = part.join(local)
        return local


class _GatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return collectives.all_gather(local.contiguous(), shard.group, shard.dim)

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        return collectives.reduce_scatter(g.contiguous(), s.group, s.dim), None


class _Gathered(nn.Module):
    """FSDP's parametrization: the stored slice is gathered where the
    module reads the parameter; its gradient is reduce-scattered."""

    def __init__(self, shard: Shard) -> None:
        super().__init__()
        self.shard = shard

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        return _GatherFn.apply(local, self.shard)

    def right_inverse(self, full: torch.Tensor) -> torch.Tensor:
        return self.shard.take(full)


class ColumnParallelDense(Dense):
    """``Dense`` holding its output rows' shard: the input's gradient is
    summed over ``group``."""

    def __init__(self, dense: Dense, shard: Shard) -> None:
        nn.Module.__init__(self)
        self.dtype, self.group = dense.dtype, shard.group
        self.weight = nn.Parameter(shard.take(dense.weight.detach()))
        self.bias = nn.Parameter(shard.take(dense.bias.detach()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = collectives.copy_to_group(x, self.group)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class RowParallelDense(Dense):
    """``Dense`` holding its input columns' shard: the partial products
    are summed over ``group`` (in f32), then the whole bias added."""

    def __init__(self, dense: Dense, shard: Shard) -> None:
        nn.Module.__init__(self)
        self.dtype, self.group = dense.dtype, shard.group
        self.weight = nn.Parameter(shard.take(dense.weight.detach()))
        self.bias = nn.Parameter(dense.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        y = collectives.psum_keepgrad(y.float(), self.group).to(dt)
        return y + self.bias.to(dt)


def _family(model) -> str:
    return "transformer" if isinstance(model, (TransformerLM, ViT)) else "conv"


class MeshLayout:
    """Every parameter of a model on a mesh: its name in the dp model
    (``names``, the dp model's order), the tensor this rank holds
    (``leaves``), its :class:`Shard` (``None``: replicated) and how its
    gradient reduces (``rules``: ``"mean"`` or ``"scale"``). Buffers
    (BatchNorm running statistics) are replicated."""

    def __init__(self, model, names: List[str], leaves: Dict[str, torch.Tensor],
                 shards: Dict[str, Any], rules: Dict[str, str],
                 kernels: List[str]) -> None:
        self.model, self.names, self.leaves = model, names, leaves
        self.shards, self.rules, self.kernels = shards, rules, set(kernels)

    @property
    def params(self) -> List[torch.Tensor]:
        return [self.leaves[n] for n in self.names]

    def kernel_mask(self) -> List[bool]:
        return [n in self.kernels for n in self.names]

    def buffers(self) -> Dict[str, torch.Tensor]:
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith(("running_mean", "running_var"))}

    @torch.no_grad()
    def put(self, name: str, full: torch.Tensor) -> None:
        """Load the whole tensor ``full`` into this rank's slice."""
        if name in self.leaves:
            self.leaves[name].copy_(self.slice(name, full))
        else:
            self.buffers()[name].copy_(full)

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """A whole (dp) state dict into the sharded model."""
        missing = set(self.names) - set(state)
        if missing:
            raise KeyError(f"state dict lacks {sorted(missing)[:5]}")
        for name, full in state.items():
            self.put(name, full.to(self.params[0].device))

    def slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole tensor ``full`` of ``name``."""
        shard = self.shards.get(name)
        return full if shard is None else shard.take(full)

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        shard = self.shards.get(name)
        return local if shard is None else shard.join(local)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole dp state dict (collective: every rank calls it)."""
        out = {n: self.full(n, self.leaves[n]).detach() for n in self.names}
        out.update({n: b.detach() for n, b in self.buffers().items()})
        return out

    @torch.no_grad()
    def replicas_agree(self, group) -> bool:
        """Whether every parameter this layout does not split is bitwise
        equal on every rank of ``group`` (collective: the ranks of an
        ``expert`` or ``model`` group update their copies alike)."""
        flat = [self.leaves[n].contiguous().reshape(-1).view(torch.uint8)
                for n in self.names if self.shards.get(n) is None]
        if group is None or not flat:
            return True
        mine = torch.cat(flat)
        every = collectives.all_gather(mine[None], group, 0)
        return bool((every == mine).all())

    def per_param(self, fn, tree):
        """``fn(name, tensor)`` over every per-parameter list of an
        optimizer state (lists as long as the parameters)."""
        if isinstance(tree, dict):
            return {k: self.per_param(fn, v) for k, v in tree.items()}
        if isinstance(tree, list) and len(tree) == len(self.names) and all(
                torch.is_tensor(t) for t in tree):
            return [fn(n, t) for n, t in zip(self.names, tree)]
        return tree

    def l2(self, weight_decay: float, kernels: Optional[List[torch.Tensor]] = None
           ) -> torch.Tensor:
        """``weight_decay · Σ w²`` over the whole kernels: the shards'
        partial sums added over their groups (the gradient of each shard
        its own)."""
        dev = self.params[0].device
        if weight_decay == 0.0:
            return torch.zeros((), device=dev)
        total = torch.zeros((), device=dev)
        partial: Dict[int, Tuple[Any, torch.Tensor]] = {}
        for name in self.names:
            if name not in self.kernels:
                continue
            w = self._read(name)
            sq = (w.float() * w.float()).sum()
            shard = self.shards.get(name) if self.rules[name] == "mean" else None
            if shard is None:  # replicated, or FSDP's gathered whole
                total = total + sq
            else:
                grp, acc = partial.get(id(shard.group), (shard.group, 0))
                partial[id(shard.group)] = (grp, acc + sq)
        for grp, val in partial.values():
            total = total + collectives.psum_keepgrad(val, grp)
        return weight_decay * total

    def _read(self, name: str) -> torch.Tensor:
        """The tensor the forward reads: FSDP's gathered whole, else the
        leaf."""
        if self.rules[name] == "scale":
            owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
            return getattr(self.model.get_submodule(owner), leaf)
        return self.leaves[name]

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient: shards' squares summed over
        their groups."""
        local = torch.zeros((), device=grads[0].device)
        partial: Dict[int, Tuple[Any, torch.Tensor]] = {}
        for name, g in zip(self.names, grads):
            sq = (g.float() * g.float()).sum()
            shard = self.shards.get(name)
            if shard is None:
                local = local + sq
            else:
                grp, acc = partial.get(id(shard.group), (shard.group, 0))
                partial[id(shard.group)] = (grp, acc + sq)
        for grp, val in partial.values():
            local = local + collectives.all_reduce(val.clone(), grp)
        return torch.sqrt(local)


def _tensor_parallel(model, mesh: Mesh) -> Dict[str, Shard]:
    """Replace every Attention's and MlpBlock's Dense layers by their
    tensor-parallel halves over ``model`` (in place); the shards by
    parameter name."""
    group, m, r = mesh.group("model"), mesh.shape["model"], mesh.coords["model"]
    shards: Dict[str, Shard] = {}
    for name, mod in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, Attention):
            if mod.num_heads % m:
                raise ValueError(f"{mod.num_heads} heads do not split over model={m}")
            col = Shard(0, group, m, r, packed=3)
            row = Shard(1, group, m, r)
            mod.qkv = ColumnParallelDense(mod.qkv, col)
            mod.proj = RowParallelDense(mod.proj, row)
            mod.num_heads //= m
            shards[f"{prefix}qkv.weight"] = col
            shards[f"{prefix}qkv.bias"] = Shard(0, group, m, r, packed=3)
            shards[f"{prefix}proj.weight"] = row
        elif isinstance(mod, MlpBlock):
            col, row = Shard(0, group, m, r), Shard(1, group, m, r)
            width = mod.mlp_dim // m
            mod.fc1 = ColumnParallelDense(mod.fc1, col)
            mod.fc2 = RowParallelDense(mod.fc2, row)
            mod.mask_cols = slice(r * width, (r + 1) * width)
            shards[f"{prefix}fc1.weight"] = col
            shards[f"{prefix}fc1.bias"] = Shard(0, group, m, r)
            shards[f"{prefix}fc2.weight"] = row
    return shards


def _shard_experts(model, mesh: Mesh, rules) -> Dict[str, Any]:
    """Split every MoE block's parameters over the mesh axes the rules
    put their logical axes on (``expert``; ``mlp`` over ``model`` under
    ``tp``), in place, and tell the block its groups; the shards by
    parameter name."""
    shards: Dict[str, Any] = {}
    n, r = mesh.shape.get("expert", 1), mesh.coords.get("expert", 0)
    for name, mod in list(model.named_modules()):
        if not isinstance(mod, MoEMlpBlock):
            continue
        prefix = f"{name}." if name else ""
        used = set()
        for leaf in ("router", "w1", "b1", "w2", "b2"):
            p = getattr(mod, leaf)
            live = [(d, a) for d, a in enumerate(mesh_axes_of(prefix + leaf, p.dim(), rules))
                    if a in ("expert", "model") and mesh.shape.get(a, 1) > 1]
            if not live:
                continue
            axes = tuple(a for _, a in live)
            if "expert" in axes:
                check_expert_split(mod.num_experts, n)
            used.update(axes)
            parts = tuple(Shard(d, mesh.group(a), mesh.shape[a], mesh.coords[a]) for d, a in live)
            shard = parts[0] if len(parts) == 1 else Shards(parts, mesh.group(axes))
            setattr(mod, leaf, nn.Parameter(shard.take(p.detach())))
            shards[prefix + leaf] = shard
        ep = "expert" in used
        mod.shard(mesh.group("expert") if ep else None, n if ep else 1, r if ep else 0,
                  mesh.group("model") if "model" in used else None)
    return shards


def _fsdp(model, mesh: Mesh, rules) -> Dict[str, Shard]:
    """Register the gather parametrization on every parameter whose
    logical ``embed`` dim the rules put on ``data``."""
    group, n, r = mesh.group("data"), mesh.shape["data"], mesh.coords["data"]
    shards: Dict[str, Shard] = {}
    for name, p in list(model.named_parameters()):
        axes = mesh_axes_of(name, p.dim(), rules, _family(model))
        dims = [i for i, a in enumerate(axes) if a == "data" or
                (isinstance(a, tuple) and "data" in a)]
        if not dims:
            continue
        shard = Shard(dims[0], group, n, r)
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        parametrize.register_parametrization(model.get_submodule(owner), leaf,
                                             _Gathered(shard), unsafe=True)
        shards[name] = shard
    return shards


def _uses_axis(model, mesh: Mesh, rules, axis: str) -> bool:
    if mesh.shape.get(axis, 1) <= 1:
        return False
    fam = _family(model)
    return any(axis in (a if isinstance(a, tuple) else (a,))
               for name, p in model.named_parameters()
               for a in mesh_axes_of(name, p.dim(), rules, fam) if a is not None)


def layout_model(model, mesh: Mesh, param_sharding: str) -> MeshLayout:
    """Lay ``model`` (built, not yet initialised) out on ``mesh`` by the
    rules ``param_sharding`` names (module docstring)."""
    rules = rules_for_mesh(mesh, rules_table(param_sharding))
    names = [n for n, _ in model.named_parameters()]
    kernel_ids = {id(p) for p in model.kernel_parameters()}
    kernels = [n for n, p in model.named_parameters() if id(p) in kernel_ids]
    tp = _uses_axis(model, mesh, rules, "model")
    fsdp = _uses_axis(model, mesh, rules, "data")
    ep = _uses_axis(model, mesh, rules, "expert")
    shards: Dict[str, Any] = {}
    if tp:
        shards = _tensor_parallel(model, mesh)
    elif fsdp:
        shards = _fsdp(model, mesh, rules)
    if tp or ep:
        shards.update(_shard_experts(model, mesh, rules))
    for mod in model.modules():  # GSPMD's load-balance loss: the global batch's
        if isinstance(mod, MoEMlpBlock):
            mod.batch_group = mesh.group(batch_axes(mesh))
    leaves: Dict[str, torch.Tensor] = {}
    for name in names:
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = model.get_submodule(owner)
        if parametrize.is_parametrized(mod, leaf):
            leaves[name] = mod.parametrizations[leaf].original
        else:
            leaves[name] = getattr(mod, leaf)
    rules_by = {n: ("scale" if fsdp and n in shards else "mean") for n in names}
    return MeshLayout(model, names, leaves, shards, rules_by, kernels)


class _Sink(dict):
    """The init's output mapping: each drawn tensor goes straight into
    its slice (sharded at birth)."""

    def __init__(self, layout: MeshLayout) -> None:
        super().__init__()
        self.layout = layout

    def __setitem__(self, name, full) -> None:
        self.layout.put(name, full)


def init_layout(layout: MeshLayout, config: TrainConfig, device) -> None:
    """Seeded init in the dp init's draw order, each rank keeping its
    slices (``models/convert.py``'s initialisers)."""
    model = layout.model
    gen = torch.Generator(device=device).manual_seed(config.seed)
    if isinstance(model, TransformerLM):
        convert.init_params(model.variant, model.vocab_size, gen, model.max_seq_len,
                            model.moe_experts, model.moe_every, out=_Sink(layout),
                            depth=model.depth)
    elif isinstance(model, ViT):
        convert.init_vit_params(model.variant, model.patch_size, model.num_classes, gen,
                                model.image_size, out=_Sink(layout))
    elif isinstance(model, EfficientNet):
        layout.load_state_dict(convert.init_efficientnet_params(model.variant,
                                                                model.num_classes, gen))
    else:
        layout.load_state_dict(convert.init_resnet_params(model.depth, model.num_classes,
                                                          gen, model.s2d_stem))


def check_bn(model, config: TrainConfig) -> None:
    """JAX's guard (``pjit_step.py:470-510``): a model with BatchNorm
    that cannot keep per-replica statistics needs ``ALLOW_SYNC_BN=1``."""
    has_bn = any(n.endswith("running_mean") for n, _ in model.named_buffers())
    if has_bn and not config.allow_sync_bn and not getattr(model, "per_replica_bn_capable",
                                                          False):
        raise ValueError(
            f"model {type(model).__name__!r} carries batch_stats but does not declare "
            "per_replica_bn_capable (the fused ResNet's in-kernel statistics): under "
            "ENGINE=pjit its statistics would be GLOBAL-batch (sync-BN), not the "
            "per-replica statistics the dp engine (and the reference) uses. Use ENGINE=dp, "
            "or set ALLOW_SYNC_BN=1 to accept sync-BN.")


def build_pjit_state(model, config: TrainConfig, tx, mesh: Mesh, *, device=None,
                     state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """One construction point for ``ENGINE=pjit`` state: the BN guard,
    the layout by ``config.param_sharding``, the sharded-at-birth init
    (or ``state_dict``, whole, sliced on load) and the optimizer state
    over this rank's slices (``state.layout``)."""
    check_bn(model, config)
    model.to(device)
    layout = layout_model(model, mesh, config.param_sharding)
    if state_dict is None:
        init_layout(layout, config, device)
    else:
        layout.load_state_dict(state_dict)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(layout.params, layout.kernel_mask()), layout=layout)


# ---------------------------------------------------------------------------
# The steps (shared with the sp engine)
# ---------------------------------------------------------------------------

def make_mesh_train_step(model, tx, config: TrainConfig, layout: MeshLayout, *, device,
                         data_group, n_data: int, dropout_rank: int,
                         forward_ctx: Callable[[], Any], metric_group=None,
                         slice_batch: Optional[Callable] = None) -> StepFn:
    """The train step of a mesh engine: the dp step's order of events
    (forward, loss with L2 and MoE auxiliaries, backward, gradient
    reduction, update) with the layout's reductions: gradients through
    ``GradReducer`` over ``data_group`` (``n_data`` ranks), the BN
    running statistics and the metrics averaged over ``metric_group``
    (default: ``data_group``). ``forward_ctx()`` wraps each forward;
    ``slice_batch`` takes this rank's part of a staged batch."""
    cfg = config
    k = accum.resolve_accum_steps(cfg)
    metric_group = data_group if metric_group is None else metric_group
    params = layout.params
    buffers = list(layout.buffers().values())
    stochastic = getattr(model, "stochastic", False)
    generators = [torch.Generator(device=device) for _ in range(k)] if stochastic else []
    has_aux = any(isinstance(m, MoEMlpBlock) for m in model.modules())
    reducer = GradReducer(params, data_group, rules=[layout.rules[n] for n in layout.names],
                          divisor=n_data, enabled=cfg.async_collectives and k == 1)

    def grads_and_metrics(inputs, labels, generator=None):
        inputs = normalize_staged_images(inputs)
        with forward_ctx():
            logits = model(inputs) if generator is None else model(inputs, generator=generator)
            loss = cross_entropy_loss(logits, labels, cfg.label_smoothing)
            loss = loss + layout.l2(cfg.weight_decay)
            if has_aux:
                loss = loss + sown_aux_loss(model)
        if k == 1:
            reducer.arm()
        grads = list(torch.autograd.grad(loss, params))
        accuracy = (logits.argmax(-1) == hard_labels(logits, labels)).float().mean()
        return grads, {"loss": loss.detach(), "accuracy": accuracy}

    def prepare(state: TrainState):
        for idx, gen in enumerate(generators):
            gen.manual_seed(dropout_seed(cfg.seed, state.step, dropout_rank,
                                         idx if k > 1 else None))
        return tx.prepare(state.opt_state)

    def run(state: TrainState, tensors, token) -> Dict[str, torch.Tensor]:
        inputs, labels = tensors
        model.train()
        if k == 1:
            grads, m = grads_and_metrics(inputs, labels, generators[0] if generators else None)
        else:
            grads, m = accum.accumulate_microbatches(
                lambda mb, idx: grads_and_metrics(*mb, generators[idx] if generators else None),
                (inputs, labels), k, params)
        grads = reducer.finish(grads)
        stats = collectives.allreduce_gradients(buffers + [m["loss"].reshape(1),
                                                           m["accuracy"].reshape(1)],
                                                metric_group)
        with torch.no_grad():
            for b, v in zip(buffers, stats):
                b.copy_(v)
        loss, accuracy = stats[-2][0], stats[-1][0]
        grad_norm = layout.grad_norm(grads)
        tx.update(params, grads, state.opt_state, token)
        return {"loss": loss, "accuracy": accuracy, "grad_norm": grad_norm}

    def finish(state: TrainState) -> None:
        state.step += 1

    def stage(batch):
        tensors = to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)
        return slice_batch(tensors) if slice_batch is not None else tensors

    parts = StepParts(prepare=prepare, run=run, finish=finish,
                      phase=lambda state: tx.phase(state.opt_state),
                      phases=getattr(tx, "phases", 1), generators=generators,
                      stage=stage, device=device, model=model)
    return StepFn(parts, accum_steps=k)


def make_mesh_eval_step(model, *, device, sum_group, forward_ctx: Callable[[], Any],
                        slice_batch: Optional[Callable] = None, batch_group=...) -> EvalStepFn:
    """The eval contract of every engine: ``(inputs, labels[, weights])``
    -> weighted means and ``count``, the sums added over ``sum_group``
    (the ranks that hold distinct samples or tokens). Unweighted
    batches (every sample real) need ``batch_group`` (the ranks holding
    distinct samples; default ``sum_group``) to be one rank."""
    batch_group = sum_group if batch_group is ... else batch_group

    def stage(batch):
        tensors = to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)
        if len(tensors) == 2:
            if collectives.group_size(batch_group) > 1:
                raise ValueError("multi-process eval requires (inputs, labels, weights) "
                                 "batches: use an exact eval dataset (train=False)")
            ones = torch.ones(tensors[1].shape[:1], dtype=torch.float32, device=device)
            tensors = (tensors[0], tensors[1], ones)
        return slice_batch(tensors) if slice_batch is not None else tensors

    @torch.no_grad()
    def run(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        inputs, labels, weights = batch
        model.eval()
        with forward_ctx():
            logits = model(normalize_staged_images(inputs))
        sums = eval_metrics_fn(logits, labels, weights)
        flat = torch.stack([sums[key] for key in ("loss", "top1", "top5", "count")])
        collectives.all_reduce(flat, sum_group)
        count = flat[3]
        means = flat[:3] / torch.clamp(count, min=1.0)
        return {"loss": means[0], "top1": means[1], "top5": means[2], "count": count}

    return EvalStepFn(run, stage, device, model)


def _pjit_ctx(config: TrainConfig, mesh: Mesh):
    group = mesh.group(batch_axes(mesh)) if config.allow_sync_bn else None
    return lambda: sync_bn(group)


def make_pjit_train_step(model, tx, mesh: Mesh, config: TrainConfig, layout: MeshLayout,
                         *, device) -> StepFn:
    """The pjit train step over ``mesh`` (module docstring); the batch
    is this rank's data shard."""
    axes = batch_axes(mesh)
    accum.validate_accum_config(config, dp_size(mesh))
    return make_mesh_train_step(model, tx, config, layout, device=device,
                                data_group=mesh.group(axes), n_data=dp_size(mesh),
                                dropout_rank=mesh.axis_index(axes),
                                forward_ctx=_pjit_ctx(config, mesh))


def make_pjit_eval_step(model, mesh: Mesh, config: TrainConfig, *, device) -> EvalStepFn:
    """Eval under the train step's layout: running-statistics BN, the
    weighted sums added over the batch axes."""
    return make_mesh_eval_step(model, device=device, sum_group=mesh.group(batch_axes(mesh)),
                               forward_ctx=_pjit_ctx(config.replace(allow_sync_bn=False),
                                                     mesh))
