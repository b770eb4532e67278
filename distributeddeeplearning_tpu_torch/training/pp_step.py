"""Pipeline-parallel training, GPipe and 1F1B over a ``pipe`` axis: the
port of the JAX package's ``training/pp_step.py`` (``create_pp_state``
``:63-96``, GPipe ``:100-418``, 1F1B ``:434-796``, eval ``:798``).

Each rank of the ``pipe`` group is one stage (``models/pipeline_lm``):
it holds the embedding and the head (replicated, as JAX's) and its own
blocks. Its data shard's batch is split into ``M`` microbatches; stage
activations travel to the next stage's rank and gradients back, point
to point (``collectives.exchange``).

* **GPipe** (fill-drain): every stage runs all ``M`` forwards (the
  first stage from the embedding, the others from what they receive),
  keeping each microbatch's graph; the last stage applies the head to
  all of them and takes the loss; then the backward runs in one pass
  per stage, each stage receiving the gradients of its outputs and
  sending those of its inputs back.
* **1F1B**: the ticks of JAX's schedule, ``t ∈ [0, M + 2S − 1)``: at
  tick ``t`` stage ``s`` runs the forward of microbatch ``t − s``
  without a graph, keeping only its input, and the backward of
  microbatch ``t − 2S + 1 + s``, recomputing that stage forward from the
  kept input (the same dropout masks) and taking its vjp: at most ``2S``
  stage inputs live at once instead of ``M`` graphs. Both halves run
  on every stage every tick, as JAX's uniform program does (the last
  stage's forward half feeds nobody).

The loss is the mean of the microbatches' mean cross-entropies (the
last stage's) plus ``weight_decay · Σ w²`` over every kernel, the
embedding and head's counted once (stage 0's) and each stage's own; the
gradients of the replicated embedding and head are summed over
``pipe`` (each stage holds a part: the embedding's on stage 0, the
head's loss part on the last, its L2 part on stage 0), and every
gradient is then averaged over the batch axes only. Dropout draws per
(rank over the batch and pipe axes, step, microbatch), so the two
schedules draw the same masks and agree with dropout on. The eval step
relays the whole batch through the stages and sums the last stage's
weighted metric sums over ``pipe`` and the batch axes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.pipeline import to_device
from distributeddeeplearning_tpu_torch.models.pipeline_lm import PipelineLM, init_pipeline_params
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import Mesh, batch_axes
from distributeddeeplearning_tpu_torch.training import accum
from distributeddeeplearning_tpu_torch.training.metrics import EvalStepFn, StepFn, StepParts
from distributeddeeplearning_tpu_torch.training.overlap import GradReducer
from distributeddeeplearning_tpu_torch.training.pjit_step import MeshLayout
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.training.train_step import (
    cross_entropy_loss,
    dropout_seed,
    eval_metrics_fn,
)

PIPE_AXIS = "pipe"
SCHEDULES = ("gpipe", "1f1b")


class StageShard:
    """A stage's part of a parameter JAX stacks as ``[S, …]`` over
    ``pipe``: the whole is the stack of every stage's tensor."""

    def __init__(self, group, index: int) -> None:
        self.group, self.index = group, index

    def take(self, full: torch.Tensor) -> torch.Tensor:
        return full[self.index].clone()

    def join(self, local: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather(local.unsqueeze(0).contiguous(), self.group, 0)


def pp_layout(pl: PipelineLM, mesh: Mesh) -> MeshLayout:
    """The stage's parameters: ``core.*`` stacked over ``pipe`` in a
    checkpoint, the embedding and head replicated (their gradients take
    the pipe sum first: rule ``"pipe"``)."""
    group = mesh.group(PIPE_AXIS)
    shard = StageShard(group, mesh.coords.get(PIPE_AXIS, 0))
    names = [n for n, _ in pl.named_parameters()]
    leaves = dict(pl.named_parameters())
    shards = {n: (shard if n.startswith("core.") else None) for n in names}
    rules = {n: ("mean" if n.startswith("core.") else "pipe") for n in names}
    kernel_ids = {id(p) for p in pl.kernel_parameters()}
    kernels = [n for n in names if id(leaves[n]) in kernel_ids]
    return MeshLayout(pl, names, leaves, shards, rules, kernels)


def create_pp_state(pl: PipelineLM, config: TrainConfig, tx, mesh: Mesh, *, device,
                    state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """Seeded state of this rank's stage (or ``state_dict``: this stage's,
    as ``convert.pipeline_params_from_flax`` gives it)."""
    if mesh.shape.get(PIPE_AXIS, 1) != pl.num_stages:
        raise ValueError(f"mesh pipe axis {mesh.shape.get(PIPE_AXIS)} != num_stages "
                         f"{pl.num_stages}")
    pl.to(device)
    sd = state_dict if state_dict is not None else init_pipeline_params(pl, config.seed, device)
    pl.load_state_dict({k: v.to(device) for k, v in sd.items()})
    layout = pp_layout(pl, mesh)
    return TrainState(step=0, model=pl, opt_state=tx.init(layout.params, layout.kernel_mask()),
                      layout=layout)


def _kernel_l2(pl: PipelineLM, stage: int, weight_decay: float, device) -> torch.Tensor:
    """This stage's L2 term: its blocks' kernels, and on stage 0 the
    head's (the embedding and head counted once over the pipe)."""
    if weight_decay == 0.0:
        return torch.zeros((), device=device)
    ws = [m.weight for m in pl.core.modules() if hasattr(m, "weight") and m.weight.dim() == 2]
    if stage == 0:
        ws.append(pl.head.proj.weight)
    return weight_decay * torch.stack([(w.float() * w.float()).sum() for w in ws]).sum()


def make_pp_train_step(pl: PipelineLM, tx, mesh: Mesh, config: TrainConfig,
                       layout: MeshLayout, *, device, num_microbatches: int = 4,
                       schedule: str = "gpipe") -> StepFn:
    """The pipeline train step (module docstring): ``schedule`` is
    ``"gpipe"`` or ``"1f1b"``; the batch is this rank's data shard."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown PP schedule {schedule!r} (gpipe, 1f1b)")
    if PIPE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{PIPE_AXIS}' axis")
    S = mesh.shape[PIPE_AXIS]
    if S != pl.num_stages:
        raise ValueError(f"mesh pipe={S} != model num_stages={pl.num_stages}")
    cfg = config
    k = accum.resolve_accum_steps(cfg)
    M = num_microbatches
    s = mesh.coords[PIPE_AXIS]
    nxt = mesh.peer(PIPE_AXIS, 1) if s < S - 1 else None
    prv = mesh.peer(PIPE_AXIS, -1) if s > 0 else None
    daxes = batch_axes(mesh)
    data_group, pipe_group = mesh.group(daxes), mesh.group(PIPE_AXIS)
    dropout_rank = mesh.axis_index(daxes + (PIPE_AXIS,))
    params = layout.params
    is_eh = [layout.rules[n] == "pipe" for n in layout.names]
    gen = torch.Generator(device=device) if pl.stochastic else None
    reducer = GradReducer(params, data_group, rules=[layout.rules[n] for n in layout.names],
                          divisor=mesh.axis_size(daxes),
                          enabled=cfg.async_collectives and schedule == "gpipe" and k == 1)
    step_no = [0]

    def seed(m: int, chunk: Optional[int]) -> None:
        if gen is not None:
            micro = m if chunk is None else chunk * M + m
            gen.manual_seed(dropout_seed(cfg.seed, step_no[0], dropout_rank, micro))

    def core(x, m, chunk):
        seed(m, chunk)
        return pl.core(x, generator=gen)

    def hidden_buf(mb, t):
        return torch.empty(mb, t, pl.hidden, dtype=pl.dtype, device=device)

    def add(acc: List, grads) -> None:
        for i, g in enumerate(grads):
            if g is not None:
                acc[i] = g.float() if acc[i] is None else acc[i] + g.float()

    def gpipe(tokens, labels, chunk):
        """One fill-drain pass: the raw (pre-collective) gradients and
        the last stage's loss and accuracy (zeros elsewhere)."""
        b_l, t = tokens.shape
        if b_l % M:
            raise ValueError(f"local batch {b_l} not divisible by {M} microbatches")
        mb = b_l // M
        x_all = pl.embed(tokens) if s == 0 else None
        ins, outs = [], []
        for m in range(M):
            if s == 0:
                x_in = x_all[m * mb:(m + 1) * mb]
            else:
                x_in = hidden_buf(mb, t)
                collectives.exchange([], [(x_in, prv)])
                x_in.requires_grad_()
            y = core(x_in, m, chunk)
            if nxt is not None:
                collectives.exchange([(y.detach(), nxt)], [])
            ins.append(x_in)
            outs.append(y)
        l2 = _kernel_l2(pl, s, cfg.weight_decay, device)
        inputs = params + (ins if s > 0 else [])
        if nxt is None:
            logits = pl.head(torch.cat(outs))
            ce = cross_entropy_loss(logits, labels, cfg.label_smoothing)
            grads = torch.autograd.grad(ce + l2, inputs, allow_unused=True)
            acc = (logits.argmax(-1) == labels.long()).float().mean()
        else:
            dys = [hidden_buf(mb, t) for _ in range(M)]
            collectives.exchange([], [(d, nxt) for d in dys])
            with_l2 = [l2] if l2.requires_grad else []
            grads = torch.autograd.grad(outs + with_l2, inputs,
                                        grad_outputs=dys + [torch.ones_like(l2)] * len(with_l2),
                                        allow_unused=True)
            ce = acc = torch.zeros((), device=device)
        grads = list(grads)
        if s > 0:
            collectives.exchange([(g, prv) for g in grads[len(params):]], [])
        return grads[:len(params)], ce.detach(), acc, l2.detach()

    def one_f_one_b(tokens, labels, chunk):
        """One 1F1B pass over JAX's ticks (module docstring)."""
        b_l, t = tokens.shape
        if b_l % M:
            raise ValueError(f"local batch {b_l} not divisible by {M} microbatches")
        mb = b_l // M
        x_all = pl.embed(tokens) if s == 0 else None
        dx_all = torch.zeros_like(x_all) if s == 0 else None
        lm = labels.reshape(M, mb, t) if nxt is None else None
        saved: Dict[int, torch.Tensor] = {}
        acc_grads: List = [None] * len(params)
        ce_sum = torch.zeros((), device=device)
        acc_sum = torch.zeros((), device=device)
        fwd_in = bwd_in = None
        for tick in range(M + 2 * S - 1):
            m_f, m_b = tick - s, tick - 2 * S + 1 + s
            sends = []
            if 0 <= m_f < M:
                x_in = x_all[m_f * mb:(m_f + 1) * mb].detach() if s == 0 else fwd_in
                saved[m_f] = x_in
                with torch.no_grad():
                    y = core(x_in, m_f, chunk)
                if nxt is not None:
                    sends.append((y, nxt))
            if 0 <= m_b < M:
                x = saved.pop(m_b).detach().requires_grad_()
                y = core(x, m_b, chunk)
                if nxt is None:
                    logits = pl.head(y)
                    ce_m = cross_entropy_loss(logits, lm[m_b], cfg.label_smoothing)
                    grads = torch.autograd.grad(ce_m / M, params + [x], allow_unused=True)
                    ce_sum = ce_sum + ce_m.detach() / M
                    acc_sum = acc_sum + (logits.argmax(-1) == lm[m_b].long()).float().mean() / M
                else:
                    grads = torch.autograd.grad(y, params + [x], grad_outputs=bwd_in,
                                                allow_unused=True)
                add(acc_grads, grads[:-1])
                if s > 0:
                    sends.append((grads[-1], prv))
                else:
                    dx_all[m_b * mb:(m_b + 1) * mb] = grads[-1]
            recvs = []
            if s > 0 and 0 <= tick + 1 - s < M:
                fwd_in = hidden_buf(mb, t)
                recvs.append((fwd_in, prv))
            if nxt is not None and 0 <= tick + 2 - 2 * S + s < M:
                bwd_in = hidden_buf(mb, t)
                recvs.append((bwd_in, nxt))
            collectives.exchange(sends, recvs)
        l2 = _kernel_l2(pl, s, cfg.weight_decay, device)
        outs, gouts = ([l2], [torch.ones_like(l2)]) if l2.requires_grad else ([], [])
        if s == 0:
            outs.append(x_all)
            gouts.append(dx_all)
        if outs:
            add(acc_grads, torch.autograd.grad(outs, params, grad_outputs=gouts,
                                               allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for g, p in zip(acc_grads, params)]
        return grads, ce_sum, acc_sum, l2.detach()

    run_pass = gpipe if schedule == "gpipe" else one_f_one_b

    def prepare(state: TrainState):
        step_no[0] = state.step
        return tx.prepare(state.opt_state)

    def run(state: TrainState, tensors, token) -> Dict[str, torch.Tensor]:
        tokens, labels = tensors
        pl.train()
        if k == 1:
            reducer.arm()
            grads, ce, acc, l2 = run_pass(tokens, labels, None)
            grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                     for g, p in zip(grads, params)]
        else:
            micro_b = tokens.shape[0] // k
            if tokens.shape[0] % k or micro_b % M:
                raise ValueError(
                    f"ENGINE=pp ACCUM_STEPS={k}: accumulation microbatch of the per-shard "
                    f"batch {tokens.shape[0]} is not divisible by PP_MICROBATCHES={M}")
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in params]
            ce = acc = l2 = torch.zeros((), device=device)
            for c, (tk, lb) in enumerate(accum.split_microbatches((tokens, labels), k)):
                g, ce_c, acc_c, l2 = run_pass(tk, lb, c)
                for i, gi in enumerate(g):
                    if gi is not None:
                        gsum[i] += gi.float()
                ce, acc = ce + ce_c / k, acc + acc_c / k
            grads = [(a / k).to(p.dtype) for a, p in zip(gsum, params)]
        # the embedding's and head's parts live on different stages
        eh = [i for i, e in enumerate(is_eh) if e]
        summed = collectives.allreduce_sum([grads[i] for i in eh], pipe_group)
        for i, g in zip(eh, summed):
            grads[i] = g
        grads = reducer.finish(grads)
        mean_eh = collectives.allreduce_gradients([grads[i] for i in eh], data_group)
        for i, g in zip(eh, mean_eh):
            grads[i] = g
        loss_acc = collectives.allreduce_sum([(ce + l2).reshape(1), acc.reshape(1)], pipe_group)
        metrics = collectives.allreduce_metrics({"loss": loss_acc[0][0],
                                                 "accuracy": loss_acc[1][0]}, data_group)
        metrics["grad_norm"] = layout.grad_norm(grads)
        tx.update(params, grads, state.opt_state, token)
        return metrics

    def finish(state: TrainState) -> None:
        state.step += 1

    def stage(batch):
        return to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)

    parts = StepParts(prepare=prepare, run=run, finish=finish,
                      phase=lambda state: tx.phase(state.opt_state),
                      phases=getattr(tx, "phases", 1), generators=[],
                      stage=stage, device=device, model=pl)
    return StepFn(parts, accum_steps=k)


def make_pp_eval_step(pl: PipelineLM, mesh: Mesh, *, device) -> EvalStepFn:
    """Eval through the pipeline (module docstring)."""
    if PIPE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{PIPE_AXIS}' axis")
    S, s = mesh.shape[PIPE_AXIS], mesh.coords[PIPE_AXIS]
    nxt = mesh.peer(PIPE_AXIS, 1) if s < S - 1 else None
    prv = mesh.peer(PIPE_AXIS, -1) if s > 0 else None
    data_group, pipe_group = mesh.group(batch_axes(mesh)), mesh.group(PIPE_AXIS)

    def stage(batch):
        tensors = to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)
        if len(tensors) == 2:
            if collectives.group_size(data_group) > 1:
                raise ValueError("multi-process eval requires (inputs, labels, weights) "
                                 "batches: use an exact eval dataset (train=False)")
            ones = torch.ones(tensors[1].shape[:1], dtype=torch.float32, device=device)
            tensors = (tensors[0], tensors[1], ones)
        return tensors

    @torch.no_grad()
    def run(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        tokens, labels, weights = batch
        pl.eval()
        if s == 0:
            x = pl.embed(tokens)
        else:
            x = torch.empty(tokens.shape + (pl.hidden,), dtype=pl.dtype, device=device)
            collectives.exchange([], [(x, prv)])
        y = pl.core(x)
        if nxt is not None:
            collectives.exchange([(y, nxt)], [])
            flat = torch.zeros(4, device=device)
        else:
            sums = eval_metrics_fn(pl.head(y), labels, weights)
            flat = torch.stack([sums[key] for key in ("loss", "top1", "top5", "count")])
        collectives.all_reduce(flat, pipe_group)
        collectives.all_reduce(flat, data_group)
        count = flat[3]
        means = flat[:3] / torch.clamp(count, min=1.0)
        return {"loss": means[0], "top1": means[1], "top5": means[2], "count": count}

    return EvalStepFn(run, stage, device, pl)
