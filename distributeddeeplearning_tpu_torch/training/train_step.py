"""The data-parallel training step of the port: the JAX package's
``training/train_step.make_train_step`` (dp engine) on one process per
GPU.

Per step, on this rank's slice of the global batch (images and labels
for a ResNet; tokens ``[B, T]`` and next-token labels ``[B, T]`` for an
LM):

* forward in train mode, with per-replica BatchNorm (each rank
  normalises with its own batch statistics and moves its running stats;
  the LM has none); a model whose training forward draws dropout noise
  (``model.stochastic``: EfficientNet's drop-path and head dropout) gets
  ``generator=``, a ``torch.Generator`` on the device seeded from
  ``(config.seed, state.step, rank)`` (:func:`dropout_seed`), so every
  step and every rank draws its own noise, as the JAX step's
  ``fold_in(fold_in(PRNGKey(seed), step), device)`` key does (the bits
  differ: same distributions, other numbers);
* loss = f32 softmax cross-entropy on sparse or one-hot labels, the
  mean over examples (over the ``B·T`` tokens of an LM), label
  smoothing as the JAX package smooths (``on = 1 - ls``, ``off = ls /
  (V - 1)``, not ``F.cross_entropy``'s ``ls / V``), plus ``weight_decay
  · Σw²`` over the model's ``kernel_parameters()`` (conv and Dense
  kernels) only; accuracy is top-1 per example (per token), against the
  argmax of one-hot labels;
* with a process group of more than one rank: one all-reduce **mean** of
  the gradients, the BatchNorm running statistics and the metrics
  ``{loss, accuracy}`` (``grad_norm`` is taken from the reduced
  gradients, so it is the same on every rank, as after JAX's ``pmean``).
  DDP is not used: its default ``broadcast_buffers`` copies rank 0's
  running stats instead of averaging them;
* the optimizer update at the schedule's pre-update count;
  ``state.step`` increments.

``ACCUM_STEPS=k`` runs the batch as k microbatches (``training/accum.py``:
ghost BatchNorm, f32 gradient sums, the all-reduce once on the mean).
:func:`make_eval_step` is the JAX eval step: running-statistics
BatchNorm, weighted ``{loss, top1, top5, count}`` summed over the ranks.

Metrics stay on the device (no host sync in the step).

The step is split at the host/device boundary (``metrics.StepParts``),
so that its device part can be captured as a CUDA graph
(``metrics.StepFn.aot_compile``): the host part seeds the dropout
generators from ``(seed, step, rank)`` and runs the optimizer's host
part; the device part is the forward, backward, all-reduce and the
optimizer's device part; the last host part advances ``state.step``.
Under ``ACCUM_STEPS = k`` each microbatch draws from a generator of its
own, seeded with its index folded in, so that no generator is reseeded
inside the device part.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.pipeline import normalize_staged_images, to_device
from distributeddeeplearning_tpu_torch.training import accum
from distributeddeeplearning_tpu_torch.training.metrics import EvalStepFn, StepFn, StepParts
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.utils.device import resolve_device


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean softmax cross-entropy in f32. Sparse labels (the logits'
    rank minus one; ``_sparse_ce_primal``): ``lse - picked``, or with
    smoothing ``lse - (on - off)·picked - off·Σlogits``. One-hot labels
    (float, the logits' rank: Keras' ``categorical_crossentropy``, JAX
    ``train_step.py:107-129``): targets smoothed to ``t·(on - off) +
    off``, then ``-mean(Σ targets · log_softmax(logits))``."""
    num_classes = logits.shape[-1]
    logits = logits.float()
    if labels.dim() == logits.dim():  # one-hot
        targets = labels.float()
        if label_smoothing > 0.0:
            on = 1.0 - label_smoothing
            off = label_smoothing / (num_classes - 1)
            targets = targets * (on - off) + off
        return -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    logits = logits.reshape(-1, num_classes)
    labels = labels.reshape(-1).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        on = 1.0 - label_smoothing
        off = label_smoothing / (num_classes - 1)
        per_example = lse - (on - off) * picked - off * logits.sum(-1)
    else:
        per_example = lse - picked
    return per_example.mean()


def hard_labels(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Class indices: one-hot labels (the logits' rank) by their argmax,
    sparse ones as they are."""
    return labels.argmax(-1) if labels.dim() == logits.dim() else labels.long()


def l2_kernel_penalty(model, weight_decay: float) -> torch.Tensor:
    """``weight_decay · Σ w²`` over the conv and Dense kernels; biases and
    BN scales are exempt."""
    kernels = model.kernel_parameters()
    if weight_decay == 0.0:
        return torch.zeros((), device=kernels[0].device)
    return weight_decay * torch.stack([(w.float() * w.float()).sum() for w in kernels]).sum()


def dropout_seed(seed: int, step: int, rank: int, micro: Optional[int] = None) -> int:
    """The seed of one step's dropout generator on one rank: a 63-bit
    hash of ``(seed, step, rank)``, computed on the host (no device
    sync). Under ``ACCUM_STEPS > 1`` the microbatch index ``micro`` is
    folded in as well (JAX folds it into the step's key); with one
    microbatch the seed is the unaccumulated step's."""
    key = f"{seed}/{step}/{rank}" + ("" if micro is None else f"/{micro}")
    digest = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _bn_buffers(model):
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(model, optimizer, config: Optional[TrainConfig] = None,
                    process_group=None, device=None) -> StepFn:
    """``step(state, (inputs, labels)) -> (state, metrics)``, and
    ``step(state, batch, acc) -> (state, metrics, acc)`` with the
    on-device metric accumulator (``training/metrics.StepFn``):
    ``inputs`` NHWC images (or ``[B, T]`` int tokens) and ``labels``
    int (or one-hot float, of the logits' rank), this rank's slice, as
    tensors on the model's device or numpy (staged with
    ``data.to_device``).
    ``metrics`` are 0-dim f32 tensors on the device: ``loss``,
    ``accuracy``, ``grad_norm``, means over the ranks.

    ``config.accum_steps = k > 1`` runs the batch as k microbatches
    through ``training/accum.accumulate_microbatches`` (ghost BatchNorm,
    f32 gradient sums, one all-reduce on the mean); the step's
    ``accum_steps`` attribute says k.

    ``process_group=None`` takes the default group when
    ``torch.distributed`` is initialised. ``device`` (``None`` means
    CUDA, and raises without it) must hold the model."""
    cfg = config or TrainConfig()
    device = resolve_device(device)
    dist = torch.distributed
    if process_group is None and dist.is_available() and dist.is_initialized():
        process_group = dist.group.WORLD
    world = dist.get_world_size(process_group) if process_group is not None else 1
    rank = dist.get_rank(process_group) if process_group is not None else 0
    k = accum.validate_accum_config(cfg, world)
    params = [p for p in model.parameters()]
    if any(p.device.type != device.type or device.index not in (None, p.device.index)
           for p in params):
        raise ValueError(f"the model is not on {device}: create_train_state moves it there")
    buffers = _bn_buffers(model)
    stochastic = getattr(model, "stochastic", False)
    generators = ([torch.Generator(device=device) for _ in range(k)] if stochastic else [])
    if not hasattr(optimizer, "prepare"):
        raise TypeError(f"{type(optimizer).__name__} has no prepare/update split: "
                        "use training.optimizer's MomentumSGD or MultiSteps")

    def grads_and_metrics(inputs, labels, generator=None):
        """One forward and backward (of one microbatch): the raw
        gradients and the f32 ``loss`` (with L2) and ``accuracy``."""
        inputs = normalize_staged_images(inputs)
        logits = model(inputs) if generator is None else model(inputs, generator=generator)
        loss = cross_entropy_loss(logits, labels, cfg.label_smoothing)
        loss = loss + l2_kernel_penalty(model, cfg.weight_decay)
        grads = list(torch.autograd.grad(loss, params))
        accuracy = (logits.argmax(-1) == hard_labels(logits, labels)).float().mean()
        return grads, {"loss": loss.detach(), "accuracy": accuracy}

    def prepare(state: TrainState):
        """The host part before the device work: the generators seeded
        for ``(seed, state.step, rank)``, the optimizer's host part."""
        for idx, gen in enumerate(generators):
            gen.manual_seed(dropout_seed(cfg.seed, state.step, rank, idx if k > 1 else None))
        return optimizer.prepare(state.opt_state)

    def run(state: TrainState, tensors, token) -> Dict[str, torch.Tensor]:
        """The device part: no host sync, no host state read but the
        token."""
        inputs, labels = tensors
        model.train()
        if k == 1:
            grads, m = grads_and_metrics(inputs, labels, generators[0] if generators else None)
        else:
            grads, m = accum.accumulate_microbatches(
                lambda mb, idx: grads_and_metrics(*mb, generators[idx] if generators else None),
                (inputs, labels), k, params)
        loss, accuracy = m["loss"], m["accuracy"]
        if world > 1:
            # One all-reduce for the gradients, the running stats and the
            # metrics: the JAX step's pmean of each (sum, then / world).
            flat = torch.cat([t.reshape(-1) for t in grads + buffers]
                             + [loss.reshape(1), accuracy.reshape(1)])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=process_group)
            flat /= world
            pieces = torch.split(flat, [t.numel() for t in grads + buffers] + [1, 1])
            grads = [p.view_as(g) for p, g in zip(pieces, grads)]
            with torch.no_grad():
                for b, p in zip(buffers, pieces[len(grads):]):
                    b.copy_(p.view_as(b))
            loss, accuracy = pieces[-2][0], pieces[-1][0]
        grad_norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        optimizer.update(params, grads, state.opt_state, token)
        return {"loss": loss, "accuracy": accuracy, "grad_norm": grad_norm}

    def finish(state: TrainState) -> None:
        state.step += 1

    def stage(batch):
        return to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)

    parts = StepParts(prepare=prepare, run=run, finish=finish,
                      phase=lambda state: optimizer.phase(state.opt_state),
                      phases=getattr(optimizer, "phases", 1), generators=generators,
                      stage=stage, device=device, model=model)

    return StepFn(parts, accum_steps=k)


def eval_metrics_fn(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Weighted metric sums of one batch (JAX ``eval_metrics_fn``):
    ``weights`` in {0, 1} mark real against padded samples; token
    models' ``[B, T, V]`` logits count per token, each sample's weight
    on all its tokens. f32 throughout. ``top5`` counts a label among
    the five largest logits (``torch.topk``; on an exact tie at the
    fifth place the kept index may differ from JAX's ``argsort``).
    One-hot labels (the logits' rank) give the CE term directly and
    their argmax to top-k (JAX ``train_step.py:484-511``)."""
    one_hot = labels.dim() == logits.dim()
    logits = logits.float()
    if logits.dim() == 3:
        b, t, v = logits.shape
        logits = logits.reshape(b * t, v)
        labels = labels.reshape((b * t, v) if one_hot else (b * t,))
        weights = weights.repeat_interleave(t)
    w = weights.float()
    logp = torch.log_softmax(logits, dim=-1)
    if one_hot:
        per_ex = -(labels.float() * logp).sum(-1)
        labels = labels.argmax(-1)
    else:
        labels = labels.long()
        per_ex = -logp.gather(1, labels[:, None])[:, 0]
    top1 = (logits.argmax(-1) == labels).float()
    top5 = (logits.topk(min(5, logits.shape[-1]), dim=-1).indices
            == labels[:, None]).any(-1).float()
    return {"loss": (per_ex * w).sum(), "top1": (top1 * w).sum(),
            "top5": (top5 * w).sum(), "count": w.sum()}


def make_eval_step(model, process_group=None, device=None) -> "EvalStepFn":
    """``eval_step(state, batch) -> {loss, top1, top5, count}`` (JAX
    ``make_eval_step``): running-statistics BatchNorm (eval mode), the
    batch's weighted sums summed over the ranks (one all-reduce), then
    the per-batch means and ``count``, the number of real samples.
    Takes ``(inputs, labels)`` (every sample real, one process only) or
    ``(inputs, labels, weights)`` from an exact dataset. The returned
    :class:`~.metrics.EvalStepFn` can capture itself as a CUDA graph
    (``aot_compile``)."""
    device = resolve_device(device)
    dist = torch.distributed
    if process_group is None and dist.is_available() and dist.is_initialized():
        process_group = dist.group.WORLD
    world = dist.get_world_size(process_group) if process_group is not None else 1

    def stage(batch):
        return to_device(batch, device) if not torch.is_tensor(batch[0]) else tuple(batch)

    @torch.no_grad()
    def run(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        if len(batch) == 2:
            if world > 1:
                raise ValueError("multi-process eval requires (inputs, labels, weights) "
                                 "batches: use an exact eval dataset (train=False)")
            inputs, labels = batch
            weights = torch.ones(labels.shape[:1], dtype=torch.float32, device=labels.device)
        else:
            inputs, labels, weights = batch
        model.eval()
        logits = model(normalize_staged_images(inputs))
        sums = eval_metrics_fn(logits, labels, weights)
        keys = ("loss", "top1", "top5", "count")
        flat = torch.stack([sums[key] for key in keys])
        if world > 1:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=process_group)
        count = flat[3]
        means = flat[:3] / torch.clamp(count, min=1.0)  # an all-padding batch
        return {"loss": means[0], "top1": means[1], "top5": means[2], "count": count}

    return EvalStepFn(run, stage, device, model)
