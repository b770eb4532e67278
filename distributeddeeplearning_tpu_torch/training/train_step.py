"""The data-parallel training step of the port: the JAX package's
``training/train_step.make_train_step`` (dp engine) on one process per
GPU.

Per step, on this rank's slice of the global batch (images and labels
for a ResNet; tokens ``[B, T]`` and next-token labels ``[B, T]`` for an
LM):

* forward in train mode, with per-replica BatchNorm (each rank
  normalises with its own batch statistics and moves its running stats;
  the LM has none);
* loss = f32 sparse softmax cross-entropy, the mean over examples (over
  the ``B·T`` tokens of an LM), label smoothing as the JAX
  package smooths (``on = 1 - ls``, ``off = ls / (V - 1)``, not
  ``F.cross_entropy``'s ``ls / V``), plus ``weight_decay · Σw²`` over
  the model's ``kernel_parameters()`` (conv and Dense kernels) only;
  accuracy is top-1 per example (per token);
* with a process group of more than one rank: one all-reduce **mean** of
  the gradients, the BatchNorm running statistics and the metrics
  ``{loss, accuracy}`` (``grad_norm`` is taken from the reduced
  gradients, so it is the same on every rank, as after JAX's ``pmean``).
  DDP is not used: its default ``broadcast_buffers`` copies rank 0's
  running stats instead of averaging them;
* the optimizer update at the schedule's pre-update count;
  ``state.step`` increments.

Metrics stay on the device (no host sync in the step).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.pipeline import normalize_staged_images, to_device
from distributeddeeplearning_tpu_torch.training.state import TrainState
from distributeddeeplearning_tpu_torch.utils.device import resolve_device


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean sparse softmax cross-entropy in f32 (``_sparse_ce_primal``):
    ``lse - picked``, or with smoothing ``lse - (on - off)·picked -
    off·Σlogits``."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        on = 1.0 - label_smoothing
        off = label_smoothing / (logits.shape[-1] - 1)
        per_example = lse - (on - off) * picked - off * logits.sum(-1)
    else:
        per_example = lse - picked
    return per_example.mean()


def l2_kernel_penalty(model, weight_decay: float) -> torch.Tensor:
    """``weight_decay · Σ w²`` over the conv and Dense kernels; biases and
    BN scales are exempt."""
    kernels = model.kernel_parameters()
    if weight_decay == 0.0:
        return torch.zeros((), device=kernels[0].device)
    return weight_decay * torch.stack([(w.float() * w.float()).sum() for w in kernels]).sum()


def _bn_buffers(model):
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(model, optimizer, config: Optional[TrainConfig] = None,
                    process_group=None, device=None) -> Callable:
    """``step(state, (inputs, labels)) -> (state, metrics)``: ``inputs``
    NHWC images (or ``[B, T]`` int tokens) and ``labels`` int, this
    rank's slice, as tensors on the model's device or numpy (staged with
    ``data.to_device``).
    ``metrics`` are 0-dim f32 tensors on the device: ``loss``,
    ``accuracy``, ``grad_norm``, means over the ranks.

    ``process_group=None`` takes the default group when
    ``torch.distributed`` is initialised. ``device`` (``None`` means
    CUDA, and raises without it) must hold the model."""
    cfg = config or TrainConfig()
    device = resolve_device(device)
    dist = torch.distributed
    if process_group is None and dist.is_available() and dist.is_initialized():
        process_group = dist.group.WORLD
    world = dist.get_world_size(process_group) if process_group is not None else 1
    params = [p for p in model.parameters()]
    if any(p.device.type != device.type or device.index not in (None, p.device.index)
           for p in params):
        raise ValueError(f"the model is not on {device}: create_train_state moves it there")
    buffers = _bn_buffers(model)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        inputs, labels = (to_device(batch, device) if not torch.is_tensor(batch[0])
                          else batch)
        inputs = normalize_staged_images(inputs)
        model.train()
        logits = model(inputs)
        loss = cross_entropy_loss(logits, labels, cfg.label_smoothing)
        loss = loss + l2_kernel_penalty(model, cfg.weight_decay)
        grads = list(torch.autograd.grad(loss, params))
        accuracy = (logits.argmax(-1) == labels.long()).float().mean()
        loss = loss.detach()
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
        optimizer.apply(params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "accuracy": accuracy, "grad_norm": grad_norm}

    return step
