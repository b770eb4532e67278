"""Training state of the port: the step count, the model (parameters
and, for a ResNet or an EfficientNet, BatchNorm running statistics) and
the optimizer state.

The JAX package's ``TrainState`` is an immutable pytree; here the model
holds the parameters and buffers, the step updates them in place, and
the state object carries the count and the optimizer's buffers beside
it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.efficientnet import EfficientNet
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.models.vit import ViT
from distributeddeeplearning_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_state: Dict
    # How a mesh engine's state lies across the ranks (the pjit and pp
    # engines' layouts: slices, stages); None when every rank holds it
    # whole. Checkpoints gather it to rank 0 and slice it on load.
    layout: Optional[Any] = None


def create_train_state(model, config: TrainConfig, tx, device=None,
                       state_dict=None) -> TrainState:
    """Deterministic seeded init on ``device`` (``None`` means CUDA, and
    raises without it): every rank that builds the same model from the
    same ``config.seed`` on the same kind of device holds the same
    parameters, which is the broadcast (as in the JAX package): an LM
    from ``convert.init_params``, a ViT from ``convert.init_vit_params``,
    an EfficientNet from ``convert.init_efficientnet_params``, a ResNet
    from ``convert.init_resnet_params``. A given ``state_dict``
    (e.g. converted from flax) is loaded instead. The optimizer state
    comes from ``tx.init`` with the model's kernels as its decay mask
    (AdamW's decoupled decay covers them, as the L2 penalty does)."""
    dev = resolve_device(device)
    model.to(dev)
    if state_dict is None:
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        if isinstance(model, TransformerLM):
            state_dict = convert.init_params(model.variant, model.vocab_size, gen,
                                             model.max_seq_len, model.moe_experts,
                                             model.moe_every, depth=model.depth)
        elif isinstance(model, ViT):
            state_dict = convert.init_vit_params(model.variant, model.patch_size,
                                                 model.num_classes, gen, model.image_size)
        elif isinstance(model, EfficientNet):
            state_dict = convert.init_efficientnet_params(model.variant, model.num_classes, gen)
        else:
            state_dict = convert.init_resnet_params(model.depth, model.num_classes, gen,
                                                    model.s2d_stem)
    model.load_state_dict(state_dict)
    params = list(model.parameters())
    kernels = {id(p) for p in model.kernel_parameters()}
    return TrainState(step=0, model=model,
                      opt_state=tx.init(params, [id(p) in kernels for p in params]))
