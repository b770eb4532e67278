"""One process: the port's unfused ResNet-50 train step against the JAX
package's dp step on a 1-device CPU mesh (``test_torch_train_step_fused.py``
holds the fused one), from the same weights over two batches (so the momentum trace and the schedule's
second count are exercised too). Tolerances: ``_torch_train_common.
assert_step_matches``.

One fused and one unfused bf16 step on the card, from the same weights
and batch, are held together by ``test_torch_cuda.py`` and
``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from _torch_train_common import CFG, STEPS_PER_EPOCH, assert_step_matches, batches, run_jax
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)


def run_port(fused, init, data, device="cpu"):
    cfg = TrainConfig(**CFG)
    model = get_model("resnet50", num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      fused=fused, device=device)
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    state = create_train_state(model, cfg, tx, device=device,
                               state_dict=convert.resnet_params_from_flax(*init))
    step = make_train_step(model, tx, cfg, device=device)
    metrics = []
    for batch in data:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == len(data)
    return metrics, convert.resnet_params_to_flax(model.state_dict())


def test_unfused_train_step_matches_jax_dp_step():
    data = batches(2, global_batch=CFG["batch_size_per_device"])
    init, want_metrics, want_final = run_jax(False, 1, data)
    got_metrics, got_final = run_port(False, init, data)
    assert_step_matches(init, want_metrics, want_final, got_metrics, got_final)


def test_loss_is_jax_label_smoothing_and_kernel_l2():
    from distributeddeeplearning_tpu.training.train_step import cross_entropy_loss as jce
    from distributeddeeplearning_tpu_torch.training import cross_entropy_loss

    rng = np.random.RandomState(0)
    logits = rng.randn(6, 10).astype(np.float32) * 3
    labels = rng.randint(0, 10, size=6).astype(np.int32)
    for ls in (0.0, 0.1):
        want = float(jce(logits, labels, ls))
        got = float(cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), ls))
        assert abs(got - want) <= 1e-6 * abs(want)
    smoothed = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long(), label_smoothing=0.1)
    assert abs(float(smoothed) - float(jce(logits, labels, 0.1))) > 1e-4

    # L2 over the conv and Dense kernels only (BN scales, biases exempt),
    # on the flax tree of the same weights (BN scales made nonzero, so
    # counting them would show)
    from distributeddeeplearning_tpu.training.train_step import l2_kernel_penalty as jl2
    from distributeddeeplearning_tpu_torch.training import l2_kernel_penalty

    sd = convert.init_resnet_params(18, 10, torch.Generator().manual_seed(0))
    sd = {k: (v + 3.0 if k.endswith("weight") and v.dim() == 1 else v) for k, v in sd.items()}
    model = get_model("resnet18", num_classes=10, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)
    params, _ = convert.resnet_params_to_flax(sd)
    with torch.no_grad():
        for wd in (5e-5, 0.0):
            want = float(jl2(params, wd))
            assert abs(float(l2_kernel_penalty(model, wd)) - want) <= 1e-6 * max(want, 1e-30)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    cfg = TrainConfig(**CFG)
    model = get_model("resnet50", num_classes=10, device="cpu")
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(model, cfg, tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, tx, cfg)
