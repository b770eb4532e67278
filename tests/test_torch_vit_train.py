"""ViT training of the port against the JAX package's dp step (1-device
mesh) from the same weights, on the same batches, in f32.

* ``vit_s`` with 8-pixel patches at 32 px (17 tokens), ``attn_impl=
  "fused"`` and ``FUSED_DENSE_GRAD=1``: the JAX side runs the packed
  attention and dW+db Pallas kernels in interpret mode, the port their
  plain versions, through its ``TrainConfig``, ``create_optimizer``,
  ``create_train_state`` and ``make_train_step``;
* ``vit_ti16`` at 16 px (one patch and the cls token) with
  ``FUSED_DENSE_GRAD=1`` and ``xla`` attention, the JAX package's own
  flagged-step oracle (``tests/test_fused_grads.py``).

Two steps each (the second moves the momentum). Limits: loss, accuracy
and gradient norm within 1e-5 relative; the parameter updates within
2e-4 of their norm per parameter (plus 2**-23 of the parameter's norm,
its f32 resolution) and 2e-5 all together, the LM's limits
(``test_torch_lm_train.py``): the same f32 functions summed in other
orders.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.vit import FusedGradDense, ViT
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)

CLASSES, BATCH, STEPS_PER_EPOCH = 10, 4, 10
SETUPS = {
    # name: (variant, patch, image size, attn_impl)
    "vit_s-p8-32px-fused": ("s", 8, 32, "fused"),
    "vit_ti16-16px-xla": ("ti", 16, 16, "xla"),
}


def _cfg(size, impl, cls):
    return cls(model="vit", num_classes=CLASSES, image_size=size, batch_size_per_device=BATCH,
               compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl=impl)


def _data(size, n=2):
    ds = SyntheticImageDataset(length=BATCH * n, global_batch_size=BATCH, image_size=size,
                               num_classes=CLASSES, num_physical_batches=n, seed=3)
    return list(ds.epoch(0))[:n]


def run_jax(variant, patch, size, impl, data):
    """Initial params, metrics per step and final params of JAX's dp
    step."""
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.pipeline import shard_batch
    from distributeddeeplearning_tpu.models.vit import ViT as JaxViT
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import (
        create_optimizer as jax_opt,
        create_train_state as jax_state,
        make_train_step as jax_step,
    )
    from distributeddeeplearning_tpu.training.train_step import replicate_state

    cfg = _cfg(size, impl, JaxConfig)
    model = JaxViT(variant=variant, patch_size=patch, num_classes=CLASSES, dtype=jnp.float32,
                   attn_impl=impl)
    tx, _ = jax_opt(cfg, STEPS_PER_EPOCH, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, size, size, 3))
    init = jax.tree.map(np.asarray, fnn.unbox(state.params))
    mesh = create_mesh(devices=jax.devices()[:1])
    step = jax_step(model, tx, mesh, cfg, donate_state=False, check_vma=False)
    state = replicate_state(state, mesh)
    metrics = []
    for batch in data:
        state, m = step(state, shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.asarray, fnn.unbox(state.params))


def run_port(variant, patch, size, impl, params, data):
    cfg = _cfg(size, impl, TrainConfig)
    kw = dict(cfg.model_kwargs(), dtype=cfg.torch_dtype)
    model = ViT(variant=variant, patch_size=patch, **kw, device="cpu")
    assert all(isinstance(m, FusedGradDense) for m in (model.head, model.blocks[0].attn.qkv))
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.vit_params_from_flax(params))
    step = make_train_step(model, tx, cfg, device="cpu")
    metrics = []
    for batch in data:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == len(data)
    return metrics, convert.vit_params_to_flax(model.state_dict())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("setup", list(SETUPS))
def test_flagged_vit_dp_step_matches_jax_dp_step(setup, monkeypatch):
    monkeypatch.setenv("FUSED_DENSE_GRAD", "1")  # read where each Dense is built
    variant, patch, size, impl = SETUPS[setup]
    data = _data(size)
    init, want_metrics, want = run_jax(variant, patch, size, impl, data)
    got_metrics, got = run_port(variant, patch, size, impl, init, data)
    for w, g in zip(want_metrics, got_metrics):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    p0, pw, pg = dict(_leaves(init)), dict(_leaves(want)), dict(_leaves(got))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= 2e-4 * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= 2e-5 * np.sqrt(den)
