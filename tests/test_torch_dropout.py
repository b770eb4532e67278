"""Dropout in the port's ViT and LM against the JAX package's.

* One dp step (``make_train_step``, SGD at a constant 0.1, L2 5e-5, f32)
  of ``vit_ti16`` (32 px, ``dropout=0.1``) and of ``lm_moe_tiny`` (4
  experts, ``dropout=0.1``) against one JAX step (``value_and_grad`` of
  the dp step's loss, sown losses included, and JAX's optimizer update)
  from the same weights. flax runs with ``capture_intermediates``; each
  ``Dropout``'s keep mask is read as ``output != 0`` and handed to the
  port through its one mask function, ``efficientnet.keep_mask``,
  monkeypatched, in the order the port draws them (the LM's embedding
  mask first; then per block the attention's ``proj``, the MLP's GELU
  and ``fc2``; an MoE block has the first only). Loss within 1e-5
  relative, the updates within 1e-4 of their norm per parameter (plus
  2**-23 of the parameter's norm) and 1e-5 all together.
* The twin of JAX's ``test_vit_dropout_rng_varies_by_step``: the same
  state, step and batch give the same loss; the next step draws other
  masks; and the ranks' generators (``dropout_seed``) draw other masks.
* The eval step draws no mask.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import assert_updates_close

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, efficientnet, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.training.train_step import dropout_seed

VOCAB, SEQ, BATCH, SIZE, CLASSES = 64, 16, 4, 32, 10
BASE = dict(batch_size_per_device=BATCH, compute_dtype="float32", weight_decay=5e-5,
            base_lr=0.1, warmup_epochs=0, lr_schedule="constant")
MODELS = {
    "vit_ti16": dict(BASE, model="vit_ti16", num_classes=CLASSES, image_size=SIZE),
    "lm_moe_tiny": dict(BASE, model="lm_moe_tiny", num_classes=VOCAB, moe_experts=4),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(name, seed=0):
    rng = np.random.RandomState(seed)
    if name.startswith("vit"):
        return (rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32),
                rng.randint(0, CLASSES, size=(BATCH,)).astype(np.int32))
    rows = rng.randint(0, VOCAB, size=(BATCH, SEQ + 1)).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def _port_model(name, **kw):
    cfg = TrainConfig(**MODELS[name])
    extra = dict(max_seq_len=SEQ) if name.startswith("lm") else {}
    return cfg, get_model(cfg.model, **cfg.model_kwargs(), device="cpu", dropout=0.1,
                          **extra, **kw)


def _initial(name):
    gen = torch.Generator().manual_seed(11)
    if name.startswith("vit"):
        sd = convert.init_vit_params("ti", 16, CLASSES, gen, SIZE)
    else:
        sd = convert.init_params("tiny", VOCAB, gen, SEQ, 4)
    return sd, convert.params_to_flax(sd)


def _masks_in_port_order(name, inter):
    out = [np.asarray(inter["Dropout_0"]["__call__"][0]) != 0] if name.startswith("lm") else []
    depth = sum(k.startswith("block") for k in inter)
    for i in range(depth):
        block = inter[f"block{i}"]
        out.append(np.asarray(block["attn"]["Dropout_0"]["__call__"][0]) != 0)
        for j in range(2 if "mlp" in block else 0):
            out.append(np.asarray(block["mlp"][f"Dropout_{j}"]["__call__"][0]) != 0)
    return out


def run_jax(name, params, batch):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.training import create_optimizer as jax_optimizer
    from distributeddeeplearning_tpu.training.train_step import (
        cross_entropy_loss,
        l2_kernel_penalty,
        sown_aux_loss,
    )

    cfg = JaxConfig(**MODELS[name])
    extra = dict(max_seq_len=SEQ) if name.startswith("lm") else {}
    kw = cfg.model_kwargs()
    kw.pop("image_size", None)
    model = jax_get_model(cfg.model, **kw, dropout=0.1, **extra)
    tx, _ = jax_optimizer(cfg, 10, world_size=1)
    x, y = jnp.asarray(batch[0]), jnp.asarray(batch[1])

    @jax.jit
    def step(p0):
        def loss_fn(p):
            logits, mutated = model.apply(
                {"params": p}, x, train=True, rngs={"dropout": jax.random.PRNGKey(5)},
                mutable=["intermediates", "losses"],
                capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
            loss = (cross_entropy_loss(logits, y) + l2_kernel_penalty(p, cfg.weight_decay)
                    + sown_aux_loss(mutated))
            return loss, mutated["intermediates"]

        (loss, inter), grads = jax.value_and_grad(loss_fn, has_aux=True)(p0)
        updates, _ = tx.update(grads, tx.init(p0), p0)
        return loss, jax.tree.map(lambda a, u: a + u, p0, updates), inter

    loss, new, inter = step(params)
    return float(loss), jax.tree.map(np.asarray, new), _masks_in_port_order(name, inter)


def _feed(masks):
    queue = list(masks)

    def keep_mask(shape, keep, generator, device):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (tuple(shape), want.shape)
        return torch.from_numpy(want).to(device)

    return keep_mask, queue


@pytest.mark.parametrize("name", sorted(MODELS))
def test_step_with_flax_masks_matches_jax_step(name, monkeypatch):
    sd, params = _initial(name)
    batch = _batch(name)
    want_loss, want_params, masks = run_jax(name, params, batch)
    assert all(0 < m.mean() < 1 for m in masks)
    keep_mask, queue = _feed(masks)
    monkeypatch.setattr(efficientnet, "keep_mask", keep_mask)
    cfg, model = _port_model(name)
    assert model.stochastic
    tx, _ = create_optimizer(cfg, 10, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
    state, metrics = make_train_step(model, tx, cfg, device="cpu")(state, batch)
    assert not queue, f"{len(queue)} masks not drawn"
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)
    got = convert.params_to_flax(model.state_dict())
    assert_updates_close(params, want_params, got, per_leaf=1e-4, total=1e-5)


def test_dropout_rng_varies_by_step_and_rank(monkeypatch):
    cfg, model = _port_model("vit_ti16")
    cfg = cfg.replace(base_lr=0.0)  # the parameters never move, only the step
    sd, _ = _initial("vit_ti16")
    tx, _ = create_optimizer(cfg, 10, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
    step = make_train_step(model, tx, cfg, device="cpu")
    batch = _batch("vit_ti16")
    _, m1 = step(state, batch)
    state.step = 0
    _, m1b = step(state, batch)
    _, m2 = step(state, batch)
    assert float(m1["loss"]) == float(m1b["loss"])
    assert float(m1["loss"]) != float(m2["loss"])
    model.train()
    x = torch.from_numpy(batch[0])
    by_rank = [model(x, generator=torch.Generator().manual_seed(dropout_seed(42, 0, r)))
               for r in (0, 1)]
    assert not torch.equal(*by_rank)


def test_eval_draws_no_mask(monkeypatch):
    cfg, model = _port_model("lm_moe_tiny")
    sd, _ = _initial("lm_moe_tiny")
    tx, _ = create_optimizer(cfg, 10, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)

    def refuse(*a, **k):
        raise AssertionError("eval drew a dropout mask")

    monkeypatch.setattr(efficientnet, "keep_mask", refuse)
    out = make_eval_step(model, device="cpu")(state, _batch("lm_moe_tiny"))
    assert np.isfinite(float(out["loss"]))
