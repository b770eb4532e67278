"""AdamW of the port (``training/optimizer.AdamW``) against ``optax.adamw``.

* The twins of JAX's ``test_env_wiring`` and
  ``test_unknown_optimizer_and_schedule_rejected``, and of
  ``test_adamw_cosine_trains``: ``lm_tiny`` under AdamW with a cosine
  schedule and decoupled decay takes five steps on one batch with finite,
  falling losses.
* Six updates of a small tree (a Dense kernel and bias, a LayerNorm
  scale) from the same gradients against JAX's ``create_optimizer``
  (``optax.adamw`` with ``_kernel_mask``; cosine with warm-up), with and
  without ``GRAD_ACCUM_STEPS=2`` (``optax.MultiSteps``): parameters and
  moments within 1e-6 relative to their largest value after every call
  (measured 1.2e-7; the bias corrections ``1 - b**n`` are computed on the
  host in f64 and rounded, optax's in f32); only the kernel decays.
* ``fit`` with AdamW (``lm_moe_tiny``, ``DECOUPLED_WEIGHT_DECAY``),
  checkpointed every 3 steps, resumed from step 3, ends bit for bit the
  uninterrupted run; the saved optimizer state carries optax's
  ``ScaleByAdamState`` names (``count``, ``mu``, ``nu``).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import (
    AdamW,
    MultiSteps,
    create_optimizer,
    create_train_state,
    loop,
    make_train_step,
)

VOCAB, T = 32, 8
WORST = [0.0]  # the largest relative gap test_adamw_matches_optax saw


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_env_wiring():
    cfg = TrainConfig.from_env({"OPTIMIZER": "adamw", "LR_SCHEDULE": "cosine",
                                "GRAD_ACCUM_STEPS": "4", "WEIGHT_DECAY": "0",
                                "DECOUPLED_WEIGHT_DECAY": "0.1"})
    assert (cfg.optimizer, cfg.lr_schedule, cfg.grad_accum_steps) == ("adamw", "cosine", 4)
    assert cfg.weight_decay == 0.0 and cfg.decoupled_weight_decay == 0.1
    tx, _ = create_optimizer(cfg, 16)
    assert isinstance(tx, MultiSteps) and isinstance(tx.inner, AdamW)
    assert (tx.inner.b1, tx.inner.b2, tx.inner.eps) == (0.9, 0.95, 1e-8)


def test_unknown_optimizer_rejected():
    with pytest.raises(ValueError, match="unknown optimizer"):
        create_optimizer(TrainConfig(optimizer="lamb"), 10)
    with pytest.raises(ValueError, match="decay_mask"):
        AdamW(lambda n: 1e-3, weight_decay=0.1).init([torch.zeros(2)])


def test_adamw_cosine_trains():
    cfg = TrainConfig(optimizer="adamw", lr_schedule="cosine", base_lr=1e-3, warmup_epochs=0,
                      epochs=2, num_classes=VOCAB, weight_decay=0.0,
                      decoupled_weight_decay=0.01, batch_size_per_device=2,
                      compute_dtype="float32")
    model = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                      device="cpu")
    tx, _ = create_optimizer(cfg, steps_per_epoch=8, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu")
    step = make_train_step(model, tx, cfg, device="cpu")
    rows = np.random.RandomState(0).randint(0, VOCAB, size=(2, T + 1)).astype(np.int32)
    losses = []
    for _ in range(5):
        state, m = step(state, (rows[:, :-1], rows[:, 1:]))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_matches_optax(accum):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training.optimizer import create_optimizer as jax_opt

    kw = dict(optimizer="adamw", lr_schedule="cosine", base_lr=3e-2, warmup_epochs=1,
              epochs=3, decoupled_weight_decay=0.1, grad_accum_steps=accum)
    rng = np.random.RandomState(accum)
    tree = {"dense": {"kernel": rng.randn(8, 4).astype(np.float32),
                      "bias": rng.randn(4).astype(np.float32)},
            "ln": {"scale": rng.randn(4).astype(np.float32)}}
    names = [("dense", "kernel"), ("dense", "bias"), ("ln", "scale")]
    jtx, _ = jax_opt(JaxConfig(**kw), steps_per_epoch=4, world_size=1)
    tx, _ = create_optimizer(TrainConfig(**kw), steps_per_epoch=4, world_size=1)
    params = [torch.from_numpy(tree[a][b].copy()) for a, b in names]
    state = tx.init(params, [b == "kernel" for _, b in names])
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtx.init(jparams)
    update = jax.jit(jtx.update)
    for _ in range(6):
        grads = {a: {b: rng.randn(*tree[a][b].shape).astype(np.float32) for b in tree[a]}
                 for a in tree}
        ups, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, ups)
        tx.apply(params, [torch.from_numpy(grads[a][b]) for a, b in names], state)
        adam = (jstate.inner_opt_state if accum > 1 else jstate)[0]
        inner = state["inner"] if accum > 1 else state
        assert int(adam.count) == inner["count"]
        for i, (a, b) in enumerate(names):
            for want, got in ((jparams[a][b], params[i]), (adam.mu[a][b], inner["mu"][i]),
                              (adam.nu[a][b], inner["nu"][i])):
                want = np.asarray(want)
                gap = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
                WORST[0] = max(WORST[0], gap)
                assert gap <= 1e-6, (f"{a}/{b}", gap)
    assert (tx.inner if accum > 1 else tx).decay_index == [0]  # the kernel only


def _fit(**kw):
    cfg = TrainConfig(model="lm_moe_tiny", num_classes=VOCAB, batch_size_per_device=2,
                      fake_data_length=8, epochs=2, compute_dtype="float32", weight_decay=0.0,
                      optimizer="adamw", decoupled_weight_decay=0.1, base_lr=1e-3,
                      moe_experts=4, log_every_steps=0, **kw)
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=T,
                                 vocab_size=VOCAB)
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=T, device="cpu")
    return loop.fit(model, cfg, data, device="cpu", add_default_logger=False)


def test_adamw_midepoch_resume_is_bitwise(tmp_path):
    ref = _fit()
    ckpt_dir = str(tmp_path / "ckpt")
    kw = dict(model_dir=ckpt_dir, checkpoint_every_steps=3, checkpoint_async=False,
              checkpoint_keep=10)
    _fit(**kw)
    saved = torch.load(os.path.join(ckpt_dir, "3", "state.pt"), weights_only=False)
    assert set(saved["opt"]) == {"count", "mu", "nu"} and saved["opt"]["count"] == 3
    for s in faults.checkpoint_steps(ckpt_dir):
        if s > 3:
            shutil.rmtree(os.path.join(ckpt_dir, str(s)))
    resumed = _fit(**kw)
    assert resumed.state.step == ref.state.step == 8
    want, got = ref.state.model.state_dict(), resumed.state.model.state_dict()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for name in ("mu", "nu"):
        for a, b in zip(ref.state.opt_state[name], resumed.state.opt_state[name]):
            assert torch.equal(a, b)
    assert ref.state.opt_state["count"] == resumed.state.opt_state["count"] == 8
    assert ref.history[-1]["loss"] == resumed.history[-1]["loss"]


def test_update_reads_only_the_device_scalars():
    """The device part reads the rate and both bias corrections from the
    scalars ``prepare`` wrote, never the host count: a captured update
    replays them as they stand. Moving the count after ``prepare``
    leaves the update as it was."""
    torch.manual_seed(0)
    params = [torch.randn(4, 3), torch.randn(3)]
    grads = [torch.randn(4, 3), torch.randn(3)]
    results = []
    for poke in (False, True):
        tx = AdamW(lambda n: 1e-2 * (n + 1), weight_decay=0.1)
        ps = [p.clone() for p in params]
        state = tx.init(ps, [True, False])
        for _ in range(3):
            tx.prepare(state)
            if poke:
                state["count"] += 100
            tx.update(ps, grads, state)
            if poke:
                state["count"] -= 100
        results.append(ps)
    for a, b in zip(*results):
        assert torch.equal(a, b)
    s = tx.scalars("cpu")
    assert torch.allclose(s, torch.tensor([-3e-2, 1 - 0.9 ** 3, 1 - 0.95 ** 3]))
