"""EfficientNet training of the port against the JAX package's.

* One port dp step (``TrainConfig``, ``create_optimizer``,
  ``create_train_state``, ``make_train_step``) against one JAX step
  (``value_and_grad`` of the dp step's loss, ``cross_entropy_loss`` +
  ``l2_kernel_penalty``, and the JAX ``create_optimizer``'s update; no
  mesh, to keep the compile short): ``efficientnet_b0``, f32, 32 px,
  batch 4, 10 classes, L2 5e-5, SGD at a constant 0.1, from the same
  weights (the port's seeded init, converted). Dropout parity is held
  here, not in the model: flax runs with ``capture_intermediates``, each
  ``Dropout`` module's keep mask is read as ``output != 0`` (the
  drop-path masks per sample, the head mask per element), and the port
  draws those masks through its one mask function,
  ``efficientnet.keep_mask``, monkeypatched. Loss within 1e-5 relative;
  each updated parameter and running statistic within 2e-3 of its
  largest |value| (``test_torch_resnet.py``'s train-mode limit) plus
  1e-6, and the updates all together within 1e-3 of their norm. The
  1e-6 is for leaves that are zero in exact arithmetic, where both sides
  hold f32 round-off of order 1e-7: a BN β whose output the next BN
  re-centres, a running mean of a 1x1 conv over a zero-mean input.
  Measured: updates within 2.7e-4 of their own size per leaf, 1.6e-4 all
  together.
* The port's own draws at a large batch: the keep rate within 5 sigma
  of its binomial mean, kept values scaled by exactly 1/keep, drop-path
  one mask per sample.
* Two ranks in a gloo world (``_torch_dp_worker.py``): identical
  parameters and running statistics after two steps, while the ranks'
  masks differ; the step's generator seed differs by step and by rank.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, efficientnet, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.training.train_step import dropout_seed

ROOT = Path(__file__).resolve().parent.parent
CLASSES, SIZE, BATCH, STEPS_PER_EPOCH = 10, 32, 4, 10
CFG = dict(model="efficientnet_b0", num_classes=CLASSES, image_size=SIZE,
           batch_size_per_device=BATCH, compute_dtype="float32", weight_decay=5e-5,
           base_lr=0.1, warmup_epochs=0, lr_schedule="constant")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batch(seed=0, n=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, SIZE, SIZE, 3).astype(np.float32),
            rng.randint(0, CLASSES, size=(n,)).astype(np.int32))


def _initial_state():
    sd = convert.init_efficientnet_params("b0", CLASSES, torch.Generator().manual_seed(11))
    return sd, convert.efficientnet_params_to_flax(sd)


def _block_key(name):
    stage, block = name[len("stage"):].split("_block")
    return int(stage), int(block)


def run_jax(params, stats, images, labels):
    """One JAX step; returns (loss, new params, new batch_stats, the keep
    masks in the order the model draws them)."""
    import flax.linen as fnn
    import optax

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
    from distributeddeeplearning_tpu.training import create_optimizer as jax_optimizer
    from distributeddeeplearning_tpu.training.train_step import (
        cross_entropy_loss,
        l2_kernel_penalty,
    )

    cfg = JaxConfig(**CFG)
    model = JaxEfficientNet(variant="b0", num_classes=CLASSES, dtype=jnp.float32)
    tx, _ = jax_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    x, y = jnp.asarray(images), jnp.asarray(labels)

    @jax.jit
    def step(params):
        def loss_fn(p):
            logits, mutated = model.apply(
                {"params": p, "batch_stats": stats}, x, train=True, rngs=rngs,
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
            loss = cross_entropy_loss(logits, y) + l2_kernel_penalty(p, cfg.weight_decay)
            return loss, (mutated["batch_stats"], mutated["intermediates"])

        (loss, (new_stats, inter)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, optax.apply_updates(params, updates), new_stats, inter

    loss, new_params, new_stats, inter = step(params)
    masks = []
    for name in sorted((k for k in inter if k.startswith("stage")), key=_block_key):
        out = np.asarray(inter[name]["Dropout_0"]["__call__"][0])
        masks.append((out.reshape(out.shape[0], -1) != 0).any(1).reshape(-1, 1, 1, 1))
    masks.append(np.asarray(inter["Dropout_0"]["__call__"][0]) != 0)
    return (float(loss), jax.tree.map(np.asarray, new_params),
            jax.tree.map(np.asarray, new_stats), masks)


def _feed(masks):
    """A ``keep_mask`` that hands out ``masks`` in order."""
    queue = list(masks)

    def keep_mask(shape, keep, generator, device):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (tuple(shape), want.shape)
        return torch.from_numpy(want).to(device)

    return keep_mask, queue


def test_dp_step_with_flax_masks_matches_jax_step(monkeypatch):
    sd, (params, stats) = _initial_state()
    images, labels = _batch()
    want_loss, want_params, want_stats, masks = run_jax(params, stats, images, labels)
    # b0: drop-path on the 9 residual blocks after the first (rate > 0), then the head
    assert len(masks) == 10 and all(m.shape == (BATCH, 1, 1, 1) for m in masks[:-1])
    assert masks[-1].shape == (BATCH, 1280) and 0 < masks[-1].mean() < 1

    keep_mask, queue = _feed(masks)
    monkeypatch.setattr(efficientnet, "keep_mask", keep_mask)
    cfg = TrainConfig(**CFG)
    model = get_model(cfg.model, **cfg.model_kwargs(), device="cpu")
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
    state, metrics = make_train_step(model, tx, cfg, device="cpu")(state, (images, labels))
    assert not queue, f"{len(queue)} masks not drawn"
    assert state.step == 1
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5 * abs(want_loss)

    got_params, got_stats = convert.efficientnet_params_to_flax(model.state_dict())
    p0 = dict(_leaves(params))
    for want, got in ((want_params, got_params), (want_stats, got_stats)):
        w, g = dict(_leaves(want)), dict(_leaves(got))
        assert w.keys() == g.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0,
                                       atol=2e-3 * np.abs(w[k]).max() + 1e-6, err_msg=k)
    w, g = dict(_leaves(want_params)), dict(_leaves(got_params))
    num = sum(np.sum((g[k] - w[k]) ** 2) for k in w)
    den = sum(np.sum((w[k] - p0[k]) ** 2) for k in w)
    assert den > 0 and np.sqrt(num) <= 1e-3 * np.sqrt(den), np.sqrt(num / den)


def test_port_draws_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(3)
    n, rate = 200_000, 0.3
    keep = 1.0 - rate
    y = efficientnet.dropout(torch.ones(n, 2, 2, 2), rate, gen, (n, 1, 1, 1))
    per_sample = y.reshape(n, -1)
    assert ((per_sample == per_sample[:, :1]).all())  # one mask per sample
    kept = per_sample[:, 0] != 0
    assert torch.equal(per_sample[kept, 0], torch.full((int(kept.sum()),), 1.0 / keep))
    assert abs(kept.float().mean().item() - keep) <= 5 * np.sqrt(keep * rate / n)
    head = efficientnet.dropout(torch.ones(500, 400), 0.4, gen, (500, 400))
    kept = head != 0
    assert torch.equal(head[kept], torch.full((int(kept.sum()),), 1.0 / 0.6))
    assert abs(kept.float().mean().item() - 0.6) <= 5 * np.sqrt(0.6 * 0.4 / head.numel())


def test_dropout_seed_differs_by_step_and_rank():
    seeds = {dropout_seed(42, step, rank) for step in range(50) for rank in range(8)}
    assert len(seeds) == 400 and all(0 <= s < 2 ** 63 for s in seeds)
    assert dropout_seed(42, 3, 1) == dropout_seed(42, 3, 1)


def test_step_draws_reproducible_fresh_noise(monkeypatch):
    """The same seed and step draw the same masks; the next step others."""
    drawn = []
    real = efficientnet.keep_mask

    def record(shape, keep, generator, device):
        m = real(shape, keep, generator, device)
        drawn.append(m.clone())
        return m

    monkeypatch.setattr(efficientnet, "keep_mask", record)
    cfg = TrainConfig(**CFG)
    sd, _ = _initial_state()
    runs = []
    for _ in range(2):
        model = get_model(cfg.model, **cfg.model_kwargs(), device="cpu")
        tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
        state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
        step = make_train_step(model, tx, cfg, device="cpu")
        drawn.clear()
        for _ in range(2):
            state, _ = step(state, _batch())
        runs.append(list(drawn))
    assert len(runs[0]) == 20
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0][:10], runs[0][10:]))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_ranks_draw_apart_and_stay_in_sync(tmp_path):
    world = 2
    sd, _ = _initial_state()
    payload = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    payload.update({f"cfg/{k}": np.asarray(v) for k, v in CFG.items()})
    payload["steps_per_epoch"] = np.asarray(STEPS_PER_EPOCH)
    for i in range(2):
        payload[f"images{i}"], payload[f"labels{i}"] = _batch(seed=i, n=world * BATCH)
    path_in, path_out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(path_in, **payload)
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"), str(r), str(world),
         str(port), "0", str(path_in), str(path_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = [np.load(tmp_path / f"out_rank{r}.npz") for r in range(world)]
    sd_keys = [k for k in outs[0] if k.startswith("sd/")]
    assert len(sd_keys) == len(sd)
    for k in sd_keys:  # all-reduced gradients and running statistics
        np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
        assert not np.array_equal(outs[0][k], payload[k]) or k.endswith("num_batches_tracked")
    mask_keys = sorted(k for k in outs[0] if k.startswith("mask"))
    assert len(mask_keys) == 20
    # the head's 4 x 1280 masks (steps 1 and 2) and the drop-path masks
    # (most keep all 4 samples: their keep rates are 0.99 to 0.81)
    for k in ("mask009", "mask019"):
        assert outs[0][k].shape == (BATCH, 1280)
        assert not np.array_equal(outs[0][k], outs[1][k]), k
    path = [k for k in mask_keys if k not in ("mask009", "mask019")]
    assert not all(np.array_equal(outs[0][k], outs[1][k]) for k in path)
