"""Shared set-up of the train-step parity tests: the JAX dp step and the
port's step on the same weights, config and batches (resnet50, 64 px,
10 classes, f32, 4 images per device, label smoothing 0.1, L2 5e-5, SGD
momentum 0.9, LR 0.01 per device).

The weights are the JAX model's own init (γ = 0 on each branch's last
BN): the first step moves those γ, the second step's gradients then
reach every parameter. Random γ at 2 images per device is a chaotic
start (a gradient norm of 3e4 and a loss of 263 after one step), where
f32 round-off alone moves the updates by 20 % and the comparison would
measure that, not the port."""

import jax
import jax.numpy as jnp
import numpy as np

SIZE, CLASSES, STEPS_PER_EPOCH = 64, 10, 10
CFG = dict(model="resnet50", num_classes=CLASSES, image_size=SIZE, batch_size_per_device=4,
           compute_dtype="float32", base_lr=0.01, label_smoothing=0.1, warmup_epochs=1)


def jax_initial_state(fused, world):
    """The JAX package's initial train state and dp step function over a
    ``world``-device CPU mesh."""
    from distributeddeeplearning_tpu.config import TrainConfig
    from distributeddeeplearning_tpu.models.resnet import ResNet
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )
    from distributeddeeplearning_tpu.training.train_step import replicate_state

    cfg = TrainConfig(**CFG)
    model = ResNet(depth=50, num_classes=CLASSES, dtype=jnp.float32, fused=fused)
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=world)
    state = create_train_state(model, cfg, tx, input_shape=(1, SIZE, SIZE, 3))
    mesh = create_mesh(devices=jax.devices()[:world])
    # check_vma=False: the interpreted Pallas call fails shard_map's
    # varying-axes check on the CPU (the fused model only).
    step = make_train_step(model, tx, mesh, cfg, donate_state=False, check_vma=False)
    return replicate_state(state, mesh), step, mesh


def batches(n, global_batch, seed=0):
    """``n`` global batches from the port's synthetic dataset (bitwise the
    JAX package's)."""
    from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset

    ds = SyntheticImageDataset(length=global_batch * n, global_batch_size=global_batch,
                               image_size=SIZE, num_classes=CLASSES, num_physical_batches=n,
                               seed=seed)
    return list(ds.epoch(0))[:n]


def run_jax(fused, world, data):
    """Metrics per step and the final (params, batch_stats), as numpy."""
    from distributeddeeplearning_tpu.data.pipeline import shard_batch

    state, step, mesh = jax_initial_state(fused, world)
    init = (jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats))
    metrics = []
    for batch in data:
        state, m = step(state, shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    final = (jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.batch_stats))
    return init, metrics, final


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_step_matches(init, want_metrics, want_final, got_metrics, got_final):
    """Metrics within 1e-4 (relative); the update (final - initial) of
    all parameters together within 0.5 % of its norm, and of each
    parameter within 3 % of its norm plus 2**-23 of the parameter's norm
    (an update below the parameter's f32 resolution is rounding, not
    signal); each running statistic within 1e-4 of its largest |value|.
    Measured, 1 and 2 ranks: metrics 1e-6, all updates 5e-4, the worst
    leaf above its resolution 1.1 %, running stats 4e-6. f32 round-off
    through a train-mode resnet50 at 4 images per device sets that floor
    (test_torch_resnet.py); the JAX package's own dp-equivalence test
    allows 5 % per leaf. A summed instead of averaged gradient moves the
    updates by 100 %, and rank 0's running statistics in place of the
    ranks' mean by far more than 1e-4."""
    for w, g in zip(want_metrics, got_metrics):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    p0 = dict(leaves(init[0]))
    pw, pg = dict(leaves(want_final[0])), dict(leaves(got_final[0]))
    assert pw.keys() == pg.keys()
    total = err = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= 0.03 * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        total, err = total + np.sum(dw * dw), err + e * e
    assert np.sqrt(err) <= 0.005 * np.sqrt(total)
    sw, sg = dict(leaves(want_final[1])), dict(leaves(got_final[1]))
    assert sw.keys() == sg.keys()
    for k in sw:
        np.testing.assert_allclose(sg[k], sw[k], rtol=0, atol=1e-4 * np.abs(sw[k]).max(),
                                   err_msg=k)


def assert_updates_close(init, want, got, per_leaf, total):
    """Each parameter's update (final - init, flax trees of numpy) within
    ``per_leaf`` of its norm plus 2**-23 of the parameter's norm (its f32
    resolution), and all updates together within ``total`` of theirs."""
    p0, pw, pg = dict(leaves(init)), dict(leaves(want)), dict(leaves(got))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= per_leaf * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= total * np.sqrt(den), np.sqrt(num / den)
