"""The port's three API front-ends (``frontends/``): twins of
``tests/test_frontends.py`` on the CPU (ResNet-18, 32 px, f32, 2 images
a step), and the port held to the JAX package:

* the explicit front-end's epoch (ResNet-18 at 64 px, 4 images a step,
  label smoothing 0.1, from JAX's own init) against JAX's
  ``explicit.train_epoch`` on a 1-device mesh, within
  ``_torch_train_common.assert_step_matches``'s limits;
* the one-hot loss and its gradient (``[B, C]`` and ``[B, T, V]``, with
  and without smoothing) against JAX's ``cross_entropy_loss`` and
  ``jax.grad`` of it, within 1e-6 relative (f32 round-off; measured
  about 1e-7);
* one-hot eval sums against JAX's ``eval_metrics_fn`` (padded samples
  weighted out), within 1e-5 relative (the CE sum of 6 samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
from distributeddeeplearning_tpu_torch.frontends import Estimator, Model, RunConfig, explicit
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training.callbacks import (
    BroadcastGlobalVariablesCallback,
    LearningRateScheduleCallback,
    LearningRateWarmupCallback,
    LoggerCallback,
    MetricAverageCallback,
    ModelCheckpointCallback,
)
from distributeddeeplearning_tpu_torch.training.train_step import (
    cross_entropy_loss,
    eval_metrics_fn,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = TrainConfig(num_classes=10, image_size=32, batch_size_per_device=2, epochs=1,
                  fake_data_length=16, compute_dtype="float32", log_every_steps=2,
                  validation=True)
RUN = RunConfig(device="cpu")


def _model(cfg=CFG):
    return get_model("resnet18", num_classes=10, dtype=cfg.compute_dtype, device="cpu")


def _data(cfg, length=None, **kw):
    return SyntheticImageDataset(length=length or cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size,
                                 image_size=cfg.image_size, num_classes=cfg.num_classes,
                                 num_physical_batches=2, seed=cfg.seed, **kw)


def test_estimator_frontend():
    est = Estimator(lambda cfg: _model(), CFG, RUN)
    est.train(_data, epochs=1)
    assert est.state.step == 8  # 16 / 2
    metrics = est.evaluate(lambda cfg: _data(cfg, length=8))
    assert np.isfinite(metrics["loss"]) and "top1" in metrics


def test_estimator_by_name():
    est = Estimator("resnet18", CFG.replace(compute_dtype="bfloat16"), RUN)
    assert est.model.depth == 18 and est.model.dtype == torch.bfloat16


def test_keras_frontend_with_reference_callback_set(tmp_path):
    model = Model(_model(), CFG, device="cpu")
    model.compile(optimizer="sgd")
    callbacks = [
        BroadcastGlobalVariablesCallback(0),
        MetricAverageCallback(),
        LearningRateWarmupCallback(warmup_epochs=2, verbose=True),
        LearningRateScheduleCallback(multiplier=0.1, start_epoch=30),
        LearningRateScheduleCallback(multiplier=0.01, start_epoch=60),
        LoggerCallback(),
        ModelCheckpointCallback(str(tmp_path / "ckpt")),
    ]
    result = model.fit(_data(CFG), epochs=1, callbacks=callbacks,
                       validation_data=_data(CFG, 8, exact=True))
    assert result.state.step == 8
    assert len(result.history) == 1 and "val_top1" in result.history[0]
    # schedule callbacks were consumed into the config, each multiplier
    # absolute: the boundaries' factors are 0.1 and 0.01 / 0.1
    assert model.config.warmup_epochs == 2
    assert model.config.lr_decay_epochs == (30, 60)
    assert model.config.lr_decay_factors == pytest.approx((0.1, 0.1))
    # the checkpoint was written and restores
    m2 = Model(_model(), CFG, device="cpu").compile()
    m2.load_weights(str(tmp_path / "ckpt"))
    for (k, a), b in zip(model.state.model.state_dict().items(),
                         m2.state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_keras_schedule_multipliers_match_jax_conversion():
    """The multipliers -> factors conversion gives the JAX front-end's
    schedule: the port's rates at every epoch boundary equal optax's."""
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training.optimizer import create_optimizer as jax_opt

    cfg = CFG.replace(validation=False, fake_data_length=4)
    m = Model(_model(cfg), cfg, device="cpu").compile()
    scheds = [LearningRateScheduleCallback(multiplier=x, start_epoch=e)
              for x, e in ((0.1, 1), (0.01, 2), (0.001, 3))]
    m.fit(_data(cfg), epochs=1, callbacks=scheds)
    _, want = jax_opt(JaxConfig(**{f: getattr(m.config, f) for f in (
        "base_lr", "warmup_epochs", "lr_decay_epochs", "lr_decay_factors", "epochs",
        "batch_size_per_device", "num_classes")}), 2, world_size=1)
    for step in range(0, 10):
        assert np.float32(m.lr_schedule(step)) == np.float32(want(step)), step


def test_keras_compile_required():
    model = Model(_model(), CFG, device="cpu")
    with pytest.raises(RuntimeError, match="compile"):
        model.fit(_data(CFG))


def test_keras_bad_optimizer_and_loss():
    with pytest.raises(ValueError, match="optimizer"):
        Model(_model(), CFG, device="cpu").compile(optimizer="adamw9000")
    with pytest.raises(ValueError, match="loss"):
        Model(_model(), CFG, device="cpu").compile(loss="hinge")


def test_explicit_frontend():
    pieces, state = explicit.setup(_model(), CFG, device="cpu",
                                   steps_per_epoch=_data(CFG).steps_per_epoch)
    state = explicit.train_epoch(pieces, state, _data(CFG), epoch=0)
    assert state.step == 8
    metrics = explicit.validate(pieces, state, _data(CFG, 8))
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["top1"] <= 1


def test_frontends_agree():
    """Same seed, config and data: the estimator and the explicit loop
    end on the same parameters, bit for bit (one engine underneath)."""
    est = Estimator(lambda cfg: _model(), CFG, RUN)
    est.train(_data, epochs=1)
    pieces, state = explicit.setup(_model(), CFG, device="cpu",
                                   steps_per_epoch=_data(CFG).steps_per_epoch)
    state = explicit.train_epoch(pieces, state, _data(CFG), epoch=0)
    for (k, a), b in zip(est.state.model.state_dict().items(),
                         state.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_explicit_matches_jax_explicit():
    from _torch_train_common import assert_step_matches

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.frontends import explicit as jax_explicit
    from distributeddeeplearning_tpu.models.resnet import ResNet
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu_torch.models import convert

    kw = dict(model="resnet18", num_classes=10, image_size=64, batch_size_per_device=4,
              compute_dtype="float32", base_lr=0.01, label_smoothing=0.1, warmup_epochs=1,
              fake_data_length=12, log_every_steps=0)
    data = dict(length=12, global_batch_size=4, image_size=64, num_classes=10,
                num_physical_batches=3, seed=3)
    jcfg = JaxConfig(**kw)
    pieces, jstate = jax_explicit.setup(ResNet(depth=18, num_classes=10, dtype=jnp.float32),
                                        jcfg, mesh=create_mesh(devices=jax.devices()[:1]),
                                        steps_per_epoch=3)
    init = (jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.batch_stats))
    from distributeddeeplearning_tpu.data.synthetic import SyntheticImageDataset as JaxImages

    jstate = jax_explicit.train_epoch(pieces, jstate, JaxImages(**data), epoch=0)
    want = (jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.batch_stats))

    cfg = TrainConfig(**kw)
    mine, state = explicit.setup(get_model("resnet18", num_classes=10, dtype="float32",
                                           device="cpu"),
                                 cfg, device="cpu", steps_per_epoch=3)
    state.model.load_state_dict(convert.resnet_params_from_flax(*init))
    state = explicit.train_epoch(mine, state, SyntheticImageDataset(**data), epoch=0)
    assert state.step == int(jstate.step) == 3
    assert_step_matches(init, [], want, [], convert.resnet_params_to_flax(
        state.model.state_dict()))


def test_runconfig_device_is_field():
    rc = RunConfig(model_dir="x", device="cpu", process_group="placeholder")
    assert rc.device == "cpu" and rc.process_group == "placeholder"


def test_keras_initial_epoch_skips_completed_epochs():
    """Reference resume contract (:323-341): initial_epoch=2 with
    epochs=3 runs exactly one epoch of steps."""
    m = Model(_model(), CFG.replace(validation=False), device="cpu")
    m.compile()
    result = m.fit(_data(CFG), epochs=3, initial_epoch=2)
    assert m.state.step == 8  # one epoch
    assert len(result.history) == 1


def test_compute_dtype_reaches_model():
    m32 = Model("resnet18", CFG.replace(compute_dtype="float32"), device="cpu")
    assert m32.module.dtype == torch.float32
    m16 = Model("resnet18", CFG.replace(compute_dtype="bfloat16"), device="cpu")
    assert m16.module.dtype == torch.bfloat16


def test_keras_categorical_crossentropy_one_hot():
    """Reference Keras mode: categorical CE over one-hot labels
    (imagenet_keras_horovod.py:307, data_generator.py:48-53)."""
    cfg = CFG.replace(validation=False)
    m = Model(_model(), cfg, device="cpu")
    m.compile(loss="categorical_crossentropy")
    result = m.fit(_data(cfg, 8, one_hot=True), epochs=1)
    assert np.isfinite(result.history[-1]["loss"])
    assert 0.0 <= result.history[-1]["accuracy"] <= 1.0


def test_one_hot_evaluation():
    """categorical mode evaluates too: one-hot labels reduce to hard
    labels for top-k and weight the CE term directly."""
    cfg = CFG.replace(validation=False)
    m = Model(_model(), cfg, device="cpu")
    m.compile(loss="categorical_crossentropy")
    m.fit(_data(cfg, 8), epochs=1)
    metrics = m.evaluate(_data(cfg, length=5, one_hot=True, exact=True))
    assert metrics["samples"] == 5.0
    for k in ("loss", "top1", "top5"):
        assert np.isfinite(metrics[k])
    assert metrics["top5"] >= metrics["top1"]


@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 7)], ids=["BC", "BTV"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_one_hot_loss_and_grad_match_jax(shape, smoothing):
    from distributeddeeplearning_tpu.training.train_step import (
        cross_entropy_loss as jax_loss,
    )

    rng = np.random.RandomState(7)
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    labels = np.eye(shape[-1], dtype=np.float32)[rng.randint(0, shape[-1], shape[:-1])]
    want, want_grad = jax.value_and_grad(
        lambda x: jax_loss(x, jnp.asarray(labels), smoothing))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = cross_entropy_loss(x, torch.tensor(labels), smoothing)
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-8)
    # the sparse path on the same hard labels gives the same loss
    sparse = cross_entropy_loss(x, torch.tensor(labels.argmax(-1)), smoothing)
    np.testing.assert_allclose(sparse.item(), got.item(), rtol=1e-6)


@pytest.mark.parametrize("shape", [(6, 10), (3, 4, 9)], ids=["BC", "BTV"])
def test_one_hot_eval_metrics_match_jax(shape):
    from distributeddeeplearning_tpu.training.train_step import (
        eval_metrics_fn as jax_eval,
    )

    rng = np.random.RandomState(3)
    logits = rng.randn(*shape).astype(np.float32)
    labels = np.eye(shape[-1], dtype=np.float32)[rng.randint(0, shape[-1], shape[:-1])]
    weights = (np.arange(shape[0]) < shape[0] - 1).astype(np.float32)  # the last padded
    want = jax_eval(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(weights))
    got = eval_metrics_fn(torch.tensor(logits), torch.tensor(labels), torch.tensor(weights))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
