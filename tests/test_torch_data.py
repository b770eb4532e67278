"""The port's config, data and optimizer pieces against the JAX package's.

* ``native.fill_uniform`` and ``SyntheticImageDataset`` batches are
  **bitwise** the JAX package's (both topologies, exact mode, uint8).
* ``TrainConfig.from_env`` resolves the slice's fields like JAX's for
  the same env dict; fields and env vars of later slices raise.
* The LR schedule equals optax's **bitwise** at every step of a short
  run; ``MomentumSGD`` equals ``optax.sgd(momentum=0.9)`` to f32
  round-off (1e-7 relative) over several steps.
* ``normalize_staged_images`` equals JAX's to f32 round-off.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
from distributeddeeplearning_tpu.data.synthetic import SyntheticImageDataset as JaxDataset
from distributeddeeplearning_tpu.native import fill_uniform as jax_fill
from distributeddeeplearning_tpu.training.schedules import create_lr_schedule as jax_schedule
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import (
    SyntheticImageDataset,
    normalize_staged_images,
    prefetch_to_device,
    shard_batch,
    staging_dtype,
    to_device,
)
from distributeddeeplearning_tpu_torch.native import fill_uniform
from distributeddeeplearning_tpu_torch.training import MomentumSGD, create_lr_schedule


@pytest.mark.parametrize("shape,seed", [((7,), 0), ((3, 5, 5, 3), 42), ((1 << 22) + 9, 2**40 + 3)])
def test_fill_uniform_bitwise_equal_jax(shape, seed):
    np.testing.assert_array_equal(fill_uniform(shape, seed).view(np.uint32),
                                  jax_fill(shape, seed).view(np.uint32))


DATASETS = [
    dict(topology="process", process_index=0, process_count=1),
    dict(topology="process", process_index=1, process_count=2),
    dict(topology="global", process_index=1, process_count=2),
    dict(topology="process", process_index=1, process_count=2, exact=True),
    dict(topology="global", process_index=0, process_count=2, exact=True),
    dict(topology="process", process_index=0, process_count=1, dtype=np.uint8),
    dict(topology="process", process_index=0, process_count=1, one_hot=True),
]


@pytest.mark.parametrize("kw", DATASETS, ids=lambda kw: "-".join(
    f"{k}={getattr(v, '__name__', v)}" for k, v in kw.items()))
def test_synthetic_batches_bitwise_equal_jax(kw):
    common = dict(length=37, global_batch_size=8, image_size=6, num_classes=5,
                  num_physical_batches=3, seed=11, **kw)
    mine, ref = SyntheticImageDataset(**common), JaxDataset(**common)
    assert mine.steps_per_epoch == ref.steps_per_epoch
    for epoch in (0, 1):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


ENVS = [
    {},
    {"MODEL": "resnet18", "BATCHSIZE": "32", "IMAGE_SIZE": "128", "NUM_CLASSES": "10",
     "FAKE_DATA_LENGTH": "5000", "EPOCHS": "3", "LR": "0.1", "SEED": "7",
     "WEIGHT_DECAY": "1e-4", "LR_SCHEDULE": "cosine", "COMPUTE_DTYPE": "float32",
     "INPUT_STAGING": "uint8", "DATA_TOPOLOGY": "global", "FAKE": "yes",
     "ENGINE": "dp", "OPTIMIZER": "sgd", "ACCUM_STEPS": "2", "GRAD_ACCUM_STEPS": "4",
     "VALIDATION": "true", "PREFETCH_BATCHES": "3", "CHECKPOINT_EVERY_STEPS": "5",
     "CHECKPOINT_KEEP": "7", "CHECKPOINT_ASYNC": "0", "RESUME": "false",
     "NONFINITE_ACTION": "warn", "MODEL_DIR": "/ckpt", "AZ_BATCHAI_OUTPUT_MODEL": "/out"},
    {"AOT_WARMUP": "1"},
    {"COMPILATION_CACHE_DIR": "/cache"},
    {"MODEL": "lm_moe_tiny", "OPTIMIZER": "adamw", "MOE_EXPERTS": "4", "REMAT": "1",
     "DECOUPLED_WEIGHT_DECAY": "0.1", "WEIGHT_DECAY": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=["defaults", "all-slice-vars", "aot-warmup",
                                           "compilation-cache-dir", "model-optimizer-knobs"])
def test_config_from_env_resolves_like_jax(env):
    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    assert mine.steps_per_epoch() == max(mine.fake_data_length // mine.batch_size_per_device, 1)


@pytest.mark.parametrize("env", [{"ENGINE": "pjit"}, {"PP_STAGES": "2"},
                                 {"PARAM_SHARDING": "fsdp"}, {"ASYNC_COLLECTIVES": "1"},
                                 {"MESH_SHAPE": "2,4"}])
def test_config_settings_of_later_slices_raise(env):
    with pytest.raises(NotImplementedError):
        TrainConfig.from_env(env)


def test_config_gated_fields_raise_when_built_directly():
    for kw in (dict(engine="pp"), dict(engine="pjit")):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            TrainConfig(**kw)


SCHEDULES = [dict(), dict(lr_schedule="cosine", epochs=12), dict(lr_schedule="constant"),
             dict(warmup_epochs=0), dict(lr_decay_epochs=(2, 4, 9), lr_decay_factors=(0.5, 0.2, 0.1)),
             dict(base_lr=0.1, scale_lr_by_world_size=False)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["step", "cosine", "constant", "no-warmup",
                                               "factors", "unscaled"])
def test_lr_schedule_bitwise_equal_optax(kw):
    spe, world = 3, 4
    mine = create_lr_schedule(TrainConfig(**kw), spe, world)
    ref = jax_schedule(JaxConfig(**kw), spe, world)
    for s in range(100 * spe + 10):
        assert np.float32(mine(s)) == np.float32(ref(s)), s


def test_momentum_sgd_equals_optax_sgd():
    rng = np.random.RandomState(0)
    sched = create_lr_schedule(TrainConfig(base_lr=0.1, warmup_epochs=1), 2, 2)
    tx = optax.sgd(jax_schedule(JaxConfig(base_lr=0.1, warmup_epochs=1), 2, 2),
                   momentum=0.9, nesterov=False)
    p = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    jp = [np.array(x) for x in p]
    tp = [torch.tensor(x) for x in p]
    opt = MomentumSGD(sched, 0.9)
    tstate, jstate = opt.init(tp), tx.init(jp)
    for _ in range(5):
        g = [rng.randn(*x.shape).astype(np.float32) for x in p]
        upd, jstate = tx.update(g, jstate, jp)
        jp = [np.asarray(a + u) for a, u in zip(jp, upd)]
        opt.apply(tp, [torch.tensor(x) for x in g], tstate)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-7, atol=1e-7)
    assert tstate["count"] == 5


def test_normalize_staged_images_matches_jax():
    from distributeddeeplearning_tpu.data.pipeline import normalize_staged_images as jax_norm

    x = np.random.RandomState(0).randint(0, 256, size=(2, 4, 4, 3)).astype(np.uint8)
    np.testing.assert_allclose(normalize_staged_images(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_norm(x)), rtol=1e-6, atol=1e-6)
    f = torch.randn(2, 4, 4, 3)
    assert normalize_staged_images(f) is f


def test_staging_dtype_follows_input_staging():
    assert staging_dtype(TrainConfig(input_staging="uint8")) == np.uint8
    for choice in ("auto", "float32", "bfloat16"):
        assert staging_dtype(TrainConfig(input_staging=choice)) == np.float32
    with pytest.raises(ValueError):
        staging_dtype(TrainConfig(input_staging="int4"))


def test_shard_batch_and_staging_keep_the_rows():
    images = np.arange(8 * 2 * 2 * 3, dtype=np.float32).reshape(8, 2, 2, 3)
    labels = np.arange(8, dtype=np.int32)
    parts = [shard_batch((images, labels), r, 4) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]), images)
    np.testing.assert_array_equal(parts[2][1], [4, 5])
    with pytest.raises(ValueError):
        shard_batch((images, labels), 0, 3)
    staged = to_device(parts[1], "cpu")
    np.testing.assert_array_equal(staged[0].numpy(), parts[1][0])
    ds = SyntheticImageDataset(length=40, global_batch_size=4, image_size=4, num_classes=3,
                               num_physical_batches=2)
    for (a, b), (c, d) in zip(ds.epoch(1), prefetch_to_device(ds.epoch(1), "cpu")):
        np.testing.assert_array_equal(a, c.numpy())
        np.testing.assert_array_equal(b, d.numpy())
