"""The engines through the port's entry points (twins of
``tests/test_engines.py``): ``loop.fit`` with validation, ``evaluate``
and checkpoint resume under ``ENGINE=pjit|pp|sp`` in 2-rank gloo worlds
(``lm_tiny`` f32 on the synthetic token stream; ``lm_moe_tiny`` with its
experts over an ``expert`` axis), the front-ends, and the
env contract (``ENGINE``, ``MESH_*``, ``PP_*``, ``PARAM_SHARDING``,
``ALLOW_SYNC_BN``, ``ASYNC_COLLECTIVES``, ``ATTN_IMPL=ring``) with JAX's
defaults and errors.

Resume: a 1-epoch ``fit`` then a 2-epoch ``fit`` on its ``MODEL_DIR``
runs one more epoch from the gathered checkpoint, re-sliced on load, and
ends on the uninterrupted 2-epoch run's state bit for bit (the same
batches, the same reductions in the same order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_mesh_common import run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
from distributeddeeplearning_tpu_torch.training import engines, loop

VOCAB, T = 64, 16
BASE = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=4,
            compute_dtype="float32", base_lr=0.1, warmup_epochs=0, validation=True,
            lr_schedule="constant", checkpoint_async=False)
ENGINE_CFG = {
    "pjit": dict(engine="pjit", mesh_axes=("data", "model"), mesh_shape=(1, 2)),
    "pp": dict(engine="pp", mesh_axes=("data", "pipe"), mesh_shape=(1, 2), pp_microbatches=2),
    "sp": dict(engine="sp", mesh_axes=("data", "seq"), mesh_shape=(1, 2)),
    # docs/PARALLELISM.md's EP recipe (ENGINE=pjit MESH_AXES=data,expert), at 2 ranks
    "pjit_ep": dict(engine="pjit", mesh_axes=("data", "expert"), mesh_shape=(1, 2),
                    model="lm_moe_tiny", moe_experts=4),
}
DATA = dict(length=32, seq_len=T, vocab_size=VOCAB, num_physical_batches=2, seed=3)
MODEL = dict(name="lm_tiny", kwargs=dict(max_seq_len=T))
MOE_MODEL = dict(name="lm_moe_tiny", kwargs=dict(max_seq_len=T, moe_experts=4))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engines")
    jobs = []
    for name, extra in ENGINE_CFG.items():
        cfg = dict(BASE, **extra)
        model = MOE_MODEL if "moe_experts" in extra else MODEL
        jobs.append(dict(kind="fit", cfg=cfg, model=model, data=DATA, epochs=2))
        resumed = dict(cfg, model_dir=str(tmp / name))
        jobs.append(dict(kind="fit", cfg=resumed, model=model, data=DATA, epochs=1))
        jobs.append(dict(kind="fit", cfg=resumed, model=model, data=DATA, epochs=2))
    out = run_world(jobs, 2, tmp / "world")
    return {name: out[3 * i:3 * i + 3] for i, name in enumerate(ENGINE_CFG)}


@pytest.mark.parametrize("engine", list(ENGINE_CFG))
def test_engine_fit_trains_and_evals(fits, engine):
    full = fits[engine][0]
    assert len(full["history"]) == 2
    for h in full["history"]:
        assert np.isfinite(h["loss"]) and np.isfinite(h["val_loss"]) and h["val_samples"] > 0
    assert np.isfinite(full["eval"]["loss"])
    assert abs(full["eval"]["loss"] - full["history"][-1]["val_loss"]) <= 1e-6


@pytest.mark.parametrize("engine", list(ENGINE_CFG))
def test_engine_checkpoint_resume(fits, engine):
    full, first, resumed = fits[engine]
    steps = full["step"]
    assert resumed["step"] == steps and first["step"] == steps // 2
    assert len(resumed["history"]) == 1  # epoch 0 came from the checkpoint
    assert resumed["history"][0]["loss"] == full["history"][1]["loss"]
    for k, v in full["state"]["model"].items():
        assert torch.equal(resumed["state"]["model"][k], v), k


def test_engine_pjit_checkpoint_holds_whole_arrays(fits):
    """The tensor-parallel checkpoint is the dp model's state dict."""
    dp = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, device="meta")
    got = fits["pjit"][0]["state"]["model"]
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in dp.state_dict().items()}


def test_env_contract_parses_like_jax():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    env = {"ENGINE": "pp", "PP_STAGES": "2", "PP_MICROBATCHES": "8", "PP_SCHEDULE": "1f1b",
           "PARAM_SHARDING": "fsdp", "ALLOW_SYNC_BN": "1", "ASYNC_COLLECTIVES": "0",
           "MESH_AXES": "data,pipe", "MESH_SHAPE": "-1,2", "ATTN_IMPL": "ring"}
    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for f in ("engine", "pp_stages", "pp_microbatches", "pp_schedule", "param_sharding",
              "allow_sync_bn", "async_collectives", "mesh_axes", "mesh_shape", "attn_impl"):
        assert getattr(mine, f) == getattr(ref, f), f
    defaults, jax_defaults = TrainConfig(), JaxConfig()
    for f in ("engine", "pp_stages", "pp_microbatches", "pp_schedule", "param_sharding",
              "allow_sync_bn", "async_collectives", "mesh_axes", "mesh_shape"):
        assert getattr(defaults, f) == getattr(jax_defaults, f), f


def test_resolve_engine_validation():
    with pytest.raises(ValueError, match="unknown engine"):
        loop.resolve_engine(TrainConfig(engine="zz"), "cpu")
    with pytest.raises(ValueError, match="requires ENGINE=pjit"):
        loop.resolve_engine(TrainConfig(param_sharding="fsdp"), "cpu")
    with pytest.raises(ValueError, match="unknown sharding rules"):
        loop.resolve_engine(TrainConfig(param_sharding="zero3"), "cpu")
    with pytest.raises(ValueError, match="PP_SCHEDULE"):
        loop.resolve_engine(TrainConfig(engine="pp", pp_schedule="zb"), "cpu")
    with pytest.raises(ValueError, match="'pipe' mesh axis"):
        engines.resolve_mesh(TrainConfig(engine="pp", mesh_axes=("data", "model")))
    with pytest.raises(ValueError, match="'seq' mesh axis"):
        engines.resolve_mesh(TrainConfig(engine="sp", mesh_axes=("data", "model")))
    with pytest.raises(ValueError, match="PP_STAGES"):
        engines.resolve_mesh(TrainConfig(engine="pp", pp_stages=2, mesh_axes=("data", "pipe")))
    assert engines.resolve_mesh(TrainConfig()) is None
    assert engines.resolve_mesh(TrainConfig(engine="sp")).axis_names == ("data", "seq")
    assert engines.resolve_mesh(TrainConfig(engine="pp")).axis_names == ("data", "pipe")


def test_later_slices_still_refused():
    """The expert axis is accepted; an expert count it does not divide,
    and AOT_WARMUP with a mesh engine, still raise."""
    assert TrainConfig.from_env({"MESH_AXES": "data,expert", "MESH_SHAPE": "2,4",
                                 "ENGINE": "pjit", "MODEL": "lm_moe_small"}).mesh_axes == (
        "data", "expert")
    with pytest.raises(ValueError, match="6 experts do not split over expert=4"):
        TrainConfig.from_env({"MESH_AXES": "data,expert", "MESH_SHAPE": "2,4",
                              "ENGINE": "pjit", "MOE_EXPERTS": "6"})
    with pytest.raises(NotImplementedError, match="AOT_WARMUP"):
        TrainConfig.from_env({"AOT_WARMUP": "1", "ENGINE": "pp"})
    TrainConfig.from_env({"AOT_WARMUP": "1", "ENGINE": "dp"})


def test_adapt_model_errors_and_depth_rounding():
    mesh = create_mesh(axes=("data", "pipe"))
    cfg = TrainConfig(engine="pp")
    with pytest.raises(ValueError, match="LM family"):
        engines.adapt_model(get_model("resnet18", num_classes=10, device="cpu"), "pp", mesh, cfg)
    with pytest.raises(ValueError, match="LM family"):
        engines.adapt_model(get_model("resnet18", num_classes=10, device="cpu"), "sp", mesh, cfg)
    with pytest.raises(ValueError, match="MoE"):
        engines.adapt_model(get_model("lm_moe_tiny", num_classes=VOCAB, max_seq_len=T,
                                      device="cpu"), "pp", mesh, cfg)
    lm = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, n_layers=3, device="cpu",
                   attn_impl="ring")
    pl = engines.adapt_model(lm, "pp", mesh, cfg)
    assert pl.n_layers == 3 and pl.attn_impl == "xla"  # ring becomes xla inside a stage
    sp = engines.adapt_model(get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T,
                                       device="cpu"), "sp", mesh, cfg)
    assert sp.seq_axis == "seq" and all(b.attn.attn_impl == "ring" for b in sp.blocks)


def test_data_parallel_width_follows_the_engine():
    assert TrainConfig(engine="pp", mesh_axes=("data", "pipe"), mesh_shape=(1, 1)
                       ).data_parallel_width == 1
    assert TrainConfig(engine="sp").data_parallel_width == 1
    assert dataclasses.replace(TrainConfig(), engine="pjit").data_parallel_width == 1


def test_explicit_frontend_builds_a_mesh_engine():
    from distributeddeeplearning_tpu_torch.frontends import explicit

    cfg = TrainConfig(**dict(BASE, **dict(ENGINE_CFG["pp"], mesh_shape=(1, 1))))
    model = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                      device="cpu")
    pieces, state = explicit.setup(model, cfg, steps_per_epoch=4, device="cpu")
    assert pieces.mesh.shape == {"data": 1, "pipe": 1} and state.layout is not None
    assert type(pieces.model).__name__ == "PipelineLM"
    rng = np.random.RandomState(0)
    rows = rng.randint(0, VOCAB, size=(4, T + 1)).astype(np.int32)
    state, m = pieces.train_step(state, (rows[:, :-1], rows[:, 1:]))
    assert np.isfinite(float(m["loss"])) and state.step == 1
