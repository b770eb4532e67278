"""The port's AOT warm-up (``training/warmup.py``: CUDA-graph capture),
its kernel-library cache and the capture-safe optimizer, against the
JAX package:

* ``AOT_WARMUP``, ``COMPILATION_CACHE_DIR`` and ``DISTRIBUTED`` resolve
  as JAX's ``TrainConfig.from_env`` resolves them;
* ``fit`` with ``AOT_WARMUP=1`` reports JAX's warm-up keys in ``perf``
  (``lm_tiny``, 2 steps, both packages), plus ``graphs_captured`` (0 on
  the CPU) and ``eager_steps``; ``Engine.warmup`` with an eval batch
  gives the eval keys and leaves the state as it was, bit for bit;
* ``fit`` with ``AOT_WARMUP=1`` equals ``fit`` without, bit for bit, on
  the CPU (ResNet-18 32 px; ``GRAD_ACCUM_STEPS=2``; EfficientNet-B0 with
  dropout under ``ACCUM_STEPS=2``);
* the rate the optimizer writes into its device scalar equals JAX's
  optax schedule, as f32, bit for bit, at every count across the
  warm-up and decay boundaries (plain and ``GRAD_ACCUM_STEPS=2``);
* the split ``MomentumSGD``/``MultiSteps`` update equals, bit for bit,
  the host-float update it replaced;
* the cache: a host library (``csrc/depthwise_plan.cpp``) built into a
  temporary ``COMPILATION_CACHE_DIR`` is a miss, loading it again a hit;
* on the card (``cuda``): a captured ResNet-18 step replays bit for bit
  as the eager step.
"""

import shutil

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset, SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.training import create_optimizer, loop, warmup
from distributeddeeplearning_tpu_torch.training.engines import build_engine
from distributeddeeplearning_tpu_torch.training.metrics import init_accumulator
from distributeddeeplearning_tpu_torch.training.optimizer import MomentumSGD, MultiSteps


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENVS = [{"AOT_WARMUP": "1"}, {"AOT_WARMUP": "no"}, {"COMPILATION_CACHE_DIR": "/cache"},
        {"COMPILATION_CACHE_DIR": ""}, {"DISTRIBUTED": "True"}, {"DISTRIBUTED": "0"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_config_resolves_warmup_settings_like_jax(env):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for field in ("aot_warmup", "compilation_cache_dir", "distributed"):
        assert getattr(mine, field) == getattr(ref, field), field


def test_process_tier_settings_still_raise():
    """Since the process tier landed, ``ELASTIC`` and ``LR_WORLD_SIZE``
    no longer raise: they resolve as JAX's config resolves them (the
    name is kept from when they raised)."""
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    for env in ({"ELASTIC": "1"}, {"LR_WORLD_SIZE": "8"}):
        mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
        assert (mine.elastic, mine.lr_world_size) == (ref.elastic, ref.lr_world_size)


LM = dict(model="lm_tiny", num_classes=64, batch_size_per_device=2, fake_data_length=4,
          epochs=1, compute_dtype="float32", weight_decay=0.0, log_every_steps=0,
          aot_warmup=True)


def test_fit_reports_jax_warmup_keys():
    import jax

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.synthetic import SyntheticTokenDataset as JaxTokens
    from distributeddeeplearning_tpu.models import get_model as jax_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import loop as jax_loop

    data = dict(length=4, global_batch_size=2, seq_len=16, vocab_size=64)
    ref = jax_loop.fit(jax_model("lm_tiny", num_classes=64, dtype="float32", max_seq_len=16),
                       JaxConfig(**LM), JaxTokens(**data),
                       mesh=create_mesh(devices=jax.devices()[:1]), add_default_logger=False)
    cfg = TrainConfig(**LM)
    mine = loop.fit(get_model("lm_tiny", num_classes=64, dtype="float32", max_seq_len=16,
                              device="cpu"),
                    cfg, SyntheticTokenDataset(**data), device="cpu", add_default_logger=False)
    assert set(mine.perf) == set(ref.perf) | {"graphs_captured", "eager_steps"}
    assert mine.perf["graphs_captured"] == 0 and mine.perf["eager_steps"] == 0
    assert mine.perf["compile_sec"] == mine.perf["train_compile_sec"] > 0
    assert mine.perf["train_flops_per_step"] > 0  # no hand-written kernel on the CPU


def _resnet(**kw):
    cfg = TrainConfig(model=kw.pop("model", "resnet18"), num_classes=10, image_size=32,
                      batch_size_per_device=4, compute_dtype="float32", fake_data_length=16,
                      epochs=2, log_every_steps=0, **kw)
    data = SyntheticImageDataset(length=16, global_batch_size=4, image_size=32, num_classes=10,
                                 seed=1)
    model = get_model(cfg.model, num_classes=10, dtype="float32", device="cpu")
    return cfg, data, model


def test_engine_warmup_keys_and_state_kept():
    cfg, data, model = _resnet()
    tx, _ = create_optimizer(cfg, data.steps_per_epoch)
    eng = build_engine(model, cfg, tx, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = next(iter(data.epoch(0)))
    info = eng.warmup(batch, acc=init_accumulator("cpu"), eval_batch=batch)
    assert set(info) == {"train_compile_sec", "eval_compile_sec", "compile_sec",
                         "persistent_cache_hits", "persistent_cache_misses",
                         "train_flops_per_step", "graphs_captured"}
    assert info["graphs_captured"] == 0
    assert info["compile_sec"] == info["train_compile_sec"] + info["eval_compile_sec"]
    assert eng.state.step == 0 and eng.state.opt_state["count"] == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(not t.any() for t in eng.state.opt_state["trace"])


@pytest.mark.parametrize("kw", [dict(), dict(grad_accum_steps=2),
                                dict(model="efficientnet_b0", accum_steps=2)],
                         ids=["plain", "grad-accum-2", "effnet-b0-dropout-accum-2"])
def test_fit_with_aot_warmup_equals_fit_without(kw):
    runs = []
    for aot in (False, True):
        cfg, data, model = _resnet(aot_warmup=aot, **kw)
        res = loop.fit(model, cfg, data, device="cpu", add_default_logger=False)
        runs.append((res, {k: v.clone() for k, v in model.state_dict().items()}))
    (plain, want), (warm, got) = runs
    assert warm.history == plain.history
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert warm.perf["graphs_captured"] == 0 and "graphs_captured" not in plain.perf


SCHED = dict(base_lr=0.1, warmup_epochs=2, lr_decay_epochs=(3, 5), epochs=6,
             batch_size_per_device=4, scale_lr_by_world_size=False)


@pytest.mark.parametrize("k", [1, 2], ids=["sgd", "multisteps-2"])
def test_device_scalar_rate_matches_optax_schedule(k):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training.optimizer import create_optimizer as jax_opt

    spe = 4 * k
    _, jax_schedule = jax_opt(JaxConfig(**SCHED, grad_accum_steps=k), spe, world_size=1)
    tx, _ = create_optimizer(TrainConfig(**SCHED, grad_accum_steps=k), spe, world_size=1)
    params = [torch.zeros(3)]
    state = tx.init(params)
    sgd = tx.inner if k > 1 else tx
    for dispatch in range(6 * spe):  # every epoch: warm-up, both decays
        token = tx.prepare(state)
        moved = token if k == 1 else token[1]
        if moved is None:
            continue
        got = np.float32(-sgd.neg_lr("cpu").item())
        want = np.asarray(jax_schedule(dispatch), dtype=np.float32)
        assert got.tobytes() == want.tobytes(), (dispatch, got, want)


def _old_sgd_apply(sgd, params, grads, state):
    lr = sgd.schedule(state["count"])
    trace = state["trace"]
    torch._foreach_mul_(trace, sgd.momentum)
    torch._foreach_add_(trace, grads)
    torch._foreach_add_(params, torch._foreach_mul(trace, -lr))
    state["count"] += 1
    return lr


def _old_multisteps_apply(ms, params, grads, state):
    acc = state["acc"]
    delta = torch._foreach_sub(grads, acc)
    torch._foreach_div_(delta, float(state["mini_step"] + 1))
    torch._foreach_add_(acc, delta)
    if state["mini_step"] < ms.every_k - 1:
        state["mini_step"] += 1
        return None
    lr = _old_sgd_apply(ms.inner, params, acc, state["inner"])
    torch._foreach_zero_(acc)
    state["mini_step"] = 0
    state["gradient_step"] += 1
    return lr


@pytest.mark.parametrize("k", [1, 3], ids=["sgd", "multisteps-3"])
def test_split_update_equals_host_float_update_bitwise(k):
    cfg = TrainConfig(**SCHED, grad_accum_steps=k)
    tx, _ = create_optimizer(cfg, 4 * k, world_size=1)
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 3), (7,), (2, 3, 3, 4)]
    new = [torch.randn(s, generator=g) for s in shapes]
    old = [p.clone() for p in new]
    s_new, s_old = tx.init(new), tx.init(old)
    for _ in range(10 * k):
        grads = [torch.randn(s, generator=g) for s in shapes]
        lr_new = tx.apply(new, [x.clone() for x in grads], s_new)
        if k > 1:
            assert isinstance(tx, MultiSteps)
            lr_old = _old_multisteps_apply(tx, old, [x.clone() for x in grads], s_old)
        else:
            assert isinstance(tx, MomentumSGD)
            lr_old = _old_sgd_apply(tx, old, [x.clone() for x in grads], s_old)
        assert lr_new == lr_old
        for a, b in zip(new, old):
            assert torch.equal(a, b)
    for a, b in zip(torch.utils._pytree.tree_leaves(s_new), torch.utils._pytree.tree_leaves(s_old)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_loaded", {})
    warmup.enable_persistent_cache(str(tmp_path / "cache"))
    yield tmp_path / "cache"
    warmup.enable_persistent_cache(None)


def test_library_cache_misses_then_hits(cache_dir):
    if not any(shutil.which(c) for c in ("c++", "g++")):
        pytest.skip("no host C++ compiler to build csrc/*.cpp")
    hits0, misses0 = warmup.cache_stats()
    path = _build.library_path("depthwise_plan")
    assert path.parent == cache_dir and not path.exists()
    _build.load("depthwise_plan")
    assert warmup.cache_stats() == (hits0, misses0 + 1) and path.exists()
    _build.load("depthwise_plan")  # loaded in this process: no event
    assert warmup.cache_stats() == (hits0, misses0 + 1)
    _build._loaded.clear()  # a new process, as far as the cache can tell
    _build.load("depthwise_plan")
    assert warmup.cache_stats() == (hits0 + 1, misses0 + 1)
    from distributeddeeplearning_tpu_torch import obs

    names = [r["name"] for r in obs.get_bus().ring if r["kind"] == "counter"]
    assert "xla_cache_miss" in names and "xla_cache_hit" in names


@pytest.mark.cuda
def test_cuda_captured_resnet_step_replays_eager_bits():
    """On the card: a fused ResNet-18 step captured and replayed three
    times against three eager steps from the same init, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the capture runs on the card")
    from distributeddeeplearning_tpu_torch.data import to_device
    from distributeddeeplearning_tpu_torch.training import create_train_state, make_train_step

    finals = []
    for capture in (False, True):
        cfg = TrainConfig(model="resnet18", num_classes=10, image_size=64,
                          batch_size_per_device=8, fake_data_length=24)
        data = SyntheticImageDataset(length=24, global_batch_size=8, image_size=64,
                                     num_classes=10)
        model = get_model("resnet18", num_classes=10, fused=True, device="cuda")
        tx, _ = create_optimizer(cfg, data.steps_per_epoch)
        state = create_train_state(model, cfg, tx, device="cuda")
        step = make_train_step(model, tx, cfg, device="cuda")
        acc = init_accumulator("cuda")
        batches = [to_device(b, "cuda") for b in data.epoch(0)]
        if capture:
            captured, _ = step.aot_compile(state, batches[0], acc)
            assert captured.graphs == 1
        for b in batches:
            state, _, acc = step(state, b, acc)
        assert step.graphs == int(capture) and step.eager_calls == 0
        finals.append({k: v.clone() for k, v in model.state_dict().items()})
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]), k
