"""LM training of the port against the JAX package's, on the same numpy
inputs.

* ``SyntheticTokenDataset`` yields the JAX package's batches bit for
  bit, in both topologies and across epochs;
* ``ATTN_IMPL`` parses as in JAX; ``ring``, ``fused`` and ``auto`` raise
  ``NotImplementedError`` (later slices);
* ``lm_tiny`` in f32 with ``attn_impl="pallas"`` on converted JAX
  weights: logits against JAX's ``pallas`` model (the Pallas kernel in
  interpret mode), rtol/atol 1e-4 as ``test_torch_transformer_lm.py``
  holds the ``xla`` forward (the same f32 ops in another order, two
  layers and a softmax); then two dp steps on one device against JAX's
  dp step (1-device mesh): loss, accuracy and gradient norm within
  1e-5 relative, and the parameter updates within 2e-4 of their norm
  per parameter (plus 2**-23 of the parameter's norm, its f32
  resolution) and 2e-5 all together (measured: metrics 1e-7, updates
  1.0e-5 per parameter at worst and 1.0e-6 together);
* the port's ``pallas`` step against its own ``xla`` step on the CPU
  (f32: the same function, summed in another order): metrics within
  1e-5, updates within 1e-4 of their norm per parameter and 1e-5
  together (measured 9.7e-6 and 9.1e-7);
* the L2 penalty covers exactly the flax ``kernel`` leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    l2_kernel_penalty,
    make_train_step,
)

VOCAB, SEQ, BATCH, STEPS_PER_EPOCH = 64, 64, 4, 10
CFG = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=BATCH,
           compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl="pallas")


@pytest.mark.parametrize("topology,process_index,process_count",
                         [("process", 0, 1), ("process", 1, 2), ("global", 1, 2)])
def test_token_dataset_bitwise_equals_jax(topology, process_index, process_count):
    from distributeddeeplearning_tpu.data import SyntheticTokenDataset as JaxTokens

    kw = dict(length=40, global_batch_size=4, seq_len=16, vocab_size=100,
              num_physical_batches=3, seed=7, process_index=process_index,
              process_count=process_count, topology=topology)
    mine, ref = SyntheticTokenDataset(**kw), JaxTokens(**kw)
    assert mine.steps_per_epoch == ref.steps_per_epoch == 10
    for epoch in (0, 1):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (
                    4 // process_count, 16)
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attn_impl_env_resolves_like_jax(impl):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    env = {"ATTN_IMPL": impl, "MODEL": "lm_base"}
    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    assert mine.attn_impl == ref.attn_impl == impl
    assert mine.model_kwargs()["attn_impl"] == ref.model_kwargs()["attn_impl"]


@pytest.mark.parametrize("impl", ["ring", "fused", "auto"])
def test_attn_impls_of_later_slices_raise(impl):
    with pytest.raises(NotImplementedError, match=impl):
        TrainConfig.from_env({"ATTN_IMPL": impl})
    with pytest.raises(NotImplementedError, match=impl):
        TrainConfig(attn_impl=impl)


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError):
        TrainConfig(attn_impl="nope")


def test_get_model_forwards_attn_impl_to_the_lm_family_only():
    lm = get_model("lm_tiny", attn_impl="pallas", max_seq_len=SEQ, device="meta")
    assert lm.attn_impl == "pallas" and lm.max_seq_len == SEQ
    assert all(b.attn.attn_impl == "pallas" for b in lm.blocks)
    assert get_model("lm_tiny", device="meta").attn_impl == "xla"  # serving's default
    get_model("resnet18", attn_impl="pallas", device="meta")  # ignored


@pytest.fixture(scope="module")
def jax_lm():
    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM

    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=SEQ, dtype=jnp.float32,
                  attn_impl="pallas")
    import flax.linen as nn

    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32),
                                 train=False)["params"])
    return model, params


def _data(n, global_batch, seed=0):
    ds = SyntheticTokenDataset(length=global_batch * n, global_batch_size=global_batch,
                               seq_len=SEQ, vocab_size=VOCAB, num_physical_batches=n, seed=seed)
    return list(ds.epoch(0))[:n]


def test_pallas_logits_match_jax_pallas_model(jax_lm):
    model, params = jax_lm
    tokens = _data(1, 2)[0][0]
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(tokens), train=False))
    port = get_model("lm_tiny", num_classes=VOCAB, dtype=torch.float32, attn_impl="pallas",
                     max_seq_len=SEQ, device="cpu")
    port.load_state_dict(convert.params_from_flax(params))
    with torch.no_grad():
        out = port(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def run_jax(params, data, world=1):
    """Metrics per step and the final params of JAX's dp step."""
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.pipeline import shard_batch
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import (
        create_optimizer as jax_opt,
        create_train_state as jax_state,
        make_train_step as jax_step,
    )
    from distributeddeeplearning_tpu.training.train_step import replicate_state

    cfg = JaxConfig(**CFG)
    model = jax_get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ)
    tx, _ = jax_opt(cfg, STEPS_PER_EPOCH, world_size=world)
    state = jax_state(model, cfg, tx, input_shape=(1, SEQ), input_dtype=jnp.int32)
    state = state.replace(params=params)
    mesh = create_mesh(devices=jax.devices()[:world])
    step = jax_step(model, tx, mesh, cfg, donate_state=False, check_vma=False)
    state = replicate_state(state, mesh)
    metrics = []
    for batch in data:
        state, m = step(state, shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def run_port(params, data, attn_impl="pallas"):
    cfg = TrainConfig(**dict(CFG, attn_impl=attn_impl))
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ, device="cpu")
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.params_from_flax(params))
    step = make_train_step(model, tx, cfg, device="cpu")
    metrics = []
    for batch in data:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == len(data)
    return metrics, convert.params_to_flax(model.state_dict())


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_updates_close(init, want, got, per_leaf, total):
    p0, pw, pg = dict(_leaves(init)), dict(_leaves(want)), dict(_leaves(got))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= per_leaf * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= total * np.sqrt(den)


def test_pallas_dp_step_matches_jax_dp_step(jax_lm):
    _, params = jax_lm
    data = _data(2, BATCH)
    want_metrics, want_params = run_jax(params, data)
    got_metrics, got_params = run_port(params, data)
    for w, g in zip(want_metrics, got_metrics):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    init = jax.tree.map(np.asarray, params)
    assert_updates_close(init, want_params, got_params, per_leaf=2e-4, total=2e-5)


def test_pallas_step_matches_xla_step_on_cpu(jax_lm):
    _, params = jax_lm
    data = _data(2, BATCH, seed=1)
    m_pallas, p_pallas = run_port(params, data, "pallas")
    m_xla, p_xla = run_port(params, data, "xla")
    for w, g in zip(m_xla, m_pallas):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    init = jax.tree.map(np.asarray, params)
    assert_updates_close(init, p_xla, p_pallas, per_leaf=1e-4, total=1e-5)


def test_l2_covers_the_flax_kernel_leaves(jax_lm):
    from distributeddeeplearning_tpu.training.train_step import l2_kernel_penalty as jl2

    _, params = jax_lm
    model = get_model("lm_tiny", num_classes=VOCAB, dtype=torch.float32, max_seq_len=SEQ,
                      device="cpu")
    model.load_state_dict(convert.params_from_flax(params))
    assert len(model.kernel_parameters()) == 4 * model.depth
    with torch.no_grad():
        want = float(jl2(params, 5e-5))
        assert abs(float(l2_kernel_penalty(model, 5e-5)) - want) <= 1e-6 * want
