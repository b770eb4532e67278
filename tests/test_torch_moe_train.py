"""MoE LM training of the port against the JAX package's dp step, on the
same flax parameters (``convert.params_from_flax``) and synthetic tokens.

* ``MOE_EXPERTS`` reaches the LM through ``model_kwargs``, conv models
  ignore it, and ``lm_moe_*`` defaults to 8 experts (the twin of JAX's
  ``test_moe_env_knob``); the model and optimizer knobs parse from the env as
  JAX's do.
* ``lm_moe_tiny`` with 4 experts (blocks 1 routed), f32, ``xla``
  attention: one dp step with SGD and one with AdamW
  (``DECOUPLED_WEIGHT_DECAY=0.1``, ``WEIGHT_DECAY=0``) against JAX's step
  on a one-device mesh: loss (cross-entropy plus the sown load-balance
  loss), accuracy and gradient norm within 1e-5 relative; SGD's updates
  within 1e-4 of their norm per parameter (plus 2**-23 of the
  parameter's norm) and 1e-5 all together. Under SGD the first update is
  ``-lr·g``, so this holds the gradients. AdamW's first update is
  ``-lr·g/(|g| + eps)``, which turns an element's f32 round-off into a
  whole step where ``|g|`` is near ``eps``: its updates are held within
  5e-4 per parameter and 2e-4 all together (measured 1.5e-4 and 7.7e-5),
  and the attention's key bias, whose gradient is zero in exact
  arithmetic (a per-query constant under the softmax), so that both
  sides' updates of it are normalised round-off, is held apart: every
  element of it within ``lr`` of its start on both sides.
* The L2 penalty and AdamW's decay mask cover JAX's ``kernel`` leaves:
  the MoE ``router``, ``w1`` and ``w2`` are exempt from both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import assert_updates_close, leaves

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    l2_kernel_penalty,
    make_train_step,
)

VOCAB, SEQ, BATCH, STEPS_PER_EPOCH, EXPERTS = 64, 32, 4, 10, 4
CFG = dict(model="lm_moe_tiny", num_classes=VOCAB, batch_size_per_device=BATCH,
           compute_dtype="float32", base_lr=0.05, warmup_epochs=1, moe_experts=EXPERTS)
OPTS = {"sgd": {}, "adamw": dict(optimizer="adamw", decoupled_weight_decay=0.1,
                                 weight_decay=0.0, base_lr=1e-3)}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_moe_env_knob():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    cfg = TrainConfig.from_env({"MODEL": "lm_tiny", "MOE_EXPERTS": "4"})
    assert cfg.moe_experts == 4
    m = get_model(cfg.model, **cfg.model_kwargs(), device="meta")
    assert isinstance(m, TransformerLM) and m.moe_experts == 4 and m.moe_layers() == (1,)
    assert type(get_model("resnet18", **cfg.model_kwargs(), device="meta")).__name__ == "ResNet"
    cfg2 = TrainConfig.from_env({"MODEL": "lm_moe_tiny"})
    assert get_model(cfg2.model, **cfg2.model_kwargs(), device="meta").moe_experts == 8
    base = get_model("lm_moe_base", device="meta")
    assert base.moe_layers() == (1, 3, 5, 7, 9, 11)
    assert 0.30e9 < sum(p.numel() for p in base.parameters()) < 0.32e9
    env = {"MODEL": "lm_moe_tiny", "MOE_EXPERTS": "4", "REMAT": "1", "OPTIMIZER": "adamw",
           "DECOUPLED_WEIGHT_DECAY": "0.1", "WEIGHT_DECAY": "0"}
    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    for f in ("moe_experts", "remat", "optimizer", "decoupled_weight_decay", "weight_decay",
              "adam_beta1", "adam_beta2", "adam_eps"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert {k: mine.model_kwargs()[k] for k in ("moe_experts", "remat")} == {
        k: ref.model_kwargs()[k] for k in ("moe_experts", "remat")}


@pytest.mark.parametrize("name", ["lm_tiny", "lm_moe_tiny", "vit_ti16", "resnet18",
                                  "efficientnet_b0"])
def test_get_model_forwards_moe_and_remat_as_jax(name):
    """``moe_experts`` reaches the LM family and ``remat`` the LMs and ViT
    (JAX's ``_MOE_MODELS`` and ``_REMAT_MODELS``); the others ignore them."""
    from distributeddeeplearning_tpu.models import _MOE_MODELS, _REMAT_MODELS

    kw = dict(num_classes=10, device="meta", moe_experts=4, remat=True)
    if name.startswith("vit"):
        kw["image_size"] = 32
    model = get_model(name, **kw)
    assert (getattr(model, "moe_experts", 0) == 4) == (name in _MOE_MODELS)
    assert getattr(model, "remat", False) == (name in _REMAT_MODELS)


@pytest.fixture(scope="module")
def jax_params():
    import flax.linen as nn

    from distributeddeeplearning_tpu.models import get_model as jax_get_model

    model = jax_get_model("lm_moe_tiny", num_classes=VOCAB, dtype=jnp.float32,
                          max_seq_len=SEQ, moe_experts=EXPERTS)
    init = jax.jit(lambda key, x: model.init(key, x, train=False))
    return jax.device_get(nn.unbox(init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, SEQ), jnp.int32))["params"]))


def _data(n, seed=0):
    ds = SyntheticTokenDataset(length=BATCH * n, global_batch_size=BATCH, seq_len=SEQ,
                               vocab_size=VOCAB, num_physical_batches=n, seed=seed)
    return list(ds.epoch(0))[:n]


def run_jax(params, data, **over):
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

    cfg = JaxConfig(**dict(CFG, **over))
    model = jax_get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ)
    tx, _ = jax_opt(cfg, STEPS_PER_EPOCH, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, SEQ), input_dtype=jnp.int32)
    state = state.replace(params=params, opt_state=tx.init(params))
    mesh = create_mesh(devices=jax.devices()[:1])
    step = jax_step(model, tx, mesh, cfg, donate_state=False, check_vma=False)
    state = replicate_state(state, mesh)
    metrics = []
    for batch in data:
        state, m = step(state, shard_batch(batch, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def run_port(params, data, **over):
    cfg = TrainConfig(**dict(CFG, **over))
    model = get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=SEQ, device="cpu")
    tx, _ = create_optimizer(cfg, STEPS_PER_EPOCH, world_size=1)
    state = create_train_state(model, cfg, tx, device="cpu",
                               state_dict=convert.params_from_flax(params))
    step = make_train_step(model, tx, cfg, device="cpu")
    metrics = []
    for batch in data:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, convert.params_to_flax(model.state_dict())


def _set_key_bias(tree, init):
    """The key third of every ``qkv`` bias put back to ``init``'s (the
    trees are updated in place); returns the updates it held."""
    held = []
    for name, block in tree.items():
        if name.startswith("block"):
            bias, start = block["attn"]["qkv"]["bias"], init[name]["attn"]["qkv"]["bias"]
            third = bias.shape[0] // 3
            held.append(bias[third:2 * third] - start[third:2 * third])
            bias[third:2 * third] = start[third:2 * third]
    return held


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_moe_dp_step_matches_jax_dp_step(jax_params, opt):
    data = _data(1)
    want_metrics, want_params = run_jax(jax_params, data, **OPTS[opt])
    got_metrics, got_params = run_port(jax_params, data, **OPTS[opt])
    for w, g in zip(want_metrics, got_metrics):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    init = jax.tree.map(np.asarray, jax_params)
    if opt == "sgd":
        assert_updates_close(init, want_params, got_params, per_leaf=1e-4, total=1e-5)
        return
    want_params = jax.tree.map(np.array, want_params)
    lr = OPTS[opt]["base_lr"] * 1.0001
    for held in _set_key_bias(want_params, init) + _set_key_bias(got_params, init):
        assert np.abs(held).max() <= lr
    assert_updates_close(init, want_params, got_params, per_leaf=5e-4, total=2e-4)


def test_l2_and_decay_mask_cover_the_flax_kernel_leaves(jax_params):
    from distributeddeeplearning_tpu.training.optimizer import _kernel_mask
    from distributeddeeplearning_tpu.training.train_step import l2_kernel_penalty as jl2

    model = get_model("lm_moe_tiny", num_classes=VOCAB, dtype=torch.float32, max_seq_len=SEQ,
                      moe_experts=EXPERTS, device="cpu")
    model.load_state_dict(convert.params_from_flax(jax_params))
    assert len(model.kernel_parameters()) == 4 + 2  # a dense block and an MoE block's attn
    with torch.no_grad():
        want = float(jl2(jax_params, 5e-5))
        assert abs(float(l2_kernel_penalty(model, 5e-5)) - want) <= 1e-6 * want
    names = {id(p): n for n, p in model.named_parameters()}
    decayed = {names[id(p)] for p in model.kernel_parameters()}
    mask = dict(leaves(jax.tree.map(np.asarray, _kernel_mask(jax_params))))
    flax_kernels = {k for k, v in mask.items() if v}
    port_kernels = {"/".join(k.split("/")) for k in
                    dict(leaves(convert.params_to_flax(
                        {n: model.state_dict()[n] for n in decayed}))).keys()}
    assert port_kernels == flax_kernels
    assert not any("moe" in k for k in flax_kernels)
