"""Gradient checkpointing (``REMAT``) of the port: each block recomputed
in the backward (non-reentrant ``torch.utils.checkpoint``).

* ``REMAT=1`` reaches the LMs and ViT through ``model_kwargs``, and conv
  models ignore it (the twin of JAX's ``test_remat_env_and_registry_wiring``).
* ``lm_tiny`` (f32): loss and gradients with REMAT equal the stored path
  within 1e-6 (the twin of ``test_remat_gradients_identical``; measured:
  bit for bit), and equal JAX's REMAT gradients on the same flax
  parameters within 1e-5 of each leaf's largest value; each block's
  forward runs twice a step under REMAT (once in the backward).
* Dropout inside a checkpointed block: the masks are drawn before the
  checkpointed call from the step's generator and passed in, so the
  recompute applies the forward's masks. REMAT + dropout gradients equal
  no-REMAT + dropout gradients from the same generator seed within 1e-6
  (measured: bit for bit), for ``lm_moe_tiny`` (``pallas`` attention,
  a dense and an MoE block) and for ``vit_s16`` (32 px, ``fused``
  attention, ``FUSED_DENSE_GRAD``); and one train step of each, with
  and without REMAT, leaves the same parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    cross_entropy_loss,
    make_train_step,
    sown_aux_loss,
)

VOCAB, T = 32, 8


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_remat_env_and_registry_wiring():
    cfg = TrainConfig.from_env({"REMAT": "1", "MODEL": "lm_tiny"})
    assert cfg.remat
    assert get_model(cfg.model, **cfg.model_kwargs(), device="meta").remat
    assert type(get_model("resnet18", **cfg.model_kwargs(), device="meta")).__name__ == "ResNet"
    assert get_model("vit_ti16", **cfg.model_kwargs(), device="meta").remat


def _rows(seed=0, b=4):
    rows = np.random.RandomState(seed).randint(0, VOCAB, size=(b, T + 1)).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def _grads(model, inputs, labels, gen_seed=None):
    """Loss (with the MoE auxiliary losses) and gradients of one training
    forward; the dropout generator seeded with ``gen_seed``."""
    model.train()
    kw = {} if gen_seed is None else {"generator": torch.Generator().manual_seed(gen_seed)}
    logits = model(torch.as_tensor(inputs), **kw)
    loss = cross_entropy_loss(logits, torch.as_tensor(labels).long())
    aux = sown_aux_loss(model)
    if aux is not None:
        loss = loss + aux
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip(names, grads))


def test_remat_gradients_identical():
    import flax.linen as nn

    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
    from distributeddeeplearning_tpu.training.train_step import cross_entropy_loss as jce

    tokens, labels = _rows()
    jmodel = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=T, dtype=jnp.float32,
                   remat=True)
    params = nn.unbox(jax.jit(lambda k, x: jmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    sd = convert.params_from_flax(params)
    results = {}
    for remat in (False, True):
        model = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                          remat=remat, device="cpu")
        model.load_state_dict(sd)
        calls = []
        model.blocks[0].register_forward_pre_hook(lambda *a: calls.append(1))
        results[remat] = _grads(model, tokens, labels)
        assert len(calls) == 1 + remat
    assert abs(results[False][0] - results[True][0]) <= 1e-7 * abs(results[False][0])
    for k, g in results[False][1].items():
        np.testing.assert_allclose(results[True][1][k].numpy(), g.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)

    def loss_fn(p):
        return jce(jmodel.apply({"params": p}, jnp.asarray(tokens), train=False),
                   jnp.asarray(labels))

    want = convert.params_from_flax(jax.device_get(jax.jit(jax.grad(loss_fn))(params)))
    for k, g in results[True][1].items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)


def _lm(remat):
    model = get_model("lm_moe_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                      moe_experts=4, attn_impl="pallas", dropout=0.1, remat=remat, device="cpu")
    model.load_state_dict(convert.init_params("tiny", VOCAB, torch.Generator().manual_seed(3),
                                              T, 4))
    return model


def _vit(remat):
    model = get_model("vit_s16", num_classes=10, image_size=32, dtype=torch.float32,
                      attn_impl="fused", dropout=0.1, remat=remat, fused_dense_grad=True,
                      device="cpu")
    model.load_state_dict(convert.init_vit_params("s", 16, 10, torch.Generator().manual_seed(3),
                                                  32))
    return model


def _vit_batch(seed=0, b=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=(b,)).astype(np.int32))


@pytest.mark.parametrize("which", ["lm_moe_tiny", "vit_s16"])
def test_remat_with_dropout_gradients_equal_stored(which):
    make, batch = (_lm, _rows()) if which == "lm_moe_tiny" else (_vit, _vit_batch())
    (loss0, g0), (loss1, g1) = (_grads(make(r), *batch, gen_seed=17) for r in (False, True))
    assert loss0 == loss1
    for k, g in g0.items():
        np.testing.assert_allclose(g1[k].numpy(), g.numpy(), rtol=0, atol=1e-6, err_msg=k)
    # the masks matter: another seed moves the gradients
    _, g2 = _grads(make(True), *batch, gen_seed=18)
    assert any(not torch.equal(g2[k], g) for k, g in g0.items())


@pytest.mark.parametrize("which", ["lm_moe_tiny", "vit_s16"])
def test_remat_dropout_train_step_equals_stored(which):
    make, batch = (_lm, _rows()) if which == "lm_moe_tiny" else (_vit, _vit_batch())
    finals = []
    for remat in (False, True):
        model = make(remat)
        cfg = TrainConfig(model=which, compute_dtype="float32", base_lr=0.1, warmup_epochs=0,
                          lr_schedule="constant", batch_size_per_device=4, num_classes=10)
        tx, _ = create_optimizer(cfg, 10)
        state = create_train_state(model, cfg, tx, device="cpu",
                                   state_dict=dict(model.state_dict()))
        step = make_train_step(model, tx, cfg, device="cpu")
        state, m = step(state, batch)
        finals.append((float(m["loss"]), model.state_dict()))
    assert finals[0][0] == finals[1][0]
    for k, v in finals[0][1].items():
        np.testing.assert_allclose(finals[1][1][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_remat_is_off_when_decoding_and_without_grad():
    """JAX decodes without ``nn.remat``: a forward with a KV cache, or
    under ``no_grad``, runs each block once, with the stored path's
    logits."""
    from distributeddeeplearning_tpu_torch.inference import dense_cache

    sd = convert.init_params("tiny", VOCAB, torch.Generator().manual_seed(5), T)
    tokens = torch.as_tensor(_rows()[0]).long()
    out = {}
    for remat in (False, True):
        model = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                          remat=remat, device="cpu")
        model.load_state_dict(sd)
        calls = []
        model.blocks[0].register_forward_pre_hook(lambda *a: calls.append(1))
        cache = dense_cache(model, tokens.shape[0], T, "cpu")
        out[remat] = model(tokens, cache)  # autograd on: the cache alone turns remat off
        with torch.no_grad():
            model(tokens)
        assert len(calls) == 2
    assert torch.equal(out[False], out[True])
