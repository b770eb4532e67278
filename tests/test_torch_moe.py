"""The port's MoE FFN (``models/moe.py``) against the JAX package's
``MoEMlpBlock`` on the same flax parameters and numpy inputs (f32).

* Twins of the JAX tests: identical experts equal the dense MLP; a tiny
  capacity drops the overflow tokens (their rows exactly zero); the
  load-balance loss near its weight at uniform routing and larger when
  the router collapses; the top-1 router gets a gradient through the
  output.
* The block against flax's with k = 1 and 2 and capacity factors that
  drop tokens (0.5), keep most (1.25) and drop none (8): outputs within
  1e-5 (measured 6e-8), the auxiliary loss within 1e-6 relative, and the
  gradients of ``Σ y·c + aux`` with respect to every parameter and the
  input within 1e-5 of their largest value (measured 3.4e-7). A uniform
  router (every gate equal) takes the first expert on both sides:
  ``torch.argmax`` and ``jnp.argmax`` both take the first maximum.
* One-hot encoding of an out-of-range slot is a zero row, as
  ``jax.nn.one_hot``'s, where ``F.one_hot`` raises.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.moe import MoEMlpBlock as JaxMoE
from distributeddeeplearning_tpu_torch.models.moe import MoEMlpBlock, one_hot_f32

D, H = 16, 32


@functools.lru_cache(maxsize=None)
def _jax_layer(e, k, cf, aux_loss_weight):
    """A flax layer and its jitted ``apply`` (outputs and sown losses);
    cached, so that each configuration compiles once."""
    layer = JaxMoE(num_experts=e, mlp_dim=H, num_selected=k, capacity_factor=cf,
                   aux_loss_weight=aux_loss_weight, dtype=jnp.float32)
    return layer, jax.jit(lambda p, xx: layer.apply({"params": p}, xx, train=True,
                                                    mutable=["losses"]))


@functools.lru_cache(maxsize=None)
def _jax_init(e):
    # the parameters' shapes depend on the experts and widths only
    return jax.jit(lambda key, xx: _jax_layer(e, 2, 8.0, 1e-2)[0].init(key, xx, train=False))


def _pair(e=4, k=2, cf=8.0, aux_loss_weight=1e-2, seed=0, shape=(2, 12)):
    """A flax layer, its parameters (numpy), the port's layer holding them
    and the numpy input. Every test uses the same widths, so that JAX's
    compiled programs are shared."""
    layer = _jax_layer(e, k, cf, aux_loss_weight)[0]
    x = np.random.RandomState(seed).randn(*shape, D).astype(np.float32)
    params = jax.device_get(fnn.unbox(_jax_init(e)(jax.random.PRNGKey(seed),
                                                   jnp.asarray(x))["params"]))
    params = {k_: np.array(v) for k_, v in params.items()}
    port = MoEMlpBlock(D, e, H, k, cf, aux_loss_weight, dtype=torch.float32, device="cpu")
    _load(port, params)
    return layer, params, port, x


def _load(port, params):
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()})


def _jax_out(layer, params, x):
    apply = _jax_layer(layer.num_experts, layer.num_selected, layer.capacity_factor,
                       layer.aux_loss_weight)[1]
    y, mut = apply(params, jnp.asarray(x))
    (aux,) = jax.tree.leaves(mut["losses"])
    return np.asarray(y), float(aux)


def test_identical_experts_match_dense_mlp():
    layer, p, port, x = _pair()
    for name in ("w1", "w2", "b1", "b2"):
        p[name] = np.broadcast_to(p[name][:1], p[name].shape).copy()
    _load(port, p)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    w1, b1, w2, b2 = (torch.from_numpy(p[n][0]) for n in ("w1", "b1", "w2", "b2"))
    xt = torch.from_numpy(x)
    ref = (torch.nn.functional.gelu(xt @ w1 + b1, approximate="tanh") @ w2 + b2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, _jax_out(layer, p, x)[0], atol=1e-5)


def test_capacity_drops_overflow_tokens():
    """capacity = ceil(1·12/4·0.25) = 1 slot an expert: at most 4 of each
    row's 12 tokens are processed, every other row is exactly zero."""
    layer, p, port, x = _pair(e=4, k=1, cf=0.25, seed=1)
    assert port.capacity(12) == 1
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    live = np.abs(got).sum(-1) > 1e-9
    assert all(1 <= n <= 4 for n in live.sum(-1)), live.sum(-1)
    want = _jax_out(layer, p, x)[0]
    np.testing.assert_array_equal(live, np.abs(want).sum(-1) > 1e-9)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_aux_loss_sown_and_skew_sensitive():
    layer, p, port, x = _pair(e=4, k=1, seed=2)
    p_uniform = dict(p, router=np.zeros_like(p["router"]))
    _load(port, p_uniform)
    with torch.no_grad():
        port(torch.from_numpy(x))
    aux_uniform = float(port.aux_loss)
    # uniform gates: every argmax a tie, taken by the first expert
    assert port.route(torch.from_numpy(x), 24)[0][..., 0, :].sum() == 24
    assert 0.0 < aux_uniform <= 2 * port.aux_loss_weight
    assert abs(aux_uniform - _jax_out(layer, p_uniform, x)[1]) <= 1e-7
    p_skew = dict(p_uniform, router=np.zeros_like(p["router"]))
    p_skew["router"][:, 0] = 100.0
    _load(port, p_skew)
    with torch.no_grad():
        port(torch.from_numpy(np.abs(x)))
    assert float(port.aux_loss) > 2.0 * aux_uniform
    assert abs(float(port.aux_loss) - _jax_out(layer, p_skew, np.abs(x))[1]) <= 1e-6


def test_top1_router_gets_output_gradient():
    _, _, port, x = _pair(e=4, k=1, cf=1.25, aux_loss_weight=0.0, seed=3)
    port(torch.from_numpy(x)).sum().backward()
    assert port.router.grad is not None and port.router.grad.abs().max() > 0


@pytest.mark.parametrize("k,cf,uniform", [(1, 0.5, False), (2, 0.5, False), (1, 1.25, False),
                                          (2, 1.25, False), (2, 8.0, False), (2, 1.25, True)])
def test_block_matches_flax_block(k, cf, uniform):
    layer, p, port, x = _pair(e=4, k=k, cf=cf, seed=4)
    if uniform:
        p["router"] = np.zeros_like(p["router"])
        _load(port, p)
    cot = np.random.RandomState(5).randn(*x.shape).astype(np.float32)

    def loss(params, xx):
        y, mut = layer.apply({"params": params}, xx, train=True, mutable=["losses"])
        aux = sum(jax.tree.leaves(mut["losses"]))
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (want_y, want_aux)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    want_aux = float(want_aux)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    ((y * torch.from_numpy(cot)).sum() + port.aux_loss).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=0, atol=1e-5)
    assert abs(float(port.aux_loss.detach()) - want_aux) <= 1e-6 * abs(want_aux)
    grads = dict(port.named_parameters())
    for name, want in list(want_gp.items()) + [("x", want_gx)]:
        got = xt.grad if name == "x" else grads[name].grad
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-6), err_msg=name)
    if cf == 0.5:  # capacity 1·12/4·0.5 = 2 (k = 1) or 3: some pairs dropped
        c = port.capacity(12)
        dispatch, _, _ = port.route(torch.from_numpy(x), c)
        assert float(dispatch.sum()) < 2 * 12 * k


def test_one_hot_out_of_range_rows_are_zero():
    idx = torch.tensor([[0, 3, 4, -1]])
    got = one_hot_f32(idx, 4)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx.numpy()), 4, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 2:].abs().sum() == 0


def test_init_params_tree_and_fans_match_flax():
    """``convert.init_params`` with experts builds flax's ``lm_moe_tiny``
    tree (names and shapes, every second block routed), round-trips
    through the converter, and draws with flax's fans: the router
    normal(0.02), ``w1``/``w2`` xavier-uniform over ``e·d`` and ``e·h``."""
    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
    from distributeddeeplearning_tpu_torch.models import convert

    e, vocab, seq = 8, 64, 32
    model = JaxLM(variant="tiny", vocab_size=vocab, max_seq_len=seq, dtype=jnp.float32,
                  moe_experts=e)
    shapes = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, seq), jnp.int32),
                                                 train=False), jax.random.PRNGKey(0))
    want = {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(
        fnn.unbox(shapes["params"]))[0]}
    sd = convert.init_params("tiny", vocab, torch.Generator().manual_seed(0), seq, e)
    tree = convert.params_to_flax(sd)
    got = {k: v.shape for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want
    back = convert.params_from_flax(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    d, h = 128, 512
    w1 = sd["blocks.1.moe.w1"]
    bound = (6.0 / (e * d + e * h)) ** 0.5
    assert w1.abs().max() <= bound and abs(w1.std().item() - bound / 3 ** 0.5) < 0.02 * bound
    assert abs(sd["blocks.1.moe.router"].std().item() - 0.02) < 2e-3
    assert not sd["blocks.1.moe.b1"].any() and "blocks.0.mlp.fc1.weight" in sd
