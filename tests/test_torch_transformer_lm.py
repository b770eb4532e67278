"""The port's TransformerLM against the JAX package's, on converted
weights.

Tolerances: the f32 forwards run the same ops in another order (torch's
and XLA's CPU matmuls and reductions), each contributing f32 round-off
(~1e-7 relative) that two layers and a softmax compound; logits of the
tiny model are O(1), so they are held to rtol 1e-4 / atol 1e-4.
Incremental decode against a full re-forward, both in the port, differs
by the same kind of reassociation only (masked softmax over a longer
static buffer) and is held to 1e-5.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import inference as jax_inference
from distributeddeeplearning_tpu.models import get_model as jax_get_model
from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
from distributeddeeplearning_tpu_torch import inference
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.models.vit import KVCache

VOCAB, MAX_LEN = 64, 32


@pytest.fixture(scope="module")
def flax_params():
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                  dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, MAX_LEN), jnp.int32), train=False)
    return model, nn.unbox(variables["params"])


@pytest.fixture(scope="module")
def torch_model(flax_params):
    _, params = flax_params
    m = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                      dtype=torch.float32, device="cpu")
    m.load_state_dict(convert.params_from_flax(params))
    return m.eval()


def test_params_from_flax_round_trip(flax_params):
    _, params = flax_params
    back = convert.params_to_flax(convert.params_from_flax(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])
    state = convert.params_from_flax(params)
    w = state["blocks.0.attn.qkv.weight"]
    assert tuple(w.shape) == (3 * 128, 128)  # Dense [in,out] -> [out,in]
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["block0"]["attn"]["qkv"]["kernel"]).T
    )


@pytest.mark.parametrize("variant", ["tiny", "small", "base", "large"])
def test_param_count_equals_jax(variant):
    jm = jax_get_model(f"lm_{variant}")
    shapes = jax.eval_shape(
        lambda r: jm.init(r, jnp.zeros((1, 8), jnp.int32), train=False),
        jax.random.PRNGKey(0),
    )["params"]
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tm = get_model(f"lm_{variant}", device="meta")
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax
    if variant == "base":
        assert n_port == 111_204_864
    # init_params fills exactly the model's state dict
    if variant == "tiny":
        sd = convert.init_params("tiny", 32_000, torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in tm.state_dict().items()
        }


def test_full_forward_logits_match_jax(flax_params, torch_model):
    model, params = flax_params
    tokens = np.random.RandomState(0).randint(0, VOCAB, size=(2, 12)).astype(np.int32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(tokens), train=False))
    with torch.no_grad():
        out = torch_model(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_incremental_decode_equals_full_reforward(torch_model, layout):
    """Prompt prefill + one token at a time through the KV cache gives the
    logits of a full forward over the whole sequence at every step."""
    seq = np.random.RandomState(1).randint(0, VOCAB, size=(2, 10))
    seq_t = torch.from_numpy(seq).long()
    with torch.no_grad():
        full = torch_model(seq_t)
        if layout == "dense":
            cache = inference.dense_cache(torch_model, 2, MAX_LEN, "cpu")
        else:
            k, v = inference.paged_pools(torch_model, 1 + 2 * 8, 4, "cpu")
            table = torch.tensor([[1 + j for j in range(8)],
                                  [9 + j for j in range(8)]], dtype=torch.int32)
            cache = KVCache(k, v, block_table=table, block_size=4,
                            decode_kernel="fused")
        cache.index = torch.zeros(2, dtype=torch.long)
        step = [torch_model(seq_t[:, :6], cache)]
        for i in range(6, 10):
            cache.index = torch.full((2,), i, dtype=torch.long)
            step.append(torch_model(seq_t[:, i:i + 1], cache))
    inc = torch.cat(step, dim=1)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_greedy_generate_matches_jax(flax_params, torch_model):
    model, params = flax_params
    prompt = np.random.RandomState(2).randint(0, VOCAB, size=(2, 5)).astype(np.int32)
    ref = np.asarray(jax_inference.generate(
        model, params, jnp.asarray(prompt), max_new_tokens=8
    ))
    out = inference.generate(torch_model, prompt, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(out, ref)
