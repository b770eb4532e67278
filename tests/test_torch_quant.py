"""The port's ``ops/quant.py`` against the JAX package's.

The quantizers run the same f32 operations in the same order (``x /
scale``, round half to even or clip, cast), so codes, scales and
dequantized values are held BITWISE equal, not within a tolerance: on
f32 and bf16 inputs, with an all-zero slice (scale 1) and values at the
fp8 extremes (±448·scale). The weight pass is held to JAX's through the
converter: JAX's quantized ``lm_tiny`` tree carried across by
``params_from_flax`` equals the port's own pass over the carried f32
tree, code for code, and maps back. JAX's functions run eagerly here, op
by op: under ``jax.jit`` XLA rewrites ``amax / 127`` into ``amax *
(1 / 127)``, which moves about 4 % of the scales by one ulp (the codes
stayed equal on these inputs); ``test_torch_serving_quant.py`` holds the
JAX engine's jitted pools to the port's with that allowance.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
from distributeddeeplearning_tpu.ops import quant as jq
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.ops import quant

VOCAB, MAX_LEN = 64, 32


def _codes(t: torch.Tensor) -> np.ndarray:
    """A torch int8/fp8 tensor's codes as numpy (fp8 as its bits)."""
    if t.dtype == torch.int8:
        return t.numpy()
    return t.view(torch.uint8).numpy()


def _jcodes(a) -> np.ndarray:
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.view(np.uint8)


def _kv_input(seed=0):
    """[4, 64, 12, 64] f32 with per-head spreads, one all-zero slice and
    one slice whose amax is hit exactly by several entries."""
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 64, 12, 64).astype(np.float32)
    x *= rng.uniform(0.01, 30, size=(1, 1, 12, 1)).astype(np.float32)
    x[1, 3, 5] = 0.0
    x[2, 7, 1, ::8] = 448.0 * 3.0
    x[2, 7, 1, 4::8] = -448.0 * 3.0
    return x


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_and_dequantize_bitwise_equal_jax(kind, dtype):
    x = _kv_input()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jqz, jscale = (jq.quantize_fp8 if kind == "fp8" else jq.quantize_int8)(jx, axis=-1)
    tq, tscale = (quant.quantize_fp8 if kind == "fp8" else quant.quantize_int8)(tx, axis=-1)
    np.testing.assert_array_equal(_codes(tq), _jcodes(jqz))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
    assert tscale[1, 3, 5].item() == 1.0  # the zero slice
    for out_dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = quant.dequantize_store(tq, tscale, out_dt).float().numpy()
        want = np.asarray(jq.dequantize_store(jqz, jscale, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)
    # the registry dispatch and the aliases are the same functions
    kq, ks = quant.quantize_kv(tx, kind)
    np.testing.assert_array_equal(_codes(kq), _codes(tq))
    assert torch.equal(quant.dequantize_int8(tq, tscale), quant.dequantize_fp8(tq, tscale))


def test_store_dtypes_and_validation_name_the_same_lists():
    assert quant.KV_DTYPES == jq.KV_DTYPES and quant.WEIGHT_DTYPES == jq.WEIGHT_DTYPES
    assert quant.kv_store_dtype("int8") == torch.int8
    assert quant.kv_store_dtype("fp8") == torch.float8_e4m3fn
    assert quant.kv_store_dtype("bf16") is None and quant.kv_store_dtype("") is None
    for kind in ("kv_dtype", "weight_dtype"):
        with pytest.raises(ValueError) as port_err:
            quant.validate_store_dtype(kind, "fp4")
        with pytest.raises(ValueError) as jax_err:
            jq.validate_store_dtype(kind, "fp4")
        assert str(port_err.value) == str(jax_err.value)
    assert quant.fp8_supported("cpu")


@pytest.fixture(scope="module")
def flax_params():
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, MAX_LEN), jnp.int32),
                           train=False)
    return nn.unbox(variables["params"])


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_params_through_converter_matches_port_pass(flax_params, kind):
    jax_q = jq.quantize_params(flax_params, dtype=kind)
    carried = convert.params_from_flax(jax_q)
    port_q = quant.quantize_params(convert.params_from_flax(flax_params), kind)
    assert sorted(carried) == sorted(port_q)
    assert "blocks.0.attn.qkv.weight_q" in port_q and "tok_embed_scale" in port_q
    assert port_q["blocks.0.mlp.fc1.weight_scale"].shape == (512, 1)
    for name, t in port_q.items():
        got = carried[name]
        assert got.dtype == t.dtype and got.shape == t.shape, name
        if name.endswith("_q"):
            np.testing.assert_array_equal(_codes(got), _codes(t))
        else:
            assert torch.equal(got, t), name
    # and back: the port's quantized state maps to JAX's tree, leaf for leaf
    back = jax.tree_util.tree_flatten_with_path(convert.params_to_flax(port_q))[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(jax_q)[0])
    assert len(back) == len(ref)
    for path, leaf in back:
        want = np.asarray(ref[path])
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, path
        if want.dtype == np.float32:
            np.testing.assert_array_equal(leaf, want)
        else:
            np.testing.assert_array_equal(_jcodes(leaf), _jcodes(want))
    assert quant.is_quantized(port_q)
    assert not quant.is_quantized(convert.params_from_flax(flax_params))
    with pytest.raises(ValueError, match="already quantized"):
        quant.quantize_params(port_q, kind)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_tree_byte_split_and_dequantize_params_match_jax(flax_params, kind):
    jax_q = jq.quantize_params(flax_params, dtype=kind)
    port_q = quant.quantize_params(convert.params_from_flax(flax_params), kind)
    assert quant.tree_byte_split(port_q) == jq.tree_byte_split(jax_q)
    assert quant.quantized_bytes(quant.tree_byte_split(port_q)) == jq.quantized_bytes(
        jq.tree_byte_split(jax_q))
    deq = quant.dequantize_params(port_q)
    ref = convert.params_from_flax(jq.dequantize_params(jax_q))
    assert sorted(deq) == sorted(ref)
    for name in ref:
        assert torch.equal(deq[name], ref[name]), name


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_model_forward_equals_dequantized_weights(flax_params, kind):
    """A quantized TransformerLM computes exactly what the same model
    loaded with the dequantized weights computes (JAX's dequant-on-use),
    with and without the held copies of the draft's tick."""
    state = convert.params_from_flax(flax_params)

    def lm():
        return TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                             dtype=torch.float32, device="cpu")

    q_model = lm()
    q_model.load_state_dict(state)
    q_model.quantize_weights_(kind).cast_matmul_weights_()
    ref_model = lm()
    ref_model.load_state_dict(quant.dequantize_params(quant.quantize_params(state, kind)))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, VOCAB, (2, 12)))
    with torch.no_grad():
        want = ref_model(tokens)
        got = q_model(tokens)
        with quant.hold_dequantized(q_model, torch.float32):
            held = q_model(tokens)
    assert torch.equal(got, want) and torch.equal(held, want)
    assert quant.held(q_model.blocks[0].attn.qkv) is None  # dropped on exit
    assert not any(n.endswith(".weight") and p.dim() == 2
                   for n, p in q_model.named_parameters())
