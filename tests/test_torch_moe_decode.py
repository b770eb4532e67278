"""MoE LM serving of the port: decoding drops no token.

* The twin of JAX's ``test_greedy_cache_matches_full_forward_moe``: an
  ``lm_tiny`` with 4 routed experts and a capacity factor of 0.5 (it
  drops tokens in training) decodes greedily through ``generate`` (KV
  cache, capacity factor e) equal to the full re-forward of a no-drop
  model (capacity factor e) token for token, and equal to JAX's
  ``generate`` on the same flax parameters (f32).
* ``SlotEngine`` serves the same model, dense and paged with the ``xla``
  decode path and paged with the ``fused`` one (its plain version here;
  bucketed prefills pad the prompt, which must not move a real token's
  routing): every greedy stream equals the request's ``generate``
  stream; a model built with dropout and left in train mode decodes
  without drawing a mask.
* The serving tier's weight quantization leaves the experts and the
  router as they are (JAX's quantizer covers 2-D ``kernel`` leaves
  only); ``cast_matmul_weights_`` stores the experts in the compute
  dtype and keeps the router f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.inference import generate
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine

VOCAB, MAX_LEN, EXPERTS = 64, 32, 4
BUCKETS = (8, 16)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_model(cf):
    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM

    return JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=jnp.float32,
                 moe_experts=EXPERTS, moe_capacity_factor=cf)


@pytest.fixture(scope="module")
def flax_params():
    import flax.linen as nn

    init = jax.jit(lambda key, x: _jax_model(0.5).init(key, x, train=False))
    return nn.unbox(init(jax.random.PRNGKey(1), jnp.zeros((1, MAX_LEN), jnp.int32))["params"])


def _port(state_dict, cf=0.5, dtype=torch.float32):
    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=dtype,
                          device="cpu", moe_experts=EXPERTS, moe_capacity_factor=cf)
    model.load_state_dict(state_dict)
    return model.eval()


def _greedy_reforward(model, prompt, n_new):
    seq = torch.as_tensor(prompt, dtype=torch.long)
    with torch.no_grad():
        for _ in range(n_new):
            nxt = model(seq)[:, -1].argmax(-1)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq.numpy()


def test_greedy_cache_matches_full_forward_moe(flax_params):
    from distributeddeeplearning_tpu.inference import generate as jax_generate

    sd = convert.params_from_flax(flax_params)
    prompt = np.random.RandomState(1).randint(0, VOCAB, size=(2, 4)).astype(np.int32)
    got = generate(_port(sd), prompt, max_new_tokens=6).numpy()
    ref = _greedy_reforward(_port(sd, cf=float(EXPERTS)), prompt, 6)
    np.testing.assert_array_equal(got, ref)
    want = np.asarray(jax_generate(_jax_model(0.5), flax_params, prompt, max_new_tokens=6))
    np.testing.assert_array_equal(got, want)
    # the training capacity drops tokens on this prompt's full forward,
    # so the no-drop decode is not a trivial case
    model, seen = _port(sd), {}
    moe = model.blocks[1].moe
    moe.register_forward_pre_hook(lambda m, args: seen.update(x=args[0]))
    with torch.no_grad():
        model(torch.as_tensor(ref, dtype=torch.long))
        dispatch, _, _ = moe.route(seen["x"], moe.capacity(ref.shape[1]))
    assert float(dispatch.sum()) < 2 * ref.size


@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="paged", block_size=4),
                                dict(kv_layout="paged", block_size=4, decode_kernel="fused")],
                         ids=["dense-xla", "paged-xla", "paged-fused"])
def test_slot_engine_streams_equal_generate(flax_params, kw):
    sd = convert.params_from_flax(flax_params)
    rng = np.random.RandomState(11)
    reqs = [(rng.randint(0, VOCAB, size=(n,)).astype(np.int32), m)
            for n, m in ((3, 6), (11, 5), (16, 4), (5, 7))]
    kw = {"decode_kernel": "xla", **kw}
    engine = SlotEngine(_port(sd), sd, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS,
                        device="cpu", **kw)
    server = Server(engine, prefills_per_step=1)
    handles = [server.submit(Request(prompt=p, max_new_tokens=m)) for p, m in reqs]
    server.drain()
    assert all(h.status == "done" for h in handles)
    model = _port(sd)
    for (prompt, m), h in zip(reqs, handles):
        want = generate(model, prompt[None], max_new_tokens=m)[0, len(prompt):].tolist()
        assert [int(t) for t in h.new_tokens] == want


def test_quantization_leaves_the_experts_and_router():
    sd = convert.init_params("tiny", VOCAB, torch.Generator().manual_seed(0), MAX_LEN,
                             EXPERTS)
    model = _port(sd, dtype=torch.bfloat16)
    moe = model.blocks[1].moe
    before = {n: p.detach().clone() for n, p in moe.named_parameters()}
    model.quantize_weights_("int8")
    assert {n for n, _ in moe.named_parameters()} == set(before)
    assert all(torch.equal(p, before[n]) for n, p in moe.named_parameters())
    assert hasattr(model.blocks[1].attn.qkv, "weight_q")
    model.cast_matmul_weights_()
    assert moe.router.dtype == torch.float32
    assert all(getattr(moe, n).dtype == torch.bfloat16 for n in ("w1", "b1", "w2", "b2"))


def test_generate_draws_no_dropout_mask(flax_params, monkeypatch):
    from distributeddeeplearning_tpu_torch.models import efficientnet

    sd = convert.params_from_flax(flax_params)
    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=torch.float32,
                          device="cpu", moe_experts=EXPERTS, moe_capacity_factor=0.5,
                          dropout=0.1)
    model.load_state_dict(sd)
    model.train()

    def refuse(*a, **k):
        raise AssertionError("decoding drew a dropout mask")

    monkeypatch.setattr(efficientnet, "keep_mask", refuse)
    prompt = np.random.RandomState(2).randint(0, VOCAB, size=(1, 5)).astype(np.int32)
    got = generate(model, prompt, max_new_tokens=4)
    np.testing.assert_array_equal(got.numpy(), generate(_port(sd), prompt, max_new_tokens=4))
