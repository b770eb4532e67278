"""The port's speculative serving tier against the JAX package's.

* ``NgramDrafter`` proposals and ``validate_spec_config``'s errors equal
  JAX's (``serving/spec.py`` is a copy; these hold the copy to it).
* ``spec_verify_slots`` equals JAX's on random logits: greedy slots
  (argmax compare) and mixed batches, whose sampled rows accept with a
  uniform from ``fold_in(key, 0)`` and draw the residual or bonus token
  from ``fold_in(key, 1)``, JAX's threefry bits on both sides.
* Served streams on ``lm_tiny`` (f32): with the int8 self-draft (dense)
  and with prompt lookup (paged, fused kernel), greedy streams equal the
  JAX spec engine's and sequential ``generate``'s; sampled streams equal
  the JAX spec engine's (the acceptance compares a uniform with a
  softmax probability, so a near-tie of the two could flip one accept;
  none does on these seeds, and the test names the first divergence if
  one appears).
* Admission reserves ``spec_k`` lookahead positions (blocks and the
  dense window), and an eos inside a multi-token commit cuts the stream
  at the eos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serving_common import BUCKETS, MAX_LEN, VOCAB, jax_model_params, port_engine, serve

from distributeddeeplearning_tpu import inference as jax_inference
from distributeddeeplearning_tpu.serving import Request as JaxRequest
from distributeddeeplearning_tpu.serving import Server as JaxServer
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu.serving import sampling as jax_sampling
from distributeddeeplearning_tpu.serving import spec as jax_spec
from distributeddeeplearning_tpu_torch import inference
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.serving import (
    NgramDrafter,
    ReqSpec,
    Request,
    Server,
    sampling,
    spec_verify_slots,
)
from distributeddeeplearning_tpu_torch.serving.spec import validate_spec_config

K = 3
INT8_DRAFT = dict(spec_k=K, spec_draft="int8")
NGRAM_PAGED = dict(spec_k=K, spec_draft="ngram", kv_layout="paged", block_size=4,
                   decode_kernel="fused")


@pytest.fixture(scope="module")
def jax_lm():
    return jax_model_params()


@pytest.fixture(scope="module")
def state_dict(jax_lm):
    return convert.params_from_flax(jax_lm[1])


def _spec_requests():
    """Greedy-friendly prompts: two repeat a short motif (prompt lookup
    proposes from it), the rest are random; lengths leave room for the
    K lookahead positions under MAX_LEN."""
    rng = np.random.RandomState(21)
    motif = rng.randint(0, VOCAB, size=4).astype(np.int32)
    return [
        (np.tile(motif, 3), 8),
        (rng.randint(0, VOCAB, size=5).astype(np.int32), 10),
        (rng.randint(0, VOCAB, size=13).astype(np.int32), 7),
        (np.concatenate([motif, rng.randint(0, VOCAB, size=3), motif]).astype(np.int32), 9),
    ]


@pytest.fixture(scope="module", params=["int8-dense", "ngram-paged-fused"])
def engines(request, jax_lm, state_dict):
    """(kw, JAX spec engine, port spec engine), warmed, shared by the
    tests of one configuration."""
    kw = INT8_DRAFT if request.param == "int8-dense" else NGRAM_PAGED
    model, params = jax_lm
    jax_engine = JaxEngine(model, params, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS, **kw)
    jax_engine.warmup()
    return kw, jax_engine, port_engine(state_dict, **kw)


def _generate(state_dict, prompt, n):
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM

    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    model.load_state_dict(state_dict)
    return inference.generate(model, prompt[None], max_new_tokens=n)[0, prompt.shape[0]:].tolist()


def test_spec_greedy_streams_match_jax_and_generate(engines, jax_lm, state_dict):
    kw, jax_engine, engine = engines
    reqs = _spec_requests()
    ref = serve(JaxServer, JaxRequest, jax_engine, reqs)
    out = serve(Server, Request, engine, reqs)
    assert out == ref
    model, params = jax_lm
    for (prompt, n), toks in zip(reqs, out):
        want = np.asarray(jax_inference.generate(model, params, prompt[None],
                                                 max_new_tokens=n))[0, prompt.shape[0]:]
        assert toks == want.tolist() == _generate(state_dict, prompt, n)
    st = engine.spec_stats
    assert st["tokens_accepted"] > 0 and st["verify_ticks"] == engine.decode_steps
    assert st["tokens_accepted"] == jax_engine.spec_stats["tokens_accepted"]
    assert st["verify_ticks"] == jax_engine.spec_stats["verify_ticks"]


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def test_spec_sampled_streams_match_jax(engines):
    _, jax_engine, engine = engines
    reqs = _spec_requests()
    for req_kw in (dict(temperature=0.8, top_k=10, rng=3), dict(temperature=1.1, top_p=0.9, rng=4)):
        ref = serve(JaxServer, JaxRequest, jax_engine, reqs, **req_kw)
        out = serve(Server, Request, engine, reqs, **req_kw)
        for i, (got, want) in enumerate(zip(out, ref)):
            assert got == want, (
                f"request {i} ({req_kw}) diverges at token {_first_divergence(got, want)}")


def test_spec_verify_slots_matches_jax():
    rng = np.random.RandomState(5)
    s, k, vocab = 4, K, VOCAB
    jax_verify = jax.jit(jax_sampling.spec_verify_slots, static_argnames="top_k_cap")
    for trial in range(6):
        logits = (rng.randn(s, k + 1, vocab) * 2).astype(np.float32)
        greedy = logits.argmax(-1)
        drafts = rng.randint(0, vocab, size=(s, k)).astype(np.int32)
        take = rng.rand(s, k) < 0.7  # most drafts are the argmax: long accepts
        drafts[take] = greedy[:, :k][take]
        keys = rng.randint(0, 2 ** 32, size=(s, k + 1, 2), dtype=np.uint64).astype(np.uint32)
        temps = np.zeros(s, np.float32) if trial < 2 else np.asarray(
            [0.0, 0.7, 1.3, 0.9], np.float32)
        top_ks = np.asarray([0, 8, 0, 20], np.int32)
        top_ps = np.asarray([0.0, 0.0, 0.9, 0.8], np.float32)
        ref_c, ref_a = jax_verify(
            jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(keys), jnp.asarray(temps),
            jnp.asarray(top_ks), jnp.asarray(top_ps), top_k_cap=16)
        got_c, got_a = spec_verify_slots(torch.from_numpy(logits), drafts, keys, temps,
                                         top_ks, top_ps, top_k_cap=16)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
        a = np.asarray(ref_a)
        for row in range(s):  # entries past accepted + 1 are padding
            np.testing.assert_array_equal(got_c.numpy()[row, :a[row] + 1],
                                          np.asarray(ref_c)[row, :a[row] + 1])


def test_fold_keys_and_key_uniforms_are_jax_bits():
    keys = np.random.RandomState(2).randint(0, 2 ** 32, size=(5, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    for data in (0, 1, 7):
        ref = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.wrap_key_data(jnp.asarray(k)), data))) for k in keys])
        np.testing.assert_array_equal(sampling.fold_keys(keys, data), ref)
    ref_u = np.asarray([jax.random.uniform(jax.random.wrap_key_data(jnp.asarray(k)))
                        for k in keys])
    np.testing.assert_array_equal(sampling.key_uniforms(keys, "cpu").numpy(), ref_u)


def test_ngram_drafter_matches_jax():
    rng = np.random.RandomState(8)
    for n in (2, 3, 4):
        port, ref = NgramDrafter(n), jax_spec.NgramDrafter(n)
        for _ in range(40):
            hist = rng.randint(0, 6, size=rng.randint(0, 20)).tolist()
            for k in (1, 3, 5):
                np.testing.assert_array_equal(port.propose(hist, k), ref.propose(hist, k))
        assert port.stats == ref.stats


@pytest.mark.parametrize("args", [
    (-1, "int8", 3, "bf16"), (2, "eagle", 3, "bf16"), (2, "int8", 3, "int8"),
    (2, "int8", 3, "fp8"), (2, "ngram", 1, "bf16"),
])
def test_validate_spec_config_errors_match_jax(args):
    with pytest.raises(ValueError) as port_err:
        validate_spec_config(*args)
    with pytest.raises(ValueError) as jax_err:
        jax_spec.validate_spec_config(*args)
    assert str(port_err.value) == str(jax_err.value)
    validate_spec_config(0, "anything", 0, "fp8")  # speculation off: knobs inert


def test_lookahead_reserved_at_admission(state_dict):
    """Paged: ``blocks_needed`` grows by the lookahead, so a request that
    fits the pool without it waits; dense: a request whose verify window
    would pass ``max_len`` is refused."""
    kw = dict(kv_layout="paged", block_size=4, num_blocks=9, prefix_cache=False)
    base = port_engine(state_dict, **kw)
    spec = port_engine(state_dict, spec_k=K, spec_draft="ngram", **kw)
    assert base.blocks_needed(8, 9) == 4 and spec.blocks_needed(8, 9) == 5
    req = ReqSpec(np.zeros(8, np.int32), 9)
    base.allocator.alloc(4)
    spec.allocator.alloc(4)
    assert base.can_admit(req) and not spec.can_admit(req)
    small = port_engine(state_dict, spec_k=K, spec_draft="ngram", **dict(kw, num_blocks=6))
    with pytest.raises(ValueError, match="KV blocks"):  # 7 blocks of a 5-block pool
        small.validate_spec(ReqSpec(np.zeros(16, np.int32), 10))
    dense = port_engine(state_dict, spec_k=K, spec_draft="ngram")
    dense.validate_spec(ReqSpec(np.zeros(16, np.int32), MAX_LEN - 16 - K))
    with pytest.raises(ValueError, match="lookahead"):
        dense.validate_spec(ReqSpec(np.zeros(16, np.int32), MAX_LEN - 16))


def test_eos_truncates_mid_commit(engines, state_dict):
    """An eos inside a multi-token commit ends the stream at the eos, as
    the non-speculative engine and ``generate`` would."""
    _, _, engine = engines
    prompt = _spec_requests()[0][0]
    ref = _generate(state_dict, prompt, 12)
    eos = ref[4]
    server = Server(engine)
    h = server.submit(Request(prompt=prompt, max_new_tokens=12, eos_token=eos))
    server.drain()
    assert h.finish_reason == "eos"
    assert h.new_tokens == ref[:ref.index(eos) + 1]
    assert engine.occupancy == 0.0
