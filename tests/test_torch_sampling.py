"""The port's sampled draws against ``jax.random``'s.

The port's sampler computes ``jax.random.categorical``'s Gumbel-max draw
from JAX's own threefry bits (``serving/sampling.py``):

* the uniforms are **bitwise** ``jax.random.uniform(key, (1, V),
  minval=tiny, maxval=1.)``;
* the Gumbel noise ``-log(-log(u))`` of the port and of
  ``jax.random.gumbel`` each lies within ``4·2**-23·max(1, |g|)`` of the
  f64 truth computed from the same (bitwise equal) uniforms: the two
  libraries' ``log`` differ in the last bits, so a token can flip only
  on a near-tie of two noisy logits, which these seeded cases do not
  hit;
* so ``sample_slot`` / ``sample_slots`` return the JAX sampler's token,
  and sampled ``lm_tiny`` streams served by the port equal the JAX
  ``Server``'s on the same f32 weights.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
from distributeddeeplearning_tpu.serving import Request as JaxRequest
from distributeddeeplearning_tpu.serving import Server as JaxServer
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu.serving import sampling as jax_sampling
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine, keys, sampling

VOCAB, MAX_LEN = 64, 32
TINY = np.finfo(np.float32).tiny
SEEDS = (0, 1, 7, 2**31 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bitwise_equal_jax(seed):
    v = 32_000
    key = keys.key_from_seed(seed)
    got = sampling.gumbel_uniforms(key[None], v, "cpu").numpy()[0]
    ref = np.asarray(jax.random.uniform(jnp.asarray(key), (1, v), minval=TINY, maxval=1.0))[0]
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniforms_batched_rows_equal_each_key_alone():
    ks = np.stack([keys.key_from_seed(s) for s in SEEDS])
    batched = sampling.gumbel_uniforms(ks, 1000, "cpu").numpy()
    for i, k in enumerate(ks):
        alone = sampling.gumbel_uniforms(k[None], 1000, "cpu").numpy()[0]
        np.testing.assert_array_equal(batched[i].view(np.uint32), alone.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_noise_within_log_roundoff_of_jax(seed):
    """Each library's noise against the f64 truth ``-log(-log(u))`` of
    the same f32 uniforms, not one library against the other. With
    ``w = -log(u)``: an error of at most 2 ulps in ``w`` (``w`` near 1,
    where g is near 0, has ulps of 2**-23) moves ``g = -log(w)`` by at
    most 2·2**-23 absolute; the outer log adds at most 2 ulps of ``|g|``;
    the f32 roundings sit inside those ulps. So each library's g lies
    within 4·2**-23·max(1, |g|) of the truth. Measured on the CPU at
    V = 32,000: the port 0.20-0.21 and JAX 0.29-0.32 of that limit.
    (torch's CPU ``log`` goes through MKL's vector math, whose code path
    depends on the CPU and the process; XLA's CPU ``log`` is its own
    polynomial: an earlier test held the two to 2**-22·max(1, |g|) of
    each other, which the sum of their errors can exceed.)"""
    v = 32_000
    key = keys.key_from_seed(seed)
    u = sampling.gumbel_uniforms(key[None], v, "cpu")[0]
    got = (-torch.log(-torch.log(u))).numpy()
    ref = np.asarray(jax.random.gumbel(jnp.asarray(key), (1, v)))[0]
    truth = -np.log(-np.log(u.numpy().astype(np.float64)))
    limit = 4 * 2.0 ** -23 * np.maximum(1.0, np.abs(truth))
    for name, g in (("port", got), ("jax", ref)):
        err = np.abs(g.astype(np.float64) - truth)
        assert np.all(err <= limit), (name, np.max(err / limit))


CONFIGS = [(0.8, 5, 0.0), (0.8, 0, 0.7), (1.3, 6, 0.5), (0.8, 200, 0.9), (1.0, 0, 0.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", CONFIGS)
def test_sample_slot_returns_jax_token(temperature, top_k, top_p):
    for seed in range(8):
        logits = np.random.RandomState(seed).randn(VOCAB).astype(np.float32) * 3
        key = keys.key_from_seed(100 + seed)
        ref = jax_sampling.sample_slot(jnp.asarray(logits), jnp.asarray(key),
                                       jnp.float32(temperature), jnp.int32(top_k),
                                       jnp.float32(top_p))
        got = sampling.sample_slot(torch.from_numpy(logits), key, temperature, top_k, top_p)
        assert int(got) == int(ref), (seed, int(got), int(ref))


def test_sample_slots_batch_returns_jax_tokens():
    """A mixed tick (greedy and sampled slots, top-k and nucleus): every
    slot's token is the JAX sampler's for that slot."""
    rng = np.random.RandomState(3)
    s = 6
    logits = rng.randn(s, VOCAB).astype(np.float32) * 3
    ks = np.stack([keys.key_from_seed(40 + i) for i in range(s)])
    temps = np.array([0.0, 0.8, 1.1, 0.0, 0.9, 0.7], np.float32)
    top_ks = np.array([0, 5, 0, 3, 12, 0], np.int32)
    top_ps = np.array([0.0, 0.0, 0.8, 0.0, 0.6, 0.0], np.float32)
    got = sampling.sample_slots(torch.from_numpy(logits), ks, temps, top_ks, top_ps)
    ref = jax_sampling.sample_slots(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(temps),
                                    jnp.asarray(top_ks), jnp.asarray(top_ps))
    assert got.tolist() == np.asarray(ref).tolist()


def _requests():
    rng = np.random.RandomState(5)
    return [(rng.randint(0, VOCAB, size=(n,)).astype(np.int32), m)
            for n, m in ((3, 6), (11, 7), (12, 4), (5, 9))]


@pytest.fixture(scope="module")
def tiny_lm():
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((2, MAX_LEN), jnp.int32),
                           train=False)
    params = nn.unbox(variables["params"])
    return model, params, convert.params_from_flax(params)


@pytest.mark.parametrize("req_kw", [
    pytest.param(dict(temperature=0.8, top_k=10), id="top_k"),
    pytest.param(dict(temperature=1.0, top_p=0.9), id="nucleus"),
])
def test_sampled_streams_match_jax_server(tiny_lm, req_kw):
    model, params, state_dict = tiny_lm
    kw = dict(kv_layout="paged", block_size=4, decode_kernel="fused")
    reqs = _requests()

    def serve(server_cls, request_cls, engine):
        server = server_cls(engine, prefills_per_step=1)
        handles = [server.submit(request_cls(prompt=p, max_new_tokens=m, rng=20 + i, **req_kw))
                   for i, (p, m) in enumerate(reqs)]
        server.drain()
        assert all(h.status == "done" for h in handles)
        return [list(h.new_tokens) for h in handles]

    ref = serve(JaxServer, JaxRequest,
                JaxEngine(model, params, num_slots=3, max_len=MAX_LEN, buckets=(8, 16), **kw))
    port = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=torch.float32,
                         device="cpu")
    out = serve(Server, Request,
                SlotEngine(port, state_dict, num_slots=3, max_len=MAX_LEN, buckets=(8, 16),
                           device="cpu", **kw))
    assert out == ref
    assert [len(t) for t in out] == [m for _, m in reqs]
