"""The port's serving tier against the JAX package's.

* Greedy token streams: the JAX ``Server`` (paged + fused Pallas kernel
  in interpret mode, and the dense layout) and the port's ``Server`` on
  the CPU, on the same converted f32 weights, emit identical tokens for
  a mix of requests on a few slots — including two prompts that share a
  block-aligned prefix, so the second prefills only its suffix from the
  prefix cache. An f32 model makes this exact: the two stacks' logits
  agree to f32 round-off (``test_torch_transformer_lm.py``), far inside
  the gap between a tiny random model's top two logits.
* The key ladder, the sampling rules and ``ServeConfig.from_env`` are
  held to the JAX package's directly. Sampled draws are JAX's own
  (``test_torch_sampling.py``); here they are also held to their
  support, to per-seed determinism and to batching invariance.
"""

import dataclasses

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
from distributeddeeplearning_tpu.serving.scheduler import ServeConfig as JaxServeConfig
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.serving import (
    Request,
    ServeConfig,
    Server,
    SlotEngine,
    keys,
    sampling,
)

VOCAB, MAX_LEN = 64, 32
BUCKETS = (8, 16)
SHARED = np.arange(1, 9, dtype=np.int32)  # two full blocks of 4


def _requests():
    """(prompt, max_new_tokens): mixed lengths; the 2nd and 5th share an
    8-token prefix, so the 5th hits the prefix cache."""
    rng = np.random.RandomState(11)
    r = lambda n: rng.randint(0, VOCAB, size=(n,)).astype(np.int32)  # noqa: E731
    return [
        (r(3), 6),
        (np.concatenate([SHARED, r(3)]), 7),
        (r(12), 4),
        (r(16), 6),
        (np.concatenate([SHARED, r(6)]), 5),
        (r(5), 9),
    ]


@pytest.fixture(scope="module")
def jax_model_params():
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                  dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((2, MAX_LEN), jnp.int32), train=False)
    return model, nn.unbox(variables["params"])


@pytest.fixture(scope="module")
def state_dict(jax_model_params):
    return convert.params_from_flax(jax_model_params[1])


def _port_engine(state_dict, **kw):
    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    return SlotEngine(model, state_dict, num_slots=3, max_len=MAX_LEN,
                      buckets=BUCKETS, device="cpu", **kw)


def _serve(server_cls, request_cls, engine, reqs, **req_kw):
    server = server_cls(engine, prefills_per_step=1)
    handles = [server.submit(request_cls(prompt=p, max_new_tokens=m, **req_kw))
               for p, m in reqs]
    server.drain()
    assert all(h.status == "done" for h in handles)
    return [list(h.new_tokens) for h in handles]


@pytest.mark.parametrize(
    "kw",
    [
        pytest.param(dict(kv_layout="paged", block_size=4, decode_kernel="fused"),
                     id="paged-fused"),
        pytest.param(dict(decode_kernel="fused"), id="dense-fused"),
    ],
)
def test_greedy_streams_match_jax_server(jax_model_params, state_dict, kw):
    model, params = jax_model_params
    reqs = _requests()
    jax_engine = JaxEngine(model, params, num_slots=3, max_len=MAX_LEN,
                           buckets=BUCKETS, **kw)
    ref = _serve(JaxServer, JaxRequest, jax_engine, reqs)
    port_engine = _port_engine(state_dict, **kw)
    out = _serve(Server, Request, port_engine, reqs)
    assert out == ref
    assert [len(t) for t in out] == [m for _, m in reqs]
    if kw.get("kv_layout") == "paged":
        # same allocator decisions, block for block, prefix hit included
        assert port_engine.allocator.snapshot() == jax_engine.allocator.snapshot()
        assert port_engine.allocator.stats["prefix_hit_requests"] >= 1


def test_paged_xla_and_fused_paths_agree(state_dict):
    """The plain masked path and the kernel wrapper serve the same greedy
    streams (on the CPU both are plain PyTorch, but they gather, mask and
    normalise differently)."""
    reqs = _requests()
    streams = [
        _serve(Server, Request,
               _port_engine(state_dict, kv_layout="paged", block_size=4,
                            decode_kernel=k), reqs)
        for k in ("xla", "fused")
    ]
    assert streams[0] == streams[1]


def test_sampled_streams_batching_invariant_and_seeded(state_dict):
    """A sampled request's stream depends on its seed only: served in a
    batch or alone, it is the same; another seed gives another stream."""
    reqs = _requests()
    kw = dict(temperature=0.8, top_k=10, rng=7)
    engine = _port_engine(state_dict, kv_layout="paged", block_size=4,
                          decode_kernel="fused", prefix_cache=False)
    batched = _serve(Server, Request, engine, reqs, **kw)
    alone = [_serve(Server, Request, engine, [r], **kw)[0] for r in reqs]
    assert batched == alone
    other = _serve(Server, Request, engine, reqs, temperature=0.8, top_k=10, rng=8)
    assert other != batched


def test_request_key_ladder_matches_jax():
    rng = jax.random.PRNGKey(5)
    for n in (1, 2, 9):
        r0, loop = jax.random.split(rng)
        ref = [np.asarray(r0)]
        if n > 1:
            ref += list(np.asarray(jax.random.split(loop, n - 1)))
        np.testing.assert_array_equal(
            keys.request_key_ladder(np.asarray(rng), n), np.stack(ref)
        )
    np.testing.assert_array_equal(
        keys.key_from_seed(42), np.asarray(jax.random.PRNGKey(42))
    )


def _logits(seed, vocab=VOCAB):
    return np.random.RandomState(seed).randn(vocab).astype(np.float32) * 3


def test_greedy_is_first_argmax():
    logits = torch.zeros(VOCAB)
    logits[[5, 9]] = 2.0  # a tie: the first index wins
    assert int(sampling.sample_slot(logits, None, 0.0, 0, 0.0)) == 5
    batch = torch.stack([logits, torch.from_numpy(_logits(1))])
    out = sampling.sample_slots(batch, np.zeros((2, 2), np.uint32),
                                np.zeros(2, np.float32), np.zeros(2, np.int32),
                                np.zeros(2, np.float32))
    assert out.tolist() == [5, int(np.argmax(_logits(1)))]


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (6, 0.5), (200, 0.9)])
def test_filters_match_jax(top_k, top_p):
    """The port's filtered logits equal the JAX sampler's (same kept set,
    same values): top-k by value at the cap, nucleus on the unfiltered
    sorted distribution."""
    for seed in range(4):
        x = _logits(seed)
        scaled = x / 0.8
        if top_p > 0:
            ref = jax_sampling._filter_full(jnp.asarray(scaled), top_k, top_p)
            out = sampling._filter_full(torch.from_numpy(scaled), top_k, top_p)
        else:
            ref = jax_sampling._filter_topk(jnp.asarray(scaled), top_k, 128)
            out = sampling._filter_topk(torch.from_numpy(scaled), top_k, 128)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_draws_stay_in_support_and_repeat_per_key():
    x = torch.from_numpy(_logits(3))
    kept = set(torch.topk(x, 5).indices.tolist())
    draws = []
    for s in range(64):
        key = keys.key_from_seed(s)
        tok = int(sampling.sample_slot(x, key, 1.0, 5, 0.0))
        assert tok in kept
        assert tok == int(sampling.sample_slot(x, key, 1.0, 5, 0.0))
        draws.append(tok)
    assert len(set(draws)) > 1  # the key, not a constant, picks the token


def test_serve_config_from_env_resolves_like_jax():
    env = {
        "SERVE_SLOTS": "4", "SERVE_BUCKETS": "16,64", "SERVE_QUEUE_DEPTH": "9",
        "SERVE_DEADLINE_MS": "250", "SERVE_PREFILLS_PER_STEP": "2",
        "SERVE_TOP_K_CAP": "64", "SERVE_KV_LAYOUT": "paged",
        "SERVE_BLOCK_SIZE": "8", "SERVE_NUM_BLOCKS": "33",
        "SERVE_PREFIX_CACHE": "off", "SERVE_DECODE_KERNEL": "fused",
    }
    for e in (env, {}):
        assert dataclasses.asdict(ServeConfig.from_env(e)) == dataclasses.asdict(
            JaxServeConfig.from_env(e)
        )
    kw = ServeConfig.from_env(env).engine_kwargs()
    assert kw["kv_layout"] == "paged" and kw["decode_kernel"] == "fused"
    quant_env = {"SERVE_KV_DTYPE": "int8", "SERVE_WEIGHT_DTYPE": "int8"}
    assert ServeConfig.from_env(quant_env).engine_kwargs() == (
        JaxServeConfig.from_env(quant_env).engine_kwargs())
    with pytest.raises(ValueError):
        ServeConfig.from_env({"SERVE_KV_DTYPE": "int4"}).engine_kwargs()


def test_stream_yields_the_committed_tokens(state_dict):
    import threading

    server = Server(_port_engine(state_dict, kv_layout="paged", block_size=4))
    prompt, n = _requests()[1]
    h = server.submit(Request(prompt=prompt, max_new_tokens=n))
    pump = threading.Thread(target=server.drain, kwargs={"timeout": 60})
    pump.start()
    streamed = list(h.stream(timeout=60))
    pump.join(timeout=60)
    assert not pump.is_alive()
    assert streamed == h.new_tokens and len(streamed) == n
    np.testing.assert_array_equal(h.result(timeout=0), np.concatenate([prompt, streamed]))


def test_cancel_deadline_and_backpressure(state_dict):
    """Cancel a queued request, evict a running one at its deadline, and
    refuse a submit past the queue depth; the pool's blocks all return."""
    from distributeddeeplearning_tpu_torch.serving import QueueFull

    engine = _port_engine(state_dict, kv_layout="paged", block_size=4,
                          prefix_cache=False)
    server = Server(engine, queue_depth=3)
    reqs = _requests()
    late = server.submit(Request(prompt=reqs[0][0], max_new_tokens=20,
                                 deadline_ms=1e9))
    kept = server.submit(Request(prompt=reqs[2][0], max_new_tokens=4))
    gone = server.submit(Request(prompt=reqs[3][0], max_new_tokens=4))
    with pytest.raises(QueueFull):
        server.submit(Request(prompt=reqs[5][0], max_new_tokens=4))
    gone.cancel()
    server.step()  # admits `late`, decodes one token
    late._deadline_t = 0.0  # its deadline passes while it runs
    server.drain()
    assert gone.status == "cancelled" and gone.new_tokens == []
    assert late.status == "deadline" and 0 < len(late.new_tokens) < 20
    assert kept.status == "done" and len(kept.new_tokens) == 4
    assert server.stats["cancelled"] == 1 and server.stats["deadline"] == 1
    assert engine.allocator.free_count == engine.allocator.capacity
    with pytest.raises(ValueError, match="max_new_tokens"):
        server.submit(Request(prompt=reqs[0][0], max_new_tokens=0))
