"""The port engine's closed program set and its data-driven sampler,
against the JAX package's.

* ``programs_expected`` and the member list (names and ``compile`` span
  labels) equal the JAX engine's for the dense, paged, int8 and
  speculative (int8 self-draft and n-gram) configurations; ``warmup``
  leaves ``compile_count == programs_expected`` (on the CPU each member
  installs its uncaptured function), a second ``warmup`` and an
  admission/eviction/cancel churn leave it there (the twins of JAX's
  closed-set tests);
* ``warmup`` emits one ``compile`` span per member and the
  ``serve.programs`` gauge;
* the sampler takes per-slot tensors (keys as int64 words) and branches
  on none of them on the host: bit for bit JAX's ``sample_slots`` and
  ``spec_verify_slots`` on batches of greedy, top-k and nucleus rows,
  with and without any nucleus row;
* the ``serve.*`` instrumentation lands on the bus and the report's
  serving view renders it (the twins of the JAX serving, paged, quant
  and spec obs tests).
"""

import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu.serving import sampling as jax_sampling
from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
from distributeddeeplearning_tpu_torch.obs.report import load, render, summarize
from distributeddeeplearning_tpu_torch.serving import (
    ProgramSpec,
    Request,
    Server,
    SlotEngine,
    keys,
    sampling,
)

VOCAB, MAX_LEN = 64, 32
BUCKETS = (8, 16)
CONFIGS = {
    "dense": dict(),
    "paged": dict(kv_layout="paged", block_size=4, decode_kernel="fused"),
    "int8": dict(kv_dtype="int8", weight_dtype="int8"),
    "spec_int8": dict(spec_k=3, spec_draft="int8"),
    "spec_ngram_paged": dict(kv_layout="paged", block_size=4, spec_k=3,
                             spec_draft="ngram", decode_kernel="fused"),
}


@pytest.fixture(autouse=True)
def _fresh_bus():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def models():
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((2, MAX_LEN), jnp.int32),
                           train=False)
    params = nn.unbox(variables["params"])
    return model, params, convert.params_from_flax(params)


def _port_engine(state_dict, **kw):
    model = TransformerLM("tiny", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                          dtype=torch.float32, device="cpu")
    return SlotEngine(model, state_dict, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS,
                      device="cpu", **kw)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_program_set_matches_jax_and_stays_closed(models, config):
    jax_model, params, state_dict = models
    kw = CONFIGS[config]
    ref = JaxEngine(jax_model, params, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS, **kw)
    engine = _port_engine(state_dict, **kw)
    assert engine.programs_expected == ref.programs_expected
    specs = engine.program_specs()
    assert all(isinstance(ps, ProgramSpec) for ps in specs) and not engine.programs
    assert [(ps.name, ps.span) for ps in specs] == [
        (ps.name, ps.span) for ps in ref.program_specs()]
    info = engine.warmup()
    assert engine.compile_count == engine.programs_expected == info["programs"]
    assert sorted(engine.programs) == sorted(ps.name for ps in specs)
    for ps in specs:  # the members that sample carry a greedy-only variant
        assert ps.samples == (not ps.name.startswith("spec_draft"))
        assert sorted(engine.programs[ps.name]) == sorted(ps.variants)
    engine.warmup()  # idempotent
    assert engine.compile_count == engine.programs_expected

    # Admission, eviction, cancellation and slot reuse install nothing.
    rng = np.random.RandomState(3)
    server = Server(engine, prefills_per_step=2)

    def mk(n, m, **rkw):
        return server.submit(Request(prompt=rng.randint(0, VOCAB, size=(n,)).astype(np.int32),
                                     max_new_tokens=m, **rkw))

    wave = [mk(3, 8, temperature=0.9, top_k=8, rng=1), mk(8, 10, rng=2),
            mk(13, 10, temperature=0.7, top_k=5, rng=3),
            mk(16, 6, temperature=1.1, top_k=12, top_p=0.9, rng=4)]
    for _ in range(4):
        server.step()
    wave[1].cancel()
    late = mk(5, 7, temperature=0.8, top_k=6, rng=5)  # reuses the freed slot
    server.drain()
    # (A speculative tick may have finished the cancelled one already.)
    assert wave[1].status in ("cancelled", "done")
    assert all(h.status == "done" for h in wave[::2] + [wave[3], late])
    assert engine.compile_count == engine.programs_expected
    assert engine.replayed_launches() == 0  # nothing captured on the CPU


def test_compile_spans_and_programs_gauge(models, tmp_path):
    _, _, state_dict = models
    bus = obs.configure(str(tmp_path), run_id="programs", proc=0, install_handlers=False)
    engine = _port_engine(state_dict, **CONFIGS["spec_int8"])
    engine.warmup()
    engine.warmup()
    bus.flush()
    events = [json.loads(ln) for ln in open(bus.path)][1:]
    spans = [e for e in events if e["kind"] == "span" and e["name"] == "compile"]
    assert [e["labels"] for e in spans] == [ps.span for ps in engine.program_specs()]
    gauges = [e["value"] for e in events if e["name"] == "serve.programs"]
    assert gauges == [float(engine.programs_expected)] * 2
    assert engine.programs_expected == 2 * len(BUCKETS) + 3


def test_uncaptured_programs_are_the_specs_functions(models):
    """On the CPU the installed programs are ``ProgramSpec.uncaptured``:
    ``fn`` over the member's static inputs by name. Running them by hand
    after the engine filled those inputs reproduces the engine's own
    call, and the greedy-only variant gives the greedy rows' tokens."""
    _, _, state_dict = models
    engine = _port_engine(state_dict, **CONFIGS["paged"])
    engine.warmup()
    server = Server(engine)
    server.submit(Request(prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=4,
                          temperature=0.8, top_k=5, rng=9))
    server.submit(Request(prompt=np.arange(2, 9, dtype=np.int32), max_new_tokens=4))
    server.step()  # prefills + one decode tick
    decode = next(ps for ps in engine.program_specs() if ps.name == "decode")
    assert sorted(decode.inputs) == sorted(engine._inputs["decode"].dev)
    (packed,) = decode.uncaptured()[False]()
    (again,) = engine.programs["decode"][False]()
    assert torch.equal(packed, again)
    assert packed.shape == (2, engine.num_slots)
    (greedy,) = decode.uncaptured()[True]()
    rows = torch.from_numpy(engine._temps <= 0)
    assert rows.sum() == 2 and torch.equal(greedy[:, rows], packed[:, rows])
    server.drain()


# -- the data-driven sampler ---------------------------------------------------

def _rows(seed, s, with_top_p):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(s, VOCAB) * 3).astype(np.float32)
    ks = np.stack([keys.key_from_seed(50 + seed * 10 + i) for i in range(s)])
    temps = np.where(rng.rand(s) < 0.3, 0.0, rng.uniform(0.5, 1.5, s)).astype(np.float32)
    top_ks = rng.choice([0, 3, 7, 20], s).astype(np.int32)
    top_ps = (np.where(rng.rand(s) < 0.5, rng.uniform(0.3, 0.95, s), 0.0).astype(np.float32)
              if with_top_p else np.zeros(s, np.float32))
    return logits, ks, temps, top_ks, top_ps


@pytest.mark.parametrize("with_top_p", [False, True], ids=["no_top_p", "some_top_p"])
@pytest.mark.parametrize("seed", range(4))
def test_sample_slots_on_tensors_bitwise_jax(seed, with_top_p):
    logits, ks, temps, top_ks, top_ps = _rows(seed, 8, with_top_p)
    got = sampling.sample_slots(
        torch.from_numpy(logits), torch.from_numpy(ks.astype(np.int64)),
        torch.from_numpy(temps), torch.from_numpy(top_ks.astype(np.int64)),
        torch.from_numpy(top_ps), top_k_cap=16)
    ref = jax_sampling.sample_slots(jnp.asarray(logits), jnp.asarray(ks), jnp.asarray(temps),
                                    jnp.asarray(top_ks), jnp.asarray(top_ps), top_k_cap=16)
    assert got.tolist() == np.asarray(ref).tolist()
    # The numpy host path (the JAX signature) is the same function.
    host = sampling.sample_slots(torch.from_numpy(logits), ks, temps, top_ks, top_ps,
                                 top_k_cap=16)
    assert torch.equal(host, got)


@pytest.mark.parametrize("mix", ["all_greedy", "mixed", "all_sampled_top_p"])
def test_spec_verify_slots_on_tensors_bitwise_jax(mix):
    rng = np.random.RandomState({"all_greedy": 0, "mixed": 1, "all_sampled_top_p": 2}[mix])
    s, k = 6, 3
    jax_verify = jax.jit(jax_sampling.spec_verify_slots, static_argnames="top_k_cap")
    for _ in range(4):
        logits = (rng.randn(s, k + 1, VOCAB) * 2).astype(np.float32)
        greedy = logits.argmax(-1)
        drafts = rng.randint(0, VOCAB, size=(s, k)).astype(np.int32)
        take = rng.rand(s, k) < 0.7
        drafts[take] = greedy[:, :k][take]
        ks = rng.randint(0, 2 ** 32, size=(s, k + 1, 2), dtype=np.uint64).astype(np.uint32)
        temps = {"all_greedy": np.zeros(s),
                 "mixed": np.array([0.0, 0.7, 1.3, 0.0, 0.9, 1.0]),
                 "all_sampled_top_p": np.full(s, 0.8)}[mix].astype(np.float32)
        top_ks = rng.choice([0, 4, 12], s).astype(np.int32)
        top_ps = (np.full(s, 0.85) if mix == "all_sampled_top_p"
                  else np.array([0.0, 0.0, 0.9, 0.0, 0.0, 0.7])).astype(np.float32)
        ref_c, ref_a = jax_verify(jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(ks),
                                  jnp.asarray(temps), jnp.asarray(top_ks),
                                  jnp.asarray(top_ps), top_k_cap=16)
        got_c, got_a = sampling.spec_verify_slots(
            torch.from_numpy(logits), torch.from_numpy(drafts.astype(np.int64)),
            torch.from_numpy(ks.astype(np.int64)), torch.from_numpy(temps),
            torch.from_numpy(top_ks.astype(np.int64)), torch.from_numpy(top_ps),
            top_k_cap=16)
        a = np.asarray(ref_a)
        np.testing.assert_array_equal(got_a.numpy(), a)
        for row in range(s):  # entries past accepted + 1 are padding
            np.testing.assert_array_equal(got_c.numpy()[row, :a[row] + 1],
                                          np.asarray(ref_c)[row, :a[row] + 1])


@pytest.mark.parametrize("seed", range(3))
def test_greedy_only_sampler_equals_the_data_path(seed):
    """With no sampled row, ``greedy=True`` (the engine's greedy-only
    variant) returns the data path's tokens, and the verify's commits."""
    logits, ks, _, top_ks, top_ps = _rows(seed, 8, True)
    temps = np.zeros(8, np.float32)
    got = sampling.sample_slots(torch.from_numpy(logits), ks, temps, top_ks, top_ps,
                                greedy=True)
    assert torch.equal(got, sampling.sample_slots(torch.from_numpy(logits), ks, temps,
                                                  top_ks, top_ps))
    rng = np.random.RandomState(seed)
    s, k = 4, 3
    logits = (rng.randn(s, k + 1, VOCAB) * 2).astype(np.float32)
    drafts = np.where(rng.rand(s, k) < 0.6, logits.argmax(-1)[:, :k],
                      rng.randint(0, VOCAB, size=(s, k)))
    vks = rng.randint(0, 2 ** 32, size=(s, k + 1, 2), dtype=np.uint64).astype(np.uint32)
    args = (torch.from_numpy(logits), drafts, vks, np.zeros(s, np.float32),
            np.full(s, 4), np.zeros(s, np.float32))
    full_c, full_a = sampling.spec_verify_slots(*args)
    only_c, only_a = sampling.spec_verify_slots(*args, greedy=True)
    assert torch.equal(only_a, full_a) and torch.equal(only_c, full_c)


def test_device_fold_equals_host_fold():
    ks = np.random.RandomState(5).randint(0, 2 ** 32, size=(7, 2), dtype=np.uint64)
    ks = ks.astype(np.uint32)
    for data in (0, 1, 5):
        got = sampling._fold(torch.from_numpy(ks.astype(np.int64)), data, "cpu").numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), sampling.fold_keys(ks, data))


# -- serve.* instrumentation ----------------------------------------------------

def _serve_under_bus(tmp_path, engine, prompts, max_new, same_prompt=False):
    bus = obs.configure(str(tmp_path), run_id="serve-test", proc=0, install_handlers=False)
    try:
        server = Server(engine)
        rng = np.random.RandomState(8)
        base = rng.randint(0, VOCAB, size=(prompts[0],)).astype(np.int32)
        hs = [server.submit(Request(
            prompt=base if same_prompt else rng.randint(0, VOCAB, size=(n,)).astype(np.int32),
            max_new_tokens=max_new)) for n in prompts]
        server.drain()
        assert all(h.status == "done" for h in hs)
        bus.flush()
    finally:
        obs.reset()
    return summarize(load([str(tmp_path)]))


def test_obs_instrumentation(models, tmp_path):
    engine = _port_engine(models[2])
    engine.warmup()
    summary = _serve_under_bus(tmp_path, engine, (3, 9), 4)
    srv = summary["serving"]
    assert srv["requests_done"] == 2
    assert srv["admitted"] == 2 and srv["completed"] == 2
    assert srv["tokens"] == 8
    assert srv["occupancy_mean"] is not None
    assert srv["ttft"]["count"] == 2 and srv["queue_wait"]["count"] == 2
    assert srv["decode_step"]["count"] >= 3
    text = render(summary)
    assert "serving (continuous batching)" in text and "ttft" in text


def test_paged_obs_gauges_and_report(models, tmp_path):
    engine = _port_engine(models[2], kv_layout="paged", block_size=4)
    engine.warmup()
    summary = _serve_under_bus(tmp_path, engine, (8, 8), 4, same_prompt=True)
    srv = summary["serving"]
    assert srv["block_pool_total"] == float(engine.allocator.capacity)
    assert srv["block_pool_free"] is not None
    assert srv["prefix_hits"] and srv["prefix_hits"] > 0
    text = render(summary)
    assert "block pool" in text and "prefix hits" in text


def test_warmup_emits_byte_gauges(models, tmp_path):
    bus = obs.configure(str(tmp_path), run_id="quant-test", proc=0, install_handlers=False)
    try:
        engine = _port_engine(models[2], kv_dtype="int8", weight_dtype="int8")
        engine.warmup()
        bus.flush()
    finally:
        obs.reset()
    srv = summarize(load([str(tmp_path)]))["serving"]
    acct = engine.byte_accounting()
    assert srv["kv_bytes_per_token"] == pytest.approx(acct["kv_bytes_per_token"])
    assert srv["param_bytes"] == pytest.approx(acct["param_bytes"])
    assert "KV/token" in render(summarize(load([str(tmp_path)])))


def test_spec_obs_gauges_counters_and_report(models, tmp_path):
    engine = _port_engine(models[2], spec_k=3, spec_draft="int8")
    engine.warmup()
    srv_summary = _serve_under_bus(tmp_path, engine, (4, 9), 8)
    srv = srv_summary["serving"]
    assert srv["spec_tokens_accepted"] + srv["spec_tokens_rejected"] > 0
    assert srv["spec_accept_rate"] is not None
    assert srv["spec_draft_ms"] is not None and srv["spec_verify_ms"] is not None
    text = render(srv_summary)
    assert "speculative:" in text and "draft tokens" in text
