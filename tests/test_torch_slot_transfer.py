"""The port's slot transfer (``SlotEngine.export_slot``, ``import_slot``,
``export_blocks``, ``can_import``, ``adopt_prefix_blocks``), pool roles
and the engine route (``generate(engine=, on_token=)``) against the JAX
package's, on the CPU.

* Both engines (paged, ``lm_tiny`` f32 on the same converted weights)
  admit the same request: their exported states agree field for field,
  and the staged KV content of every written block agrees to f32
  round-off, layer by layer (the port keys it ``block{i}.k`` /
  ``.v``; JAX ``(block{i}, attn, paged_k)`` / ``paged_v``).
* A state exported by one port engine and imported by another continues
  the stream bit for bit, equal to JAX's ``generate``; so does a state
  exported by the JAX engine, renamed, and imported by the port's.
* A directory payload adopted into the port's prefix cache makes the
  next prefill compute only the suffix, with the same stream.
* Pool roles hold the JAX engine's program counts and refusals.
* ``generate(engine=...)`` at B = 1 equals JAX's ``generate`` for a
  ``SlotEngine``, a ``Server`` and a ``Router``, and ``on_token``
  delivers exactly the returned tokens.
* On the card (``cuda``, decided in the test): an import into a captured
  engine writes the existing stores in place (their addresses do not
  move) and the replayed decode continues bit for bit as the same
  members run uncaptured.
"""

import numpy as np
import pytest
import torch
from test_torch_fleet_common import (  # noqa: F401
    MAX_LEN,
    _two_threads,
    jax_lm,
    jax_ref,
    jax_ref_new,
    port_model,
    prompt,
    replica,
    state_dict,
)

from distributeddeeplearning_tpu.serving import ReqSpec as JaxReqSpec
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu_torch import inference
from distributeddeeplearning_tpu_torch.serving import (
    FleetConfig,
    ReqSpec,
    Router,
    ServeConfig,
    Server,
    SlotEngine,
    generate_with_engine,
)

BLOCK = 4
PAGED = dict(num_slots=2, max_len=MAX_LEN, buckets=(8, 16), kv_layout="paged",
             block_size=BLOCK)


def _port_engine(device="cpu", **kw):
    return SlotEngine(port_model(), state_dict(), device=device, **dict(PAGED, **kw))


def _jax_name(name):
    block, part = name.split(".")
    return (block, "attn", f"paged_{part}")


@pytest.fixture(scope="module")
def engines():
    model, params = jax_lm()
    jax_engine = JaxEngine(model, params, **PAGED)
    jax_engine.warmup()
    return jax_engine, _port_engine()


def _decode(engine, slot, n):
    out = []
    for _ in range(n):
        for s, tok, _ in engine.decode_step():
            if s == slot:
                out.append(int(tok))
    return out


def test_exported_state_and_blocks_match_jax(engines):
    jax_engine, engine = engines
    p = prompt(np.random.RandomState(1), 11)
    first_j, _ = jax_engine.prefill(0, JaxReqSpec(prompt=p, max_new_tokens=9))
    first, _ = engine.prefill(0, ReqSpec(prompt=p, max_new_tokens=9))
    assert first == first_j
    assert _decode(engine, 0, 3) == _decode(jax_engine, 0, 3)
    got, want = engine.export_slot(0), jax_engine.export_slot(0)
    for key in ("block_size", "n_blocks", "written", "token", "temp", "top_k", "top_p", "eos",
                "cursor"):
        assert got[key] == want[key], key
    assert (got["ladder"] is None) == (want["ladder"] is None)
    assert sorted(_jax_name(n) for n in got["payload"]) == sorted(want["payload"])
    nwritten = -(-got["written"] // BLOCK)
    for name, rows in got["payload"].items():
        ref = np.asarray(want["payload"][_jax_name(name)])
        assert rows.shape == ref.shape and rows.shape[0] == nwritten
        np.testing.assert_allclose(rows.numpy(), ref, rtol=1e-5, atol=1e-5, err_msg=name)
    # export_blocks is the same read; a pure read leaves the slot as it was
    blocks = got["blocks"][:nwritten]
    again = engine.export_blocks(blocks)
    assert all(torch.equal(again[n], got["payload"][n]) for n in again)
    assert engine.store_names() == list(got["payload"])
    assert engine.pool_stats() == engine.allocator.snapshot()
    assert jax_engine.pool_stats() == jax_engine.allocator.snapshot()
    engine.release(0)
    jax_engine.release(0)


@pytest.mark.parametrize("source", ["port", "jax"])
def test_import_continues_bitwise(engines, source):
    """A slot exported after 3 decode ticks (by the port's engine or by
    JAX's, renamed) and imported by a fresh port engine continues
    exactly as JAX's ``generate``; the source slot, kept, continues the
    same way."""
    jax_engine, engine = engines
    src = jax_engine if source == "jax" else engine
    spec_cls = JaxReqSpec if source == "jax" else ReqSpec
    p = prompt(np.random.RandomState(2), 10)
    first, _ = src.prefill(1, spec_cls(prompt=p, max_new_tokens=12))
    head = [int(first)] + _decode(src, 1, 3)
    state = src.export_slot(1)
    if source == "jax":
        state = dict(state, payload={f"{b}.{part[6:]}": torch.from_numpy(np.asarray(a))
                                     for (b, _, part), a in state["payload"].items()})
    dst = _port_engine()
    assert dst.can_import(state)
    dst.import_slot(0, state, prompt=p)
    tail = _decode(dst, 0, 8)
    want = jax_ref_new(p, 12)
    assert head + tail == want
    assert head + _decode(src, 1, 8) == want
    src.release(1)
    # the imported full prompt blocks register in the destination's cache
    assert dst.allocator.peek_prefix(p, len(p) - 1) == (len(p) - 1) // BLOCK
    assert not dst.can_import(dict(state, n_blocks=dst.allocator.capacity + 1))


def test_adopt_prefix_blocks_prefills_only_the_suffix(engines):
    jax_engine, engine = engines
    rng = np.random.RandomState(3)
    p = prompt(rng, 12)
    jax_engine.prefill(0, JaxReqSpec(prompt=p, max_new_tokens=4))
    state = jax_engine.export_slot(0)
    jax_engine.release(0)
    payload = {f"{b}.{part[6:]}": torch.from_numpy(np.asarray(a))
               for (b, _, part), a in state["payload"].items()}
    dst = _port_engine()
    assert dst.adopt_prefix_blocks(p, payload) == 3
    assert dst.adopt_prefix_blocks(p, payload) == 0  # already cached
    live = dst.allocator.live_count
    q = np.concatenate([p[:8], prompt(rng, 5)]).astype(np.int32)
    first, _ = dst.prefill(0, ReqSpec(prompt=q, max_new_tokens=6))
    assert dst.last_prefill["shared_blocks"] == 2 and dst.last_prefill["start"] == 8
    assert [int(first)] + _decode(dst, 0, 5) == jax_ref_new(q, 6)
    assert live == 0


def test_pool_roles_match_jax():
    model, params = jax_lm()
    for role, want in (("prefill", 2), ("decode", 1), ("both", 3)):
        e = _port_engine(pool_role=role)
        j = JaxEngine(model, params, pool_role=role, **PAGED)
        assert e.programs_expected == j.programs_expected == want
        e.warmup()
        assert e.compile_count == want
        assert [ps.name for ps in e.program_specs()] == (
            ["prefill_b8", "prefill_b16"] if role == "prefill"
            else ["decode"] if role == "decode" else ["decode", "prefill_b8", "prefill_b16"])
    with pytest.raises(RuntimeError, match="decode-pool"):
        _port_engine(pool_role="decode").prefill(0, ReqSpec(prompt=np.arange(3), max_new_tokens=2))
    for bad, match in ((dict(pool_role="mixed"), "pool_role"),
                       (dict(pool_role="prefill", kv_layout="dense"), "paged"),
                       (dict(pool_role="decode", spec_k=2, spec_draft="ngram"), "spec")):
        with pytest.raises(ValueError, match=match):
            _port_engine(**bad)
        with pytest.raises(ValueError, match=match):
            JaxEngine(model, params, **dict(PAGED, **bad))
    e = _port_engine()
    assert e.spec_suspended is False
    with pytest.raises(RuntimeError, match="paged"):
        SlotEngine(port_model(), state_dict(), num_slots=2, max_len=MAX_LEN, buckets=(8,),
                   device="cpu").export_slot(0)


def test_engine_route_matches_jax_generate():
    p = prompt(np.random.RandomState(4), 6)
    want = jax_ref(p, 7)
    server = Server(_port_engine(num_slots=3))
    router = Router(config=FleetConfig(replicas=1))
    router.add_replica(replica(0, ServeConfig(num_slots=2, buckets=(8,))), threaded=False)
    for target in (_port_engine(num_slots=3), server, router):
        streamed = []
        out = inference.generate(None, p[None], max_new_tokens=7, engine=target,
                                 on_token=lambda row, tok: streamed.append((row, tok)))
        assert out.dtype == torch.int64 and out.shape == (1, 13)
        np.testing.assert_array_equal(out[0].numpy(), want)
        assert [t for _, t in streamed] == [int(t) for t in want[6:]]
    # B = 2: row 0 keeps the caller's key (sampled); row 1 folds it
    two = np.stack([p, prompt(np.random.RandomState(5), 6)])
    out = generate_with_engine(server, two, max_new_tokens=5, temperature=0.8, top_k=8, rng=3)
    np.testing.assert_array_equal(out[0], jax_ref(p, 5, seed=3, temperature=0.8, top_k=8))
    # eos freezes a row to the pad token, as generate does
    eos = int(want[6])
    out = generate_with_engine(server, p[None], max_new_tokens=4, eos_token=eos, pad_token=-1)
    assert out[0, 6] == eos and (out[0, 7:] == -1).all()
    with pytest.raises(ValueError, match="on_token"):
        inference.generate(port_model(), p[None], max_new_tokens=2, on_token=print)
    router.close()


@pytest.mark.cuda
def test_cuda_import_into_captured_engine_in_place():
    """On the card: import into a captured engine writes its stores in
    place, and the replayed decode equals the uncaptured members'."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's members are captured as CUDA graphs")
    p = prompt(np.random.RandomState(6), 10)
    src = _port_engine(device="cuda", decode_kernel="fused")
    src.prefill(0, ReqSpec(prompt=p, max_new_tokens=12))
    _decode(src, 0, 2)
    state = src.export_slot(0)
    runs = []
    for captured in (True, False):
        dst = _port_engine(device="cuda", decode_kernel="fused")
        dst.warmup()
        assert dst.graphs_captured > 0
        if not captured:
            dst.programs.update({ps.name: ps.uncaptured() for ps in dst.program_specs()})
        ptrs = [t.data_ptr() for t in dst._named_stores().values()]
        dst.import_slot(0, state)
        assert [t.data_ptr() for t in dst._named_stores().values()] == ptrs
        runs.append(_decode(dst, 0, 8))
    assert runs[0] == runs[1] == _decode(src, 0, 8)
