"""The port's disaggregated prefill/decode serving against the JAX
package's, on the CPU.

Twins of the fourteen cases of ``tests/test_serving_disagg.py``:

* the fleet-wide ``PrefixDirectory`` and the allocator's pins are host
  code copied from the JAX package: the same calls on both give the same
  returns, stats and ledgers;
* handoff, directory adoption, live migration and the churn cases run
  port replicas (paged, inline) over the JAX ``lm_tiny``'s converted
  weights, and every stream is held bit for bit to the JAX package's
  sequential ``generate``; every engine's program set stays closed;
* the per-pool controller makes the JAX test's decisions in sequence.
"""

import numpy as np
import pytest
from test_torch_fleet_common import (  # noqa: F401
    VOCAB,
    _two_threads,
    jax_ref_new,
    port_model,
    prompt,
    pump,
    replica,
)

from distributeddeeplearning_tpu.serving import BlockAllocator as JaxBlockAllocator
from distributeddeeplearning_tpu.serving import FleetConfig as JaxFleetConfig
from distributeddeeplearning_tpu.serving import PrefixDirectory as JaxPrefixDirectory
from distributeddeeplearning_tpu_torch.serving import (
    BlockAllocator,
    BlockPoolExhausted,
    ControllerConfig,
    FleetConfig,
    FleetController,
    PrefixDirectory,
    Request,
    Router,
    ServeConfig,
)
from distributeddeeplearning_tpu_torch.serving.fleet import PoolWatermarks

BLOCK = 4


def _scfg(**over):
    kw = dict(num_slots=2, buckets=(8,), prefills_per_step=2, kv_layout="paged",
              block_size=BLOCK)
    kw.update(over)
    return ServeConfig(**kw)


def _ledger_balanced(rep):
    a = rep.engine.allocator
    return a.live_count == 0 and a.free_count == a.capacity


def _release_directory(router):
    if router.directory is None:
        return
    by_rid = {r.rid: r for r in router.replicas}
    for rid, bids in router.directory.clear():
        r = by_rid.get(rid)
        if r is None or r.engine is None or r.engine.allocator is None:
            continue
        for bid in bids:
            r.engine.allocator.unpin(bid)


def _payload(n_blocks, key, fill=0.5):
    return {key: np.full((n_blocks, BLOCK, 2), fill, np.float32)}


def _both(fn):
    """``fn(PrefixDirectory, key)`` on the port's directory and on JAX's
    (payload keys in each package's naming)."""
    return fn(PrefixDirectory(), "block0.k"), fn(JaxPrefixDirectory(), ("layer", "k"))


# -- directory and allocator (host code, both packages) ------------------


def test_directory_publish_lookup_adopt():
    def drive(d, key):
        p = np.arange(8, dtype=np.int32)
        out = [d.lookup(p) is None, d.stats["hits"]]
        out.append(d.publish(0, p, [3, 7], _payload(2, key), first_token=5, block_size=BLOCK))
        out.append(d.publish(0, p, [3, 7], _payload(2, key), first_token=5, block_size=BLOCK))
        out.append(d.publish(1, p, [9], _payload(1, key), first_token=5, block_size=BLOCK))
        ent = d.lookup(p)
        out += [ent["owner"], ent["holders"], ent["first_token"], ent["adoptions"],
                d.adopt(p)["adoptions"], len(d), dict(d.stats), sorted(d.mapped_blocks(0))]
        return out

    got, want = _both(drive)
    assert got == want
    assert got[2:5] == [True, False, True] and got[-1] == [3, 7]


def test_directory_chain_lookup_and_drop_replica():
    def drive(d, key):
        p = np.arange(8, dtype=np.int32)
        d.publish(0, p, [3, 7], _payload(2, key), first_token=5, block_size=BLOCK)
        longer = np.concatenate([p[:4], np.full(4, 63, np.int32)])
        n, ent, sliced = d.lookup_chain(longer, BLOCK)
        out = [n, ent is not None, sliced[key].shape[0],
               d.lookup_chain(p, BLOCK * 2) == (0, None, {})]
        d.publish(1, p, [9], _payload(1, key), first_token=5, block_size=BLOCK)
        out += [d.drop_replica(0), d.lookup(p)["owner"], d.stats["rehomed"]]
        d.drop_replica(1)
        out += [len(d), d.lookup(p) is None, d.lookup_chain(longer, BLOCK) == (0, None, {}),
                d.stats["dropped"], d.snapshot()]
        return out

    got, want = _both(drive)
    assert got == want
    assert got[:4] == [1, True, 1, True] and got[4] == [(0, [3, 7])]


def test_directory_clear_returns_every_mapping():
    def drive(d, key):
        a = np.arange(8, dtype=np.int32)
        b = np.arange(8, 16, dtype=np.int32)
        d.publish(0, a, [1, 2], _payload(2, key), first_token=0, block_size=BLOCK)
        d.publish(1, b, [4], _payload(1, key), first_token=0, block_size=BLOCK)
        return [sorted(d.clear()), len(d), d.lookup(a) is None]

    got, want = _both(drive)
    assert got == want == [[(0, [1, 2]), (1, [4])], 0, True]


def test_allocator_pins_block_eviction_and_recycling():
    def drive(cls):
        a = cls(num_blocks=6, block_size=BLOCK)
        out = []
        bids = a.alloc(2)
        with pytest.raises(KeyError):
            a.pin(999)
        a.pin(bids[0])
        for bid in bids:
            a.decref(bid)
        out += [a.pinned(bids[0]), a.free_count, a.capacity]
        with pytest.raises(Exception) as err:
            a.alloc(a.capacity)
        out.append(type(err.value).__name__)
        toks = np.arange(BLOCK, dtype=np.int32)
        reg = a.alloc(1)
        a.register_prefix(toks, reg)
        a.pin(reg[0])
        a.decref(reg[0])
        grab = a.alloc(a.free_count)
        out += [a.pinned(reg[0]), a.peek_prefix(toks, BLOCK)]
        for bid in grab:
            a.decref(bid)
        a.unpin(bids[0])
        a.unpin(reg[0])
        out += [a.live_count, a.free_count, a.snapshot()]
        return out

    got, want = drive(BlockAllocator), drive(JaxBlockAllocator)
    assert got == want
    assert got[0] and got[1] == got[2] - 1 and got[3] == BlockPoolExhausted.__name__


def test_prefix_reuse_never_windows_past_position_capacity():
    """A 1-block hit on an 8-token prompt would window its suffix past a
    10-position model: the engine shrinks the match, and both streams
    equal JAX's reference on the same (10-position) weights."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from distributeddeeplearning_tpu.inference import generate as jax_generate
    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
    from distributeddeeplearning_tpu_torch.models import convert

    cap = 10
    m = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=cap, dtype=jnp.float32)
    p10 = nn.unbox(m.init(jax.random.PRNGKey(2), jnp.zeros((2, cap), jnp.int32),
                          train=False)["params"])
    router = Router(config=FleetConfig(replicas=1))
    router.add_replica(replica(0, _scfg(), model=port_model(cap),
                               params=convert.params_from_flax(p10), max_len=cap),
                       start=True, threaded=False)
    rng = np.random.RandomState(23)
    a = prompt(rng, 8)
    b = np.concatenate([a[:BLOCK], prompt(rng, 4)]).astype(np.int32)
    try:
        for p in (a, b):
            fh = router.submit(Request(prompt=p, max_new_tokens=2, temperature=0.0))
            assert pump(router, lambda: fh.done.is_set())
            ref = np.asarray(jax_generate(m, p10, p[None], max_new_tokens=2))[0]
            assert fh.new_tokens == [int(t) for t in ref[len(p):]]
    finally:
        router.close()


# -- fleet config --------------------------------------------------------


def test_fleet_config_disagg_env_and_pool_split():
    env = {"SERVE_REPLICAS": "4", "SERVE_DISAGG": "1", "SERVE_POOL_PREFILL": "1",
           "SERVE_DISAGG_DIRECTORY": "0"}
    cfg = FleetConfig.from_env(env)
    assert cfg.disagg and not cfg.directory
    for kw in (dict(replicas=4), dict(replicas=4, disagg=True), dict(replicas=5, disagg=True),
               dict(replicas=5, disagg=True, decode_pool=4)):
        assert FleetConfig(**kw).pool_split() == JaxFleetConfig(**kw).pool_split()
    assert cfg.pool_split() == JaxFleetConfig.from_env(env).pool_split() == (1, 3)
    for bad in (dict(replicas=1, disagg=True), dict(replicas=3, disagg=True, prefill_pool=3)):
        with pytest.raises(ValueError):
            FleetConfig(**bad).validate()


# -- disaggregated fleet (1 prefill + 2 decode, inline) ------------------


@pytest.fixture(scope="module")
def dfleet():
    pools = ("prefill", "decode", "decode")
    reps = [replica(k, _scfg(), pool=pools[k]).start(threaded=False) for k in range(3)]
    # No straggler quarantine: it reads tick walls, and a loaded host's
    # eager CPU ticks would quarantine a healthy decode replica and leave
    # a migration no target (test_torch_fleet_chaos.py covers it).
    router = Router(config=FleetConfig(replicas=3, disagg=True, prefill_pool=1, decode_pool=2,
                                       straggler_factor=1e9))
    for r in reps:
        router.add_replica(r, start=False)
    assert router.directory is not None
    yield router
    router.close()


def test_handoff_bitwise_parity_and_closed_pools(dfleet):
    rng = np.random.RandomState(7)
    cases = []
    for i in range(6):
        p = prompt(rng, n=4 + (i % 5))
        cases.append((p, 4 + (i % 4), dfleet.submit(Request(
            prompt=p, max_new_tokens=4 + (i % 4), temperature=0.0))))
    handles = [fh for _, _, fh in cases]
    assert pump(dfleet, lambda: all(h.done.is_set() for h in handles))
    for p, n, fh in cases:
        assert fh.finish_reason in ("eos", "length")
        assert fh.new_tokens == jax_ref_new(p, n)[: len(fh.new_tokens)]
        assert fh.restart_consistent
        assert dfleet._replica(fh.replica_id).pool == "decode"
    assert dfleet.stats["handoffs"] >= 6 and len(dfleet.handoff_ms) >= 6
    pre = dfleet._replica(0)
    assert pre.pool == "prefill" and pre.engine.prefill_execs >= 6
    for r in dfleet.replicas[1:]:
        assert r.engine.prefill_execs == 0
    for r in dfleet.replicas:
        assert r.engine.compile_count == r.engine.programs_expected
    assert [r.engine.programs_expected for r in dfleet.replicas] == [1, 1, 1]


def test_directory_adoption_runs_zero_prefill(dfleet):
    hot = prompt(np.random.RandomState(11), n=8)
    first = dfleet.submit(Request(prompt=hot, max_new_tokens=6, temperature=0.0))
    assert pump(dfleet, first.done.is_set)
    assert first.new_tokens == jax_ref_new(hot, 6)
    assert dfleet.directory.lookup(hot.copy()) is not None
    execs_pre = sum(r.engine.prefill_execs for r in dfleet.replicas)
    hits_pre = dfleet.stats["directory_hits"]
    second = dfleet.submit(Request(prompt=hot, max_new_tokens=6, temperature=0.0))
    assert pump(dfleet, second.done.is_set)
    assert second.new_tokens == first.new_tokens
    assert sum(r.engine.prefill_execs for r in dfleet.replicas) == execs_pre
    assert dfleet.stats["directory_hits"] > hits_pre
    assert dfleet.directory.lookup(hot)["adoptions"] >= 1


def test_directory_mapped_blocks_are_pinned_and_resident(dfleet):
    mapped = 0
    for r in dfleet.replicas:
        a = r.engine.allocator
        for bid in dfleet.directory.mapped_blocks(r.rid):
            mapped += 1
            assert a.pinned(bid) and (bid in a._ref or bid in a._lru)
    assert mapped >= 1


def test_live_migration_zero_drop_bitwise(dfleet):
    p = prompt(np.random.RandomState(13), n=6)
    fh = dfleet.submit(Request(prompt=p, max_new_tokens=12, temperature=0.0))
    assert pump(dfleet, lambda: (
        len(fh.new_tokens) >= 3 and fh.status == "running" and fh.replica_id is not None
        and dfleet._replica(fh.replica_id).pool == "decode"))
    src = fh.replica_id
    migs = dfleet.stats["migrations"]
    assert dfleet.migrate(src) == 1
    assert dfleet.stats["migrations"] == migs + 1
    assert fh.replica_id != src and fh.status == "running"
    assert pump(dfleet, fh.done.is_set)
    assert fh.new_tokens == jax_ref_new(p, 12)
    assert fh.restart_consistent and fh.attempts == 3


def test_pool_pressure_signals(dfleet):
    assert dfleet.pool_pressure("prefill") >= 0.0
    assert dfleet.pool_pressure("decode") >= 0.0


# -- churn: cancel + prefill death mid-handoff ---------------------------


def test_cancel_mid_handoff_leaks_nothing():
    reps = [replica(0, _scfg(num_slots=1), pool="prefill").start(threaded=False),
            replica(1, _scfg(num_slots=1), pool="decode").start(threaded=False)]
    router = Router(config=FleetConfig(replicas=2, disagg=True, prefill_pool=1, decode_pool=1))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(17)
    pa, pb = prompt(rng, n=8), prompt(rng, n=8)
    fa = router.submit(Request(prompt=pa, max_new_tokens=10, temperature=0.0))
    assert pump(router, lambda: fa.status == "running" and fa.replica_id == 1)
    fb = router.submit(Request(prompt=pb, max_new_tokens=6, temperature=0.0))
    assert pump(router, lambda: len(router._pending_handoffs) == 1)
    cancelled = router.stats["cancelled"]
    fb.cancel()
    assert pump(router, fb.done.is_set)
    assert fb.finish_reason == "cancelled" and router.stats["cancelled"] == cancelled + 1
    assert not router._pending_handoffs
    assert pump(router, fa.done.is_set)
    assert fa.new_tokens == jax_ref_new(pa, 10)
    _release_directory(router)
    for r in reps:
        assert _ledger_balanced(r), f"replica {r.rid} leaked blocks"
    router.close()


def test_prefill_death_mid_handoff_is_lossless():
    pools = ("prefill", "prefill", "decode")
    reps = [replica(k, _scfg(), pool=pools[k]).start(threaded=False) for k in range(3)]
    router = Router(config=FleetConfig(replicas=3, disagg=True, prefill_pool=2, decode_pool=1))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(19)
    cases = []
    for i in range(8):
        p = prompt(rng, n=4 + (i % 5))
        cases.append((p, 3 + (i % 4), router.submit(Request(
            prompt=p, max_new_tokens=3 + (i % 4), temperature=0.0))))
    for _ in range(2):
        router.step()
    router.fail_replica(0, error=RuntimeError("chaos: pump died"))
    assert not router.directory.mapped_blocks(0)
    handles = [fh for _, _, fh in cases]
    assert pump(router, lambda: all(h.done.is_set() for h in handles))
    for p, n, fh in cases:
        assert fh.finish_reason in ("eos", "length")
        assert fh.new_tokens == jax_ref_new(p, n)[: len(fh.new_tokens)]
        assert fh.restart_consistent
    _release_directory(router)
    for r in reps[1:]:
        assert _ledger_balanced(r), f"replica {r.rid} leaked blocks"
    router.close()


# -- per-pool autoscale ---------------------------------------------------


def test_controller_per_pool_watermarks():
    reps = [replica(0, _scfg(), pool="prefill").start(threaded=False),
            replica(1, _scfg(), pool="decode").start(threaded=False)]
    router = Router(config=FleetConfig(replicas=2, disagg=True, prefill_pool=1, decode_pool=1))
    for r in reps:
        router.add_replica(r, start=False)
    built = []

    def factory(rid, pool):
        built.append((rid, pool))
        return replica(rid, _scfg(), pool=pool)

    pressures = {"prefill": 2.0, "decode": 0.5}
    wm = dict(high_pressure=1.0, low_pressure=0.3, up_ticks=2, down_ticks=2)
    ctl = FleetController(
        router, factory,
        ControllerConfig(pools={
            "prefill": PoolWatermarks(min_replicas=1, max_replicas=2, **wm),
            "decode": PoolWatermarks(min_replicas=1, max_replicas=1, **wm)}),
        reader=lambda pool=None: pressures.get(pool), threaded_replicas=False)
    assert [ctl.tick(), ctl.tick()] == [None, "scale_up"]
    assert built == [(2, "prefill")] and router._replica(2).pool == "prefill"

    def count(pool):
        return sum(1 for r in router.replicas
                   if r.pool == pool and r.state in ("starting", "ready"))

    assert count("prefill") == 2 and count("decode") == 1
    pressures["prefill"] = 0.1
    assert [ctl.tick(), ctl.tick()] == [None, "drain"]
    assert pump(router, lambda: any(r.state == "drained" for r in router.replicas), limit=200)
    assert ctl.tick() == "remove"
    assert count("prefill") == 1 and count("decode") == 1
    pool_actions = [a for a in ctl.actions if "pool" in a]
    assert pool_actions and all(a["pool"] == "prefill" for a in pool_actions)
    ctl2 = FleetController(router, factory)
    assert ctl2.read_pressure("decode") == pytest.approx(router.pool_pressure("decode"))
    router.close()
