"""The port's serving fleet (``serving/fleet/``: router, replicas,
streaming, autoscale) against the JAX package's, on the CPU.

Twins of the fifteen cases of ``tests/test_serving_fleet.py``. The port
replicas serve the JAX ``lm_tiny``'s weights (f32, converted); every
token stream is held bit for bit to the JAX package's sequential
``generate`` (greedy and seeded sampling). Host decisions are held to
JAX's: the tenant-weight parser and ``FleetConfig.from_env`` directly,
and the weighted dispatch counts at the moment the heavy tenant's
backlog empties against a JAX fleet fed the same requests. Replicas are
pumped inline (``threaded=False``) wherever order matters; the one
threaded test (pull streaming) waits on events, not on wall-clock
deadlines.
"""

import os
import threading

import numpy as np
import pytest
from test_torch_fleet_common import (  # noqa: F401
    MAX_LEN,
    _two_threads,
    jax_lm,
    jax_ref,
    port_model,
    prompt,
    replica,
    state_dict,
)

from distributeddeeplearning_tpu.serving import FleetConfig as JaxFleetConfig
from distributeddeeplearning_tpu.serving import Replica as JaxReplica
from distributeddeeplearning_tpu.serving import Request as JaxRequest
from distributeddeeplearning_tpu.serving import Router as JaxRouter
from distributeddeeplearning_tpu.serving import ServeConfig as JaxServeConfig
from distributeddeeplearning_tpu.serving.fleet.router import (
    parse_tenant_weights as jax_parse_tenant_weights,
)
from distributeddeeplearning_tpu_torch import inference
from distributeddeeplearning_tpu_torch.serving import (
    ControllerConfig,
    FleetConfig,
    FleetController,
    QueueFull,
    Request,
    Router,
    ServeConfig,
    Server,
    SlotEngine,
)
from distributeddeeplearning_tpu_torch.serving.fleet.router import parse_tenant_weights


def _scfg(**over):
    kw = dict(num_slots=2, buckets=(8,), prefills_per_step=2)
    kw.update(over)
    return ServeConfig(**kw)


@pytest.fixture(scope="module")
def _pair():
    """Two warmed inline port replicas shared by the non-destructive
    tests (as the JAX file shares its pair)."""
    return [replica(k, _scfg()).start(threaded=False) for k in range(2)]


@pytest.fixture
def fleet(_pair):
    for r in _pair:
        assert r.state == "ready" and r.server.active_count == 0, (
            "previous test left the shared replicas dirty")
    # No straggler quarantine (it reads tick walls; a loaded host's eager
    # CPU ticks would quarantine a healthy replica and move placements);
    # test_torch_fleet_chaos.py covers it.
    router = Router(config=FleetConfig(replicas=2, quantum=8, straggler_factor=1e9))
    for r in _pair:
        r.dispatched = 0
        router.add_replica(r, start=False)
    return router


# -- config / parsing ----------------------------------------------------


@pytest.mark.parametrize("text", ["a:3,b:1.5, c ,d:1", "gold:3,silver:2,bronze:1", " x "])
def test_parse_tenant_weights(text):
    assert parse_tenant_weights(text) == jax_parse_tenant_weights(text)


def test_fleet_config_from_env_and_validation():
    env = {
        "SERVE_REPLICAS": "3", "SERVE_TENANT_WEIGHTS": "gold:4,base:1",
        "SERVE_PLACEMENT": "rr", "SERVE_FLEET_QUEUE_DEPTH": "9",
        "SERVE_FLEET_QUANTUM": "5", "SERVE_DISAGG": "1", "SERVE_POOL_PREFILL": "1",
        "SERVE_CHAOS_PLAN": "crash:tick=3,replica=1", "SERVE_BROWNOUT_STAGES": "spec_off",
        "SERVE_PUMP_HEARTBEAT_S": "0.5", "SERVE_REPLICA_MAX_RESTARTS": "4",
    }
    import dataclasses

    assert dataclasses.asdict(FleetConfig.from_env(env)) == dataclasses.asdict(
        JaxFleetConfig.from_env(env))
    assert dataclasses.asdict(FleetConfig.from_env({})) == dataclasses.asdict(
        JaxFleetConfig.from_env({}))
    FleetConfig.from_env(env).validate()
    for bad in (dict(placement="nope"), dict(replicas=0), dict(tenant_weights={"a": 0.0})):
        with pytest.raises(ValueError):
            FleetConfig(**bad).validate()
        with pytest.raises(ValueError):
            JaxFleetConfig(**bad).validate()


# -- fairness ------------------------------------------------------------


def _fairness_trace(router, request_cls):
    """The fairness test's drive: 12 requests each of tenants a (3) and
    b (1); the dispatched counts at the instant a's backlog empties."""
    router.set_tenant_weight("a", 3.0)
    router.set_tenant_weight("b", 1.0)
    rng = np.random.RandomState(0)
    by_tenant = {"a": [], "b": []}
    for _ in range(12):
        for t in ("a", "b"):
            by_tenant[t].append(router.submit(request_cls(
                prompt=prompt(rng), max_new_tokens=4, temperature=0.0), tenant=t))
    trigger = None
    for _ in range(4000):
        busy = router.step()
        if trigger is None and router.tenant_stats()["a"]["queued"] == 0:
            trigger = {t: sum(1 for fh in hs if fh.attempts > 0) for t, hs in by_tenant.items()}
        if not busy:
            break
    return trigger, by_tenant


def test_weighted_fair_dispatch_shares(fleet):
    """Token-cost DRR: the port's dispatched counts when the heavy
    tenant's backlog empties equal a JAX fleet's on the same requests,
    and track the 3:1 weights."""
    model, params = jax_lm()
    jax_router = JaxRouter(config=JaxFleetConfig(replicas=2, quantum=8, straggler_factor=1e9))
    for k in range(2):
        jax_router.add_replica(JaxReplica(k, model, params, JaxServeConfig(
            num_slots=2, buckets=(8,), prefills_per_step=2), max_len=MAX_LEN).start(
                threaded=False), start=False)
    want, jax_handles = _fairness_trace(jax_router, JaxRequest)
    got, by_tenant = _fairness_trace(fleet, Request)
    assert got == want, (got, want)
    assert got["a"] == 12 and 2 <= got["b"] <= 6, got
    for t, hs in by_tenant.items():
        for fh, jfh in zip(hs, jax_handles[t]):
            assert fh.finish_reason == "length"
            assert fh.new_tokens == jfh.new_tokens
    jax_router.close()


def test_no_starvation_under_hot_neighbour(fleet):
    fleet.set_tenant_weight("hot", 16.0)
    fleet.set_tenant_weight("cold", 1.0)
    rng = np.random.RandomState(1)
    hot = [fleet.submit(Request(prompt=prompt(rng), max_new_tokens=4, temperature=0.0),
                        tenant="hot") for _ in range(24)]
    cp = prompt(rng)
    cold = fleet.submit(Request(prompt=cp, max_new_tokens=4, temperature=0.0), tenant="cold")
    for _ in range(4000):
        if cold.done.is_set() or not fleet.step():
            break
    assert cold.done.is_set() and cold.finish_reason == "length"
    assert fleet.tenant_stats()["hot"]["queued"] > 0
    fleet.drain(timeout=300)
    assert all(h.finish_reason == "length" for h in hot)
    np.testing.assert_array_equal(cold.result(timeout=0), jax_ref(cp, 4))


def _dispatch_order(router, stall=()):
    """Submission indices in dispatch order for 8 requests each of
    tenants a (3), b (2) and c (1), costs 2 to 4 tokens; ``_place``
    finds no admitting replica on its calls numbered in ``stall``."""
    for t, w in (("a", 3.0), ("b", 2.0), ("c", 1.0)):
        router.set_tenant_weight(t, w)
    rng = np.random.RandomState(4)
    index, order, calls = {}, [], [0]
    place, dispatch_to = router._place, router._dispatch_to

    def stalled_place(fh):
        calls[0] += 1
        return None if calls[0] in stall else place(fh)

    def recorded(replica, fh):
        order.append(index[fh.id])
        dispatch_to(replica, fh)

    router._place, router._dispatch_to = stalled_place, recorded
    for i in range(8):
        for t in ("a", "b", "c"):
            fh = router.submit(Request(prompt=prompt(rng), max_new_tokens=2 + (i + len(index)) % 3,
                                       temperature=0.0), tenant=t)
            index[fh.id] = len(index)
    router.drain(timeout=300)
    return order


def test_blocked_placement_keeps_the_drr_order(fleet, _pair):
    """A head request that no replica admits (a counted slot whose
    replica is still prefilling it) ends the dispatch tick with the
    cursor where it was: the dispatch order equals an unstalled fleet's.
    Moving on instead banked a quantum for each tenant visited while the
    stall lasted, and the weights stopped deciding the order."""
    want = _dispatch_order(fleet)
    again = Router(config=FleetConfig(replicas=2, quantum=8, straggler_factor=1e9))
    for r in _pair:
        again.add_replica(r, start=False)
    got = _dispatch_order(again, stall={3, 4, 5, 6, 9, 10, 11, 12, 13, 14})
    assert sorted(got) == list(range(24))
    assert got == want, (got, want)


# -- parity + placement --------------------------------------------------


def test_fleet_parity_and_least_loaded_spread(fleet):
    rng = np.random.RandomState(2)
    cases = []
    for i in range(8):
        p = prompt(rng)
        cases.append((p, fleet.submit(Request(
            prompt=p, max_new_tokens=6, temperature=0.8, top_k=8, rng=i))))
    fleet.drain(timeout=300)
    for i, (p, fh) in enumerate(cases):
        np.testing.assert_array_equal(
            fh.result(timeout=0), jax_ref(p, 6, seed=i, temperature=0.8, top_k=8))
    assert {fh.replica_id for _, fh in cases} == {0, 1}


def test_queue_full_backpressure(fleet):
    fleet.config.queue_depth = 3
    rng = np.random.RandomState(3)
    handles = [fleet.submit(Request(prompt=prompt(rng), max_new_tokens=2)) for _ in range(3)]
    with pytest.raises(QueueFull):
        fleet.submit(Request(prompt=prompt(rng), max_new_tokens=2))
    fleet.drain(timeout=300)
    assert all(h.finish_reason == "length" for h in handles)


# -- streaming -----------------------------------------------------------


def test_stream_iterator_matches_final_tokens():
    """Server-level pull streaming from another pumping thread: the
    iterator yields exactly the final tokens, which equal JAX's."""
    engine = SlotEngine(port_model(), state_dict(), num_slots=2, max_len=MAX_LEN,
                        buckets=(8,), device="cpu")
    engine.warmup()
    server = Server(engine, prefills_per_step=2)
    p = prompt(np.random.RandomState(4))
    seen = []
    h = server.submit(Request(prompt=p, max_new_tokens=8, temperature=0.0,
                              on_token=lambda _h, toks: seen.extend(toks)))
    stop = threading.Event()
    pump = threading.Thread(target=server.serve_forever, args=(stop,))
    pump.start()
    try:
        streamed = list(h.stream(timeout=120))
    finally:
        stop.set()
        pump.join(timeout=120)
    assert streamed == h.new_tokens == seen
    np.testing.assert_array_equal(h.tokens, jax_ref(p, 8))


def test_generate_engine_route_streams_on_token(fleet):
    rng = np.random.RandomState(5)
    prompts = np.stack([prompt(rng, 6), prompt(rng, 6)])
    got_stream = {0: [], 1: []}
    out = inference.generate(None, prompts, max_new_tokens=5, engine=fleet,
                             on_token=lambda row, tok: got_stream[row].append(tok))
    for b in range(2):
        np.testing.assert_array_equal(
            out[b].numpy(), np.concatenate([prompts[b], np.asarray(got_stream[b], np.int32)]))
    np.testing.assert_array_equal(out[0].numpy(), jax_ref(prompts[0], 5))


def test_on_token_requires_engine():
    model = port_model()
    with pytest.raises(ValueError, match="on_token"):
        inference.generate(model, np.zeros((1, 4), np.int32), max_new_tokens=2,
                           on_token=lambda row, tok: None)


# -- drain / fault / rejoin ----------------------------------------------


def test_drain_mid_load_completes_everything(fleet):
    rng = np.random.RandomState(6)
    cases = []
    for _ in range(10):
        p = prompt(rng)
        cases.append((p, fleet.submit(Request(prompt=p, max_new_tokens=6, temperature=0.0))))
    for _ in range(2):
        fleet.step()
    fleet.drain_replica(0)
    fleet.drain(timeout=300)
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 6))
        assert fh.finish_reason == "length"
    r0 = fleet._replica(0)
    assert r0.state == "drained"
    assert fleet.stats["completed"] == len(cases)
    programs_before = r0.engine.compile_count
    fleet.rejoin_replica(0, threaded=False)
    assert r0.state == "ready" and r0.engine.compile_count == programs_before
    h = fleet.submit(Request(prompt=prompt(rng), max_new_tokens=3))
    fleet.drain(timeout=300)
    assert h.finish_reason == "length"


def test_fault_reroutes_running_and_splices_bitwise():
    reps = [replica(k, _scfg()).start(threaded=False) for k in range(2)]
    router = Router(config=FleetConfig(replicas=2, quantum=64))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(7)
    cases = []
    for _ in range(6):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=10, temperature=0.0))))
    for _ in range(3):
        router.step()
    r0 = router._replica(0)
    assert r0.server.active_count > 0
    before = {fh.id: list(fh.new_tokens) for _, fh in cases}
    old_engine = r0.engine
    r0.engine.decode_step = lambda: (_ for _ in ()).throw(RuntimeError("injected engine fault"))
    router.step()
    assert r0.state == "faulted" and r0.retryable
    router.step()
    assert router.stats["requeued"] > 0
    router.drain(timeout=300)
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 10))
        assert fh.restart_consistent
        assert fh.new_tokens[: len(before[fh.id])] == before[fh.id]
    router.rejoin_replica(0, threaded=False)
    assert r0.state == "ready" and r0.fault is None
    # The faulted engine was released and a new one built.
    assert r0.engine is not old_engine and old_engine.model is None
    h = router.submit(Request(prompt=cases[0][0], max_new_tokens=3))
    router.drain(timeout=300)
    assert h.finish_reason == "length"


# -- prefix affinity -----------------------------------------------------


def test_prefix_affinity_routes_to_owning_replica():
    scfg = _scfg(kv_layout="paged", block_size=4, num_blocks=64, prefix_cache=True,
                 buckets=(16, 32))
    reps = [replica(k, scfg).start(threaded=False) for k in range(2)]
    router = Router(config=FleetConfig(replicas=2, placement="affinity"))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(8)
    shared = prompt(rng, 12)
    h1 = router.submit(Request(prompt=shared, max_new_tokens=3))
    router.drain(timeout=300)
    owner = h1.replica_id
    assert owner is not None
    assert router._replica(owner).prefix_hit_blocks(shared) > 0
    assert router._replica(1 - owner).prefix_hit_blocks(shared) == 0
    p2 = np.concatenate([shared, prompt(rng, 6)])
    h2 = router.submit(Request(prompt=p2, max_new_tokens=3))
    router.step()
    assert h2.replica_id == owner
    last = router._replica(owner).engine.last_prefill
    assert last["shared_blocks"] > 0 and last["start"] > 0
    router.drain(timeout=300)
    np.testing.assert_array_equal(h2.result(timeout=0), jax_ref(p2, 3))
    h3 = router.submit(Request(prompt=prompt(rng, 6), max_new_tokens=2))
    router.drain(timeout=300)
    assert h3.finish_reason == "length"
    router.close()


# -- autoscale signal + controller ---------------------------------------


def test_pressure_rises_with_backlog(fleet):
    rng = np.random.RandomState(9)
    assert fleet.pressure() == 0.0
    handles = [fleet.submit(Request(prompt=prompt(rng), max_new_tokens=2)) for _ in range(12)]
    assert fleet.pressure() == pytest.approx(3.0)  # 12 demanded over 4 ready slots
    fleet.step()
    assert fleet.last_pressure > 0
    fleet.drain(timeout=300)
    assert fleet.pressure() == 0.0
    assert all(h.finish_reason == "length" for h in handles)


def test_controller_scales_up_and_drains():
    """The JAX test's pressure trace and decisions: scale_up at the
    third hot tick, drain at the second cold one, remove once the
    drained replica parks."""
    reps = [replica(0, _scfg()).start(threaded=False)]
    router = Router(config=FleetConfig(replicas=1))
    router.add_replica(reps[0], start=False)
    built = []

    def factory(rid):
        built.append(rid)
        return replica(rid, _scfg())

    trace = iter([2.5, 2.5, 2.5, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])
    ctl = FleetController(
        router, factory,
        ControllerConfig(min_replicas=1, max_replicas=2, high_pressure=1.0,
                         low_pressure=0.3, up_ticks=3, down_ticks=2),
        reader=lambda: next(trace, None), threaded_replicas=False)
    decisions = [ctl.tick() for _ in range(3)]
    assert decisions == [None, None, "scale_up"] and built == [1]
    assert len(router.replicas) == 2
    assert [ctl.tick(), ctl.tick()] == [None, "drain"]
    assert len([r for r in router.replicas if r.state in ("draining", "drained")]) == 1
    router.step()
    assert ctl.tick() == "remove"
    assert len(router.replicas) == 1 and router.replicas[0].state == "ready"
    router.close()


# -- per-replica observability -------------------------------------------


def test_per_replica_event_streams_and_watch_rows(tmp_path, monkeypatch):
    """Each replica writes its own ``events-p0-s<k>.jsonl``; the port's
    live plane grows a per-proc section with each replica's gauges, and
    the fleet gauge lands on the router's stream."""
    from distributeddeeplearning_tpu_torch import obs
    from distributeddeeplearning_tpu_torch.obs.rollup import LivePlane

    obsdir = str(tmp_path / "run")
    monkeypatch.setenv("OBS_DIR", obsdir)
    obs.configure(obsdir)
    try:
        reps = [replica(k, _scfg(), obs_dir=obsdir).start(threaded=False) for k in range(2)]
        router = Router(config=FleetConfig(replicas=2))
        for r in reps:
            router.add_replica(r, start=False)
        rng = np.random.RandomState(10)
        for _ in range(6):
            router.submit(Request(prompt=prompt(rng), max_new_tokens=3))
        router.drain(timeout=300)
        obs.flush()
        for r in reps:
            r.bus.flush()
        names = sorted(os.listdir(obsdir))
        assert "events-p0-s0.jsonl" in names and "events-p0-s1.jsonl" in names
        snap = LivePlane(obsdir).poll(write=False)
        procs = snap.get("procs")
        assert procs and {"p0-s0", "p0-s1"} <= set(procs)
        for k in ("p0-s0", "p0-s1"):
            assert "serve.slot_occupancy" in procs[k] and "serve.programs" in procs[k]
        assert "serve.fleet_pressure" in snap["gauges"]
        router.close()
    finally:
        obs.reset()
