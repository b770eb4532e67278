"""The port's serving chaos plane and brownout ladder against the JAX
package's, on the CPU.

Twins of the seventeen cases of ``tests/test_serving_chaos.py``:

* the chaos-plan grammar, ``storm_plan``, the brownout-stage parser,
  ``FleetConfig``'s chaos knobs and the ``ChaosInjector``'s decisions
  are run on both packages and held equal, call for call;
* the drills (straggler quarantine, corrupt detect-and-heal, the
  crash-loop breaker, the controller's breaker hold, the brownout
  ladder's steps, spec_off mid-stream, the max_new cap, the stream
  timeout, the hung pump and a mixed storm) run port replicas over the
  JAX ``lm_tiny``'s converted weights, and every completed stream is
  held bit for bit to the JAX package's sequential ``generate``. The
  ladder's transitions are the JAX test's, in sequence.

The one threaded drill (the hang) gives its healthy replica a heartbeat
limit well above a loaded host's tick, so only the hung pump goes stale.
"""

import dataclasses
import time

import numpy as np
import pytest
from test_torch_fleet_common import (  # noqa: F401
    MAX_LEN,
    _two_threads,
    jax_ref,
    port_model,
    prompt,
    replica,
    state_dict,
)

from distributeddeeplearning_tpu.serving import FleetConfig as JaxFleetConfig
from distributeddeeplearning_tpu.serving import chaos as jax_chaos
from distributeddeeplearning_tpu.serving.scheduler import (
    parse_brownout_stages as jax_parse_brownout_stages,
)
from distributeddeeplearning_tpu_torch.serving import (
    BrownoutLadder,
    BrownoutStage,
    ChaosInjector,
    ControllerConfig,
    FleetConfig,
    FleetController,
    Request,
    Router,
    ServeConfig,
    Server,
    SlotEngine,
    parse_brownout_stages,
    parse_chaos_plan,
    storm_plan,
)
from distributeddeeplearning_tpu_torch.serving.chaos import SLOW_UNIT_S, FleetFault


def _scfg(**over):
    kw = dict(num_slots=2, buckets=(8,), prefills_per_step=2)
    kw.update(over)
    return ServeConfig(**kw)


def _fcfg(**over):
    kw = dict(replicas=2, quantum=64, max_restarts=1, restart_backoff_s=0.01, fault_join_s=0.5,
              straggler_factor=2.5, straggler_ticks=3, quarantine_ticks=8)
    kw.update(over)
    return FleetConfig(**kw)


def _fresh_pair(n=2):
    return [replica(k, _scfg()).start(threaded=False) for k in range(n)]


def _faults(plan_fn, text):
    return [dataclasses.asdict(f) for f in plan_fn(text)]


# -- grammar / config ----------------------------------------------------


def test_parse_chaos_plan_grammar():
    text = ("crash:tick=3,replica=0;slow:tick=5,replica=1,factor=6,secs=0.5;"
            "corrupt:tick=7,replica=1;flap:tick=4,replica=0,count=3;"
            "hang:tick=9,replica=1,secs=1.5")
    got = _faults(parse_chaos_plan, text)
    assert got == _faults(jax_chaos.parse_chaos_plan, text)
    assert [f["kind"] for f in got] == ["crash", "slow", "corrupt", "flap", "hang"]
    assert parse_chaos_plan("") == []


@pytest.mark.parametrize("bad", [
    "melt:tick=3,replica=0", "crash:replica=0", "crash:tick=3", "crash:tick=0,replica=0",
    "crash:tick=3,replica=0,count=2", "crash:tick=3,replica=0,factor=4",
    "slow:tick=3,replica=0,factor=1", "flap:tick=3,replica=0,count=0", "crash:tick3,replica=0",
])
def test_parse_chaos_plan_rejects(bad):
    with pytest.raises(ValueError):
        parse_chaos_plan(bad)
    with pytest.raises(ValueError):
        jax_chaos.parse_chaos_plan(bad)


def test_storm_plan_is_seeded_and_valid():
    for seed in (0, 7, 8, 217):
        for spread in (240, 160):
            assert storm_plan(2, seed=seed, spread=spread) == jax_chaos.storm_plan(
                2, seed=seed, spread=spread)
    a = storm_plan(2, seed=7)
    assert a == storm_plan(2, seed=7) and a != storm_plan(2, seed=8)
    assert {f.kind for f in parse_chaos_plan(a)} == {"crash", "hang", "slow", "corrupt", "flap"}
    with pytest.raises(ValueError):
        storm_plan(2, verbs=("melt",))


def test_parse_brownout_stages():
    text = "spec_off, max_new:8, shed:1"
    assert [dataclasses.asdict(s) for s in parse_brownout_stages(text)] == [
        dataclasses.asdict(s) for s in jax_parse_brownout_stages(text)]
    for bad in ("nope", "max_new", "shed:0", "spec_off:3", ""):
        with pytest.raises(ValueError):
            parse_brownout_stages(bad)


def test_fleet_config_chaos_knobs_from_env():
    env = {"SERVE_STRAGGLER_FACTOR": "3.5", "SERVE_STRAGGLER_TICKS": "4",
           "SERVE_QUARANTINE_TICKS": "20", "SERVE_PUMP_HEARTBEAT_S": "2.5",
           "SERVE_REPLICA_MAX_RESTARTS": "2", "SERVE_REPLICA_RESTART_BACKOFF": "0.25",
           "SERVE_BROWNOUT_STAGES": "spec_off,shed:1",
           "SERVE_CHAOS_PLAN": "crash:tick=2,replica=0", "SERVE_CHAOS_SEED": "9"}
    cfg = FleetConfig.from_env(env)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxFleetConfig.from_env(env))
    cfg.validate()
    for bad in (dict(straggler_factor=1.0), dict(brownout_stages="bogus"),
                dict(chaos_plan="melt:tick=1,replica=0")):
        with pytest.raises(ValueError):
            FleetConfig(**bad).validate()


# -- injector units ------------------------------------------------------


def _injector_trace(mod):
    """The JAX test's injector calls, recorded: due / pump_action
    results in order."""
    inj = mod.ChaosInjector(mod.parse_chaos_plan(
        "crash:tick=2,replica=0;slow:tick=3,replica=1,factor=4,secs=0.2"))
    out = [inj.due(1)]
    due = inj.due(2)
    out += [[f.kind for f in due], inj.due(2)]
    now = 1000.0
    inj.arm_pump(due[0], now)
    out += [inj.pump_action(1, now), inj.pump_action(0, now)["kind"], inj.pump_action(0, now)]
    slow = inj.due(3)[0]
    inj.arm_pump(slow, now)
    a = inj.pump_action(1, now)
    out += [a["kind"], a["stall_s"], inj.pump_action(1, now)["kind"],
            inj.pump_action(1, now + 1.0)]
    return out


def test_injector_due_and_pump_actions():
    from distributeddeeplearning_tpu_torch.serving import chaos

    got = _injector_trace(chaos)
    assert got == _injector_trace(jax_chaos)
    assert got[4] == "crash" and got[6] == got[8] == "slow"
    assert got[7] == pytest.approx(4 * SLOW_UNIT_S) and got[-1] is None


def test_injector_flap_rearms_and_corrupt_flips_once():
    def drive(mod):
        inj = mod.ChaosInjector([mod.FleetFault("flap", tick=1, replica=0, count=2)])
        f = inj.due(1)[0]
        inj.arm_pump(f, 0.0)
        out = [inj.pump_action(0, 0.0)["kind"], inj.pump_action(0, 0.0)["kind"],
               inj.pump_action(0, 0.0)]
        inj.arm_corrupt(mod.FleetFault("corrupt", tick=1, replica=0), fh_id=7)
        out += [inj.maybe_corrupt(5, 10), inj.maybe_corrupt(7, 10), inj.maybe_corrupt(7, 10),
                [e["kind"] for e in inj.fired]]
        return out

    from distributeddeeplearning_tpu_torch.serving import chaos

    got = drive(chaos)
    assert got == drive(jax_chaos)
    assert got[:3] == ["crash", "crash", None] and got[3:6] == [10, 11, 10]
    assert FleetFault is chaos.FleetFault


# -- straggler quarantine -> splice parity -------------------------------


def test_straggler_quarantine_hedges_with_bitwise_splice():
    reps = _fresh_pair()
    router = Router(config=_fcfg(straggler_ticks=2, quarantine_ticks=6),
                    chaos=ChaosInjector(parse_chaos_plan(
                        "slow:tick=2,replica=1,factor=8,secs=10")))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(20)
    cases = []
    for _ in range(8):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=8, temperature=0.0))))
    quarantined_at = None
    for tick in range(4000):
        busy = router.step()
        if quarantined_at is None and reps[1].quarantined:
            quarantined_at = tick
        if not busy:
            break
    assert quarantined_at is not None and router.stats["quarantined"] >= 1
    delivered = {fh.id: list(fh.new_tokens) for _, fh in cases}
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 8))
        assert fh.restart_consistent and fh.finish_reason == "length"
        assert fh.new_tokens == delivered[fh.id]
    assert router.stats["requeued"] > 0
    for _ in range(router.config.quarantine_ticks + 2):
        router.step()
    assert not reps[1].quarantined and router.stats["unquarantined"] >= 1


# -- corrupt detection -> heal -------------------------------------------


def test_corrupt_token_detected_and_healed_never_delivered():
    reps = _fresh_pair()
    router = Router(config=_fcfg(max_restarts=2, restart_backoff_s=0.01, quarantine_ticks=4),
                    chaos=ChaosInjector(parse_chaos_plan("corrupt:tick=3,replica=0")))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(21)
    cases = []
    for _ in range(6):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=10, temperature=0.0))))
    router.drain(timeout=600)
    assert router.stats["splice_mismatch"] >= 1
    victims = [fh for _, fh in cases if fh.splice_mismatches]
    assert victims
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 10))
        assert fh.restart_consistent and fh.finish_reason == "length"
    assert victims[0].attempts >= 3


# -- crash-loop breaker --------------------------------------------------


def test_flap_beyond_budget_opens_breaker_and_work_survives():
    reps = _fresh_pair()
    router = Router(config=_fcfg(max_restarts=1, restart_backoff_s=0.01),
                    chaos=ChaosInjector(parse_chaos_plan("flap:tick=2,replica=1,count=3")))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(22)
    cases = []
    for _ in range(6):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=6, temperature=0.0))))
    for _ in range(100_000):
        if not (router.step() or any(r.state == "faulted" for r in router.replicas)):
            break
    assert router.stats["rejoins"] == 1 and router.stats["breaker_open"] == 1
    assert [r.rid for r in router.replicas] == [0]
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 6))
        assert fh.restart_consistent
    with pytest.raises(RuntimeError, match="breaker"):
        router.rejoin_replica(reps[1])
    with pytest.raises(RuntimeError, match="breaker"):
        router.add_replica(reps[1], start=False)


def test_controller_holds_scale_up_after_breaker_opens():
    reps = _fresh_pair(n=1)
    router = Router(config=_fcfg(replicas=1, max_restarts=0))
    router.add_replica(reps[0], start=False)
    router.add_replica(replica(1, _scfg()).start(threaded=False), start=False)
    router.fail_replica(1, RuntimeError("drill"))
    router.step()
    assert router.stats["breaker_open"] == 1
    built = []

    def factory(rid):
        built.append(rid)
        return replica(rid, _scfg())

    ctl = FleetController(router, factory,
                          ControllerConfig(min_replicas=1, max_replicas=3, up_ticks=1,
                                           breaker_block_ticks=1000),
                          reader=lambda: 5.0, threaded_replicas=False)
    assert ctl.tick() is None and built == []
    assert [a for a in ctl.actions if a["action"] == "scaleup_denied"] == [
        {"action": "scaleup_denied", "reason": "breaker", "pressure": 5.0,
         "breaker_tick": router.last_breaker_tick}]
    ctl.config.breaker_block_ticks = 0
    assert ctl.tick() is None and len(ctl.actions) == 1
    for _ in range(ctl.config.denied_backoff_ticks):
        router.step()
    assert ctl.tick() == "scale_up" and built == [2]
    router.close()


# -- brownout ladder -----------------------------------------------------


def test_brownout_ladder_steps_down_and_back_up():
    reps = _fresh_pair()
    burn = {"on": False}
    ladder = BrownoutLadder(
        parse_brownout_stages("spec_off,shed:1"),
        reader=lambda: {"slo": [{"objective": "drill", "stat": "p99", "metric": "serve.ttft",
                                 "burning": burn["on"]}]},
        refresh_s=0.0, escalate_ticks=2, recover_ticks=2)
    router = Router(config=_fcfg(), brownout=ladder)
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(23)
    router.set_tenant_weight("gold", 3.0)
    router.set_tenant_weight("cheap", 1.0)
    gold = [router.submit(Request(prompt=prompt(rng), max_new_tokens=4, temperature=0.0),
                          tenant="gold") for _ in range(4)]
    cheap = [router.submit(Request(prompt=prompt(rng), max_new_tokens=4, temperature=0.0),
                           tenant="cheap") for _ in range(24)]
    burn["on"] = True
    for _ in range(4):
        router.step()
    assert ladder.level == 2 and all(r.engine.spec_suspended for r in reps)
    shed = [fh for fh in cheap if fh.finish_reason == "brownout"]
    assert shed and all(fh.done.is_set() for fh in shed)
    assert router.stats["brownout"] == len(shed)
    fh = router.submit(Request(prompt=prompt(rng), max_new_tokens=4), tenant="cheap")
    assert fh.finish_reason == "brownout" and fh.done.is_set()
    burn["on"] = False
    for _ in range(6):
        router.step()
    assert ladder.level == 0 and not any(r.engine.spec_suspended for r in reps)
    assert [(t["direction"], t["stage"]) for t in ladder.transitions] == [
        ("down", "spec_off"), ("down", "shed"), ("up", "shed"), ("up", "spec_off")]
    fh2 = router.submit(Request(prompt=prompt(rng), max_new_tokens=4), tenant="cheap")
    router.drain(timeout=300)
    assert fh2.finish_reason == "length"
    assert all(fh.finish_reason == "length" for fh in gold)


@pytest.mark.parametrize("draft", ["ngram", "int8"])
def test_brownout_spec_off_keeps_greedy_parity(draft):
    """spec_off mid-stream and back (n-gram, as the JAX test, and the
    int8 self-draft): greedy output equals JAX's ``generate`` and the
    program set never grows."""
    engine = SlotEngine(port_model(), state_dict(), num_slots=2, max_len=MAX_LEN, buckets=(8,),
                        spec_k=3, spec_draft=draft, device="cpu")
    engine.warmup()
    programs = engine.compile_count
    server = Server(engine, prefills_per_step=2)
    p = prompt(np.random.RandomState(28))
    h = server.submit(Request(prompt=p, max_new_tokens=12, temperature=0.0))
    for _ in range(2):
        server.step()
    engine.spec_suspended = True
    for _ in range(3):
        server.step()
    engine.spec_suspended = False
    server.drain(timeout=300)
    np.testing.assert_array_equal(h.tokens, jax_ref(p, 12))
    assert h.finish_reason == "length"
    assert engine.compile_count == programs == engine.programs_expected


def test_brownout_max_new_caps_new_dispatches():
    reps = _fresh_pair()
    router = Router(config=_fcfg())
    for r in reps:
        router.add_replica(r, start=False)
    router.apply_brownout_stage(BrownoutStage("max_new", 2), True, key=1)
    rng = np.random.RandomState(24)
    p = prompt(rng)
    h = router.submit(Request(prompt=p, max_new_tokens=10))
    router.drain(timeout=300)
    assert h.new_tokens == [int(t) for t in jax_ref(p, 2)[len(p):]]
    router.apply_brownout_stage(BrownoutStage("max_new", 2), False, key=1)
    h2 = router.submit(Request(prompt=prompt(rng), max_new_tokens=4))
    router.drain(timeout=300)
    assert len(h2.new_tokens) == 4


# -- stream timeout contract ---------------------------------------------


def test_fleet_stream_timeout_cancels_and_detaches():
    reps = _fresh_pair()
    router = Router(config=_fcfg())
    for r in reps:
        router.add_replica(r, start=False)
    fh = router.submit(Request(prompt=prompt(np.random.RandomState(25)), max_new_tokens=4))
    with pytest.raises(TimeoutError, match="cancelled"):
        list(fh.stream(timeout=0.05))  # nothing pumps: the wait expires
    assert fh._cancel
    router.drain(timeout=300)
    assert fh.finish_reason == "cancelled" and router.stats["cancelled"] == 1


# -- hung pump containment + full storm ----------------------------------


def test_hang_hard_faults_and_detaches_thread_leak():
    """Threaded: a chaos hang (4 s) outlasts the heartbeat limit (1 s)
    and the join timeout (0.2 s): the replica is hard-faulted, its
    thread detached (``leaked_threads``), the work re-routes bitwise and
    the budgeted rejoin brings it back."""
    reps = [replica(k, _scfg()).start(threaded=True) for k in range(2)]
    t0 = time.monotonic()
    while not all(r.state == "ready" for r in reps):
        assert time.monotonic() - t0 < 600
        time.sleep(0.01)
    router = Router(config=_fcfg(heartbeat_timeout_s=1.0, fault_join_s=0.2, max_restarts=2,
                                 restart_backoff_s=0.05),
                    chaos=ChaosInjector(parse_chaos_plan("hang:tick=3,replica=1,secs=4.0")))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(26)
    cases = []
    for _ in range(8):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=8, temperature=0.0))))
    t0 = time.monotonic()
    leaked = False
    while router.step() or any(r.state == "faulted" for r in router.replicas):
        leaked = leaked or reps[1].leaked_threads > 0
        assert time.monotonic() - t0 < 600
        time.sleep(0.005)
    assert leaked and reps[1].leaked_threads == 1
    assert router.stats["rejoins"] >= 1
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 8))
        assert fh.restart_consistent
    router.fail_replica(1, RuntimeError("drill"))
    assert router.fail_replica(1, RuntimeError("drill")) == 0
    router.close()


def test_mixed_verb_storm_completes_with_parity():
    reps = _fresh_pair()
    plan = "slow:tick=4,replica=1,factor=8,secs=0.6;crash:tick=8,replica=0;corrupt:tick=14,replica=1"
    router = Router(config=_fcfg(max_restarts=3, restart_backoff_s=0.01, straggler_ticks=2,
                                 quarantine_ticks=10),
                    chaos=ChaosInjector(parse_chaos_plan(plan)))
    for r in reps:
        router.add_replica(r, start=False)
    rng = np.random.RandomState(27)
    cases = []
    for _ in range(10):
        p = prompt(rng)
        cases.append((p, router.submit(Request(prompt=p, max_new_tokens=10, temperature=0.0))))
    t0 = time.monotonic()
    while router.step() or any(r.state == "faulted" for r in router.replicas):
        assert time.monotonic() - t0 < 600
    for p, fh in cases:
        np.testing.assert_array_equal(fh.result(timeout=0), jax_ref(p, 10))
        assert fh.restart_consistent and fh.finish_reason == "length"
    assert router.stats["splice_mismatch"] >= 1
    for r in router.replicas:
        assert r.engine.compile_count == r.engine.programs_expected
    assert all(row["state"] == "ready" for row in router.fleet_snapshot())
