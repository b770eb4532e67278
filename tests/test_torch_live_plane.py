"""The port's live telemetry plane against the JAX package's.

``obs/rollup.py``, ``obs/slo.py`` and ``obs/traces.py`` of the port are
copies of the JAX package's jax-free modules, and the port's scheduler
carries the adaptive admission policy. Here:

* the same seeded event files go through both packages' ``LivePlane``
  (tail -> rollup -> SLO) and must give equal snapshots, burn rates and
  breach/recover points, and through both ``traces.reconstruct`` and
  report trace sections, which must be equal;
* the JAX live-plane oracles, twinned on the port: the rollup's
  quantile bound, window expiry, gauges, the atomic snapshot and torn
  read, the ``SLO_SPEC`` grammar and its rejections, multi-window burn
  semantics, ``finite`` and ``rate`` objectives, points on the bus;
* ``AdaptiveAdmissionPolicy``: its derate/restore sequence on a list of
  snapshots equals the JAX policy's, it ignores non-latency objectives,
  ``ServeConfig`` builds it from ``SERVE_ADMISSION_POLICY``;
* end to end, a small port ``Server`` on the CPU under the live plane
  and a breaching TTFT objective sheds, then recovers, and the merged
  stream tells the story in order.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import obs as jax_obs
from distributeddeeplearning_tpu.obs import report as jax_report
from distributeddeeplearning_tpu.obs import rollup as jax_rollup
from distributeddeeplearning_tpu.obs import slo as jax_slo
from distributeddeeplearning_tpu.obs import traces as jax_traces
from distributeddeeplearning_tpu.serving import scheduler as jax_scheduler
from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.obs import report, traces
from distributeddeeplearning_tpu_torch.obs import rollup as port_rollup
from distributeddeeplearning_tpu_torch.obs import slo as port_slo
from distributeddeeplearning_tpu_torch.obs.bus import EventBus
from distributeddeeplearning_tpu_torch.obs.rollup import (
    HIST_GROWTH,
    LivePlane,
    WindowedAggregator,
    read_snapshot,
    write_snapshot,
)
from distributeddeeplearning_tpu_torch.obs.slo import (
    BURN_MAX,
    SloEngine,
    parse_slo_spec,
)
from distributeddeeplearning_tpu_torch.serving import (
    AdaptiveAdmissionPolicy,
    ServeConfig,
    scheduler,
)


@pytest.fixture(autouse=True)
def _fresh_buses():
    obs.reset()
    jax_obs.reset()
    yield
    obs.reset()
    jax_obs.reset()


def _write(path, *records, mode="a"):
    with open(path, mode) as fh:
        for r in records:
            fh.write(json.dumps(r) + "\n")


def _served_stream(directory, seed, n_requests=12):
    """A seeded two-process serving run as event files: per-request
    trace-stamped queue/prefill/decode/delivery spans and outcome points,
    the shared tick trace's decode steps, counters and gauges, each
    process on its own monotonic clock."""
    rng = np.random.RandomState(seed)
    for p, (mono0, wall0) in enumerate(((100.0, 5000.0), (7.0, 5000.5))):
        recs = [{"kind": "meta", "schema": 1, "run": "r-diff", "p": p,
                 "mono0": mono0, "wall0": wall0}]
        t = mono0 + 1.0
        for i in range(n_requests):
            tid = f"t{p}-{i}"
            req = p * 100 + i
            t += float(rng.exponential(0.05))
            qwait = float(rng.exponential(0.01))
            prefill = float(rng.uniform(0.002, 0.03))
            recs.append({"t": t, "kind": "gauge", "name": "serve.queue_depth",
                         "value": float(rng.randint(0, 8)), "p": p, "trace": tid})
            recs.append({"t": t, "kind": "span", "name": "serve.queue_wait", "dur": qwait,
                         "p": p, "trace": tid, "labels": {"req": req}})
            t0 = t + qwait
            recs.append({"t": t0, "kind": "span", "name": "serve.prefill", "dur": prefill,
                         "p": p, "trace": tid, "labels": {"bucket": 16, "slot": i % 4}})
            recs.append({"t": t, "kind": "span", "name": "serve.ttft",
                         "dur": qwait + prefill, "p": p, "trace": tid, "labels": {"req": req}})
            td = t0 + prefill
            n_tok = int(rng.randint(2, 9))
            for _ in range(n_tok - 1):
                share = float(rng.uniform(0.001, 0.01))
                recs.append({"t": td, "kind": "span", "name": "serve.decode_share",
                             "dur": share, "p": p, "trace": tid,
                             "labels": {"req": req, "active": 3}})
                recs.append({"t": td, "kind": "span", "name": "serve.decode_step",
                             "dur": share * 3, "p": p, "trace": f"tick{p}"})
                td += share
            recs.append({"t": td, "kind": "span", "name": "serve.delivery", "dur": 1e-4,
                         "p": p, "trace": tid, "labels": {"req": req, "tokens": n_tok}})
            recs.append({"t": t, "kind": "span", "name": "serve.request", "dur": td - t,
                         "p": p, "trace": tid,
                         "labels": {"req": req, "reason": "length", "tokens": n_tok}})
            recs.append({"t": td, "kind": "counter", "name": "serve.tokens",
                         "value": n_tok, "p": p})
            recs.append({"t": td, "kind": "gauge", "name": "serve.slot_occupancy",
                         "value": float(rng.uniform()), "p": p})
        if seed % 2:  # an admitted request that never finished: an orphan
            recs.append({"t": t + 0.5, "kind": "gauge", "name": "serve.queue_depth",
                         "value": 1.0, "p": p, "trace": f"orphan{p}"})
        _write(os.path.join(directory, f"events-p{p}.jsonl"), *recs, mode="w")


SPEC = "serve.ttft:p99 < 5ms over 2s; serve.tokens:rate < 50 over 2s; serve.slot_occupancy:last <= 0.9"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plane_snapshots_burns_and_points_equal_jax(tmp_path, seed):
    _served_stream(str(tmp_path), seed)
    emitted = {"jax": [], "port": []}
    planes = {}
    for name, mod_rollup, mod_slo in (("jax", jax_rollup, jax_slo),
                                      ("port", port_rollup, port_slo)):
        eng = mod_slo.SloEngine(mod_slo.parse_slo_spec(SPEC),
                                emit=lambda n, _k=name, **kw: emitted[_k].append((n, kw)))
        planes[name] = mod_rollup.LivePlane(
            str(tmp_path), window_s=2.0, slice_s=0.25, slo_engine=eng,
            snapshot_path=str(tmp_path / f"rollup-{name}.json"))
    for now in (5001.5, 5002.0, 5003.0, 5009.0):
        snaps = {k: p.poll(now=now) for k, p in planes.items()}
        assert snaps["port"] == snaps["jax"]
        assert read_snapshot(str(tmp_path / "rollup-port.json")) == json.loads(
            json.dumps(snaps["jax"], default=str))
    assert emitted["port"] == emitted["jax"]
    assert any(n == "slo_breach" for n, _ in emitted["port"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traces_and_report_sections_equal_jax(tmp_path, seed):
    _served_stream(str(tmp_path), seed)
    loaded = report.load([str(tmp_path)])
    assert loaded == jax_report.load([str(tmp_path)])
    got, want = traces.reconstruct(loaded), jax_traces.reconstruct(loaded)
    assert got == want
    assert got["count"] == 24 and got["orphan_count"] == seed % 2 * 2
    assert traces.phase_p50s(got["requests"]) == jax_traces.phase_p50s(want["requests"])
    assert traces.top_slow(got["requests"], k=3) == jax_traces.top_slow(want["requests"], k=3)
    summary = report.summarize(loaded)
    assert summary["traces"] == jax_report.summarize(loaded)["traces"]
    assert summary["traces"]["requests"] == 24
    assert "traces (request critical paths" in report.render(summary)


def test_training_attribution_equals_jax():
    rng = np.random.RandomState(4)
    events, t = [], 10.0
    for step in range(6):
        wait = float(rng.uniform(0.001, 0.01))
        events.append({"t": t, "wall": t, "kind": "span", "name": "data.wait", "dur": wait})
        dur = float(rng.uniform(0.05, 0.1))
        events.append({"t": t + wait, "wall": t + wait, "kind": "span", "name": "step",
                       "dur": dur, "labels": {"step": step}})
        t += wait + dur + float(rng.uniform(0, 0.005))
    assert traces.training_attribution(events) == jax_traces.training_attribution(events)


# -- rollup ---------------------------------------------------------------

def test_rollup_quantiles_within_bound_of_exact_percentiles():
    rng = np.random.RandomState(7)
    durs = rng.lognormal(mean=-5.0, sigma=1.2, size=4000)
    agg = WindowedAggregator(60.0, slice_s=1.0)
    for i, d in enumerate(durs):
        agg.add({"kind": "span", "name": "s", "dur": float(d), "wall": 1000.0 + (i % 50)})
    bound = HIST_GROWTH ** 0.5 * 1.01
    for q in (0.50, 0.95, 0.99):
        exact = float(np.percentile(durs, q * 100))
        est = agg.span_quantile("s", q)
        assert 1.0 / bound <= est / exact <= bound, (q, est, exact)


def test_rollup_windows_expire_and_memory_stays_bounded():
    agg = WindowedAggregator(10.0, slice_s=1.0)
    for sec in range(10_000):
        agg.add({"kind": "counter", "name": "c", "value": 2, "wall": float(sec)})
        agg.add({"kind": "span", "name": "s", "dur": 0.01, "wall": float(sec)})
    assert len(agg._slices) <= int(agg.retain_s / agg.slice_s) + 2
    assert agg.counter_sum("c") == pytest.approx(20.0)
    assert agg.counter_rate("c") == pytest.approx(2.0)
    assert agg.counter_sum("c", window_s=3.0) == pytest.approx(6.0)
    assert sum(agg.span_hist("s").values()) == 10


def test_rollup_gauges_last_value_wins_with_age():
    agg = WindowedAggregator(60.0)
    agg.add({"kind": "gauge", "name": "g", "value": 1.0, "wall": 100.0})
    agg.add({"kind": "gauge", "name": "g", "value": 2.5, "wall": 120.0})
    assert agg.gauge_last("g") == 2.5
    assert agg.snapshot(now=130.0)["gauges"]["g"] == {"value": 2.5, "age_s": 10.0}


def test_snapshot_atomic_write_and_torn_read(tmp_path):
    path = str(tmp_path / "rollup.json")
    write_snapshot(path, {"schema": 1, "counters": {"c": {"sum": 1.0}}})
    assert read_snapshot(path)["counters"]["c"]["sum"] == 1.0
    assert os.listdir(tmp_path) == ["rollup.json"]  # no temp litter
    with open(path, "w") as fh:
        fh.write('{"torn": ')
    assert read_snapshot(path) is None
    assert read_snapshot(str(tmp_path / "absent.json")) is None


# -- SLO grammar and burn rates -----------------------------------------------

def test_slo_grammar_docstring_examples_equal_jax():
    text = ("serve.ttft:p99 < 250ms over 60s; epoch.loss finite\n"
            "serve.rejected:rate < 1% over 30s  # comment\n"
            "queue.depth:last <= 32")
    o0, o1, o2, o3 = objs = parse_slo_spec(text)
    assert (o0.metric, o0.stat, o0.op) == ("serve.ttft", "p99", "<")
    assert o0.threshold == pytest.approx(0.25)
    assert o0.window_s == 60.0
    assert (o1.metric, o1.stat) == ("epoch.loss", "finite")
    assert (o2.stat, o2.threshold, o2.window_s) == ("rate", 0.01, 30.0)
    assert (o3.stat, o3.op, o3.threshold) == ("last", "<=", 32.0)
    ref = jax_slo.parse_slo_spec(text)
    assert [vars(o) for o in objs] == [vars(o) for o in ref]


@pytest.mark.parametrize("bad", [
    "serve.ttft:p42 < 1ms",
    "serve.ttft < ",
    "serve.ttft:p99 < -3ms",
    "serve.ttft:p99 < 1ms over 0s",
    "epoch.loss:p50 finite",
    "what even is this",
])
def test_slo_grammar_rejects_junk(bad):
    with pytest.raises(ValueError):
        parse_slo_spec(bad)
    with pytest.raises(ValueError):
        jax_slo.parse_slo_spec(bad)


def test_slo_from_env_inline_and_file(tmp_path):
    assert SloEngine.from_env(env={}) is None
    eng = SloEngine.from_env(env={"SLO_SPEC": "a.b:rate < 5 over 10s"})
    assert eng.objectives[0].metric == "a.b"
    assert eng.retain_s() == pytest.approx(50.0)
    spec = tmp_path / "slo.spec"
    spec.write_text("# fleet SLOs\nserve.ttft:p99 < 250ms over 20s\n")
    assert SloEngine.from_env(env={"SLO_SPEC": str(spec)}).objectives[0].window_s == 20.0


def _span_burst(agg, name, dur, t0, n=20, spacing=0.1):
    for i in range(n):
        agg.add({"kind": "span", "name": name, "dur": dur, "wall": t0 + i * spacing})


def test_slo_multiwindow_burn_breach_and_fast_recovery():
    emitted = []
    eng = SloEngine(parse_slo_spec("s:p99 < 10ms over 10s"), long_factor=5.0,
                    emit=lambda name, **kw: emitted.append((name, kw)))
    agg = WindowedAggregator(10.0, slice_s=1.0, retain_s=eng.retain_s())
    _span_burst(agg, "s", 0.002, t0=1000.0, n=300, spacing=0.1)
    _span_burst(agg, "s", 0.100, t0=1031.0, n=3, spacing=0.1)
    st = eng.evaluate(agg, now=1032.0)[0]
    assert st["burn"] > 1.0 and not st["burning"]  # the long window vetoes
    assert emitted == []
    _span_burst(agg, "s", 0.100, t0=1032.0, n=100, spacing=0.1)
    st = eng.evaluate(agg, now=1042.0)[0]
    assert st["burning"] and st["burn_long"] > 1.0
    assert [e[0] for e in emitted] == ["slo_breach"]
    st = eng.evaluate(agg, now=1060.0)[0]
    assert not st["burning"]
    assert [e[0] for e in emitted] == ["slo_breach", "slo_recover"]
    assert st["worst_burn"] > 1.0 and st["breaches"] == 1


def test_slo_finite_objective_and_rate():
    emitted = []
    eng = SloEngine(parse_slo_spec("epoch.loss finite; err:rate < 1% over 10s"),
                    emit=lambda name, **kw: emitted.append((name, kw)))
    agg = WindowedAggregator(10.0, slice_s=1.0, retain_s=eng.retain_s())
    agg.add({"kind": "gauge", "name": "epoch.loss", "value": 1.25, "wall": 1000.0})
    sts = eng.evaluate(agg, now=1000.0)
    assert not sts[0]["burning"] and sts[0]["burn"] == 0.0
    agg.add({"kind": "gauge", "name": "epoch.loss", "value": float("nan"), "wall": 1001.0})
    sts = eng.evaluate(agg, now=1001.0)
    assert sts[0]["burning"] and sts[0]["burn"] == BURN_MAX
    assert emitted[0][0] == "slo_breach"
    agg.add({"kind": "counter", "name": "err", "value": 2, "wall": 1002.0})
    assert eng.evaluate(agg, now=1002.0)[1]["burn"] == pytest.approx(20.0)


def test_slo_points_land_on_the_port_bus(tmp_path):
    bus = obs.configure(str(tmp_path), run_id="r-slo")
    eng = SloEngine(parse_slo_spec("s:p99 < 1ms over 5s"))
    agg = WindowedAggregator(5.0, slice_s=0.5, retain_s=eng.retain_s())
    _span_burst(agg, "s", 0.5, t0=100.0, n=30, spacing=0.1)
    eng.evaluate(agg, now=103.0)
    bus.flush()
    events = [json.loads(ln) for ln in open(bus.path)][1:]
    breach = [e for e in events if e["name"] == "slo_breach"]
    assert breach and breach[0]["labels"]["objective"] == "s:p99 < 1ms over 5s"


def test_live_plane_end_to_end_over_port_bus_files(tmp_path):
    bus = obs.configure(str(tmp_path), run_id="r-plane")
    plane = LivePlane(str(tmp_path), window_s=5.0, slice_s=0.5,
                      slo_engine=SloEngine(parse_slo_spec("serve.ttft:p99 < 1ms over 5s")))
    t0 = time.monotonic()
    for i in range(10):
        bus.span_event("serve.ttft", 0.05, t=t0 + i * 0.01)
        bus.counter("serve.tokens", 3)
    bus.gauge("serve.slot_occupancy", 0.75)
    bus.flush()
    snap = plane.poll()
    assert snap["spans"]["serve.ttft"]["count"] == 10
    assert snap["counters"]["serve.tokens"]["sum"] == 30.0
    assert snap["gauges"]["serve.slot_occupancy"]["value"] == 0.75
    assert snap["slo"][0]["burning"]
    disk = read_snapshot(os.path.join(str(tmp_path), "rollup.json"))
    assert disk["slo"][0]["burning"] is True


def test_report_summarize_builds_slo_timeline(tmp_path):
    bus = EventBus(directory=str(tmp_path), proc=0, run_id="r-rep")
    bus.point("slo_breach", objective="o1", burn=3.2, value=0.8)
    bus.point("slo_recover", objective="o1", burn=0.4, value=0.1)
    bus.point("slo_breach", objective="o2", burn=1.5, value=9)
    bus.close()
    summary = report.summarize(report.load([str(tmp_path)]))
    o1 = summary["slo"]["o1"]
    assert o1["breaches"] == 1 and o1["recovers"] == 1
    assert o1["worst_burn"] == pytest.approx(3.2)
    assert [e["event"] for e in o1["timeline"]] == ["breach", "recover"]
    text = report.render(summary)
    assert "STILL BREACHED" in text and "worst burn 3.20x" in text


# -- admission feedback ---------------------------------------------------------

def _fake_server(prefills=4, depth=64):
    return types.SimpleNamespace(prefills_per_step=prefills, queue_depth=depth,
                                 queue_limit=depth)


def _slo_status(burning, stat="p99", metric="serve.ttft"):
    return {"objective": f"{metric}:{stat} < 250ms over 60s", "metric": metric,
            "stat": stat, "burning": burning, "burn": 2.0 if burning else 0.5}


def test_adaptive_policy_sequence_equals_jax(tmp_path):
    """The same snapshots, fed to both policies: the same knob values
    after every tick, and the same derate/restore points and gauges."""
    rng = np.random.RandomState(3)
    snaps = [None] + [{"slo": [_slo_status(bool(b), stat=s)]}
                      for b, s in zip(rng.rand(40) < 0.5,
                                      rng.choice(["p99", "p50", "rate", "last"], 40))]
    trail = {}
    for name, policy_cls, bus_mod in (("port", AdaptiveAdmissionPolicy, obs),
                                      ("jax", jax_scheduler.AdaptiveAdmissionPolicy,
                                       jax_obs)):
        bus = bus_mod.configure(str(tmp_path / name), run_id=f"r-{name}")
        it = iter(snaps)
        pol = policy_cls(reader=lambda: next(it), refresh_s=0.0, derate_prefills=1,
                         derate_queue_frac=0.5)
        srv = _fake_server(prefills=4, depth=64)
        knobs = []
        for i in range(len(snaps)):
            pol.tick(srv, now=float(i))
            knobs.append((srv.prefills_per_step, srv.queue_limit, pol.derated))
        bus.flush()
        events = [json.loads(ln) for ln in open(bus.path)][1:]
        trail[name] = (knobs, [(e["name"], e.get("value"), e.get("labels"))
                               for e in events])
    assert trail["port"] == trail["jax"]
    assert any(d for _, _, d in trail["port"][0])
    assert ("serve.admission_prefills", 1.0, None) in trail["port"][1]


def test_adaptive_policy_ignores_non_latency_objectives():
    pol = AdaptiveAdmissionPolicy(reader=lambda: {"slo": [_slo_status(True, stat="rate")]},
                                  refresh_s=0.0)
    srv = _fake_server()
    pol.tick(srv, now=1.0)
    assert not pol.derated
    pol2 = AdaptiveAdmissionPolicy(
        reader=lambda: {"slo": [_slo_status(True, metric="train.step")]},
        refresh_s=0.0, watch_prefix="serve.")
    pol2.tick(srv, now=1.0)
    assert not pol2.derated
    assert scheduler.burning_latency_objectives(
        {"slo": [_slo_status(True), _slo_status(True, stat="last")]}) == [
        "serve.ttft:p99 < 250ms over 60s"]


def test_serve_config_admission_policy_env(tmp_path, monkeypatch):
    assert ServeConfig.from_env(env={}).build_admission_policy() is None
    cfg = ServeConfig.from_env(env={"SERVE_ADMISSION_POLICY": "adaptive",
                                    "SERVE_ROLLUP_PATH": str(tmp_path / "ro.json")})
    pol = cfg.build_admission_policy()
    assert isinstance(pol, AdaptiveAdmissionPolicy)
    assert pol.snapshot_path == str(tmp_path / "ro.json")
    monkeypatch.setenv("OBS_DIR", str(tmp_path))
    cfg = ServeConfig.from_env(env={"SERVE_ADMISSION_POLICY": "adaptive"})
    assert cfg.build_admission_policy().snapshot_path == os.path.join(
        str(tmp_path), "rollup.json")
    with pytest.raises(ValueError):
        ServeConfig.from_env(env={"SERVE_ADMISSION_POLICY": "wat"}).build_admission_policy()


def test_server_build_takes_the_policy_and_queue_limit():
    from distributeddeeplearning_tpu_torch.models import convert
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.serving import QueueFull, Request, Server

    params = convert.init_params("tiny", 64, torch.Generator().manual_seed(0), 16)
    model = TransformerLM("tiny", vocab_size=64, max_seq_len=16, dtype=torch.float32,
                          device="cpu")
    cfg = ServeConfig.from_env(env={"SERVE_ADMISSION_POLICY": "adaptive",
                                    "SERVE_QUEUE_DEPTH": "4", "SERVE_BUCKETS": "4",
                                    "SERVE_SLOTS": "2"})
    server = Server.build(model, params, cfg, device="cpu", max_len=16)
    assert isinstance(server.policy, AdaptiveAdmissionPolicy)
    assert server.queue_limit == server.queue_depth == 4
    server.queue_limit = 2  # what a derate does
    prompt = np.arange(3, dtype=np.int32)
    for _ in range(2):
        server.submit(Request(prompt=prompt, max_new_tokens=2))
    with pytest.raises(QueueFull, match=r"capacity \(2\)"):
        server.submit(Request(prompt=prompt, max_new_tokens=2))
    assert server.stats["rejected"] == 1


def test_server_sheds_then_recovers_under_injected_slo_breach(tmp_path):
    """A port Server on the CPU under the live plane and an SLO that
    always breaches (ttft p99 < 0.01ms over 2s; the JAX test's window is
    1 s, which a contended CPU's first ticks can outlast): the merged
    stream shows
    slo_breach -> serve.admission_derate (gauge lowered) -> slo_recover
    -> serve.admission_restore (gauge restored); every request still
    finishes, and the report renders the SLO timeline and the traces."""
    from distributeddeeplearning_tpu_torch.models import convert
    from distributeddeeplearning_tpu_torch.models.transformer_lm import TransformerLM
    from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine

    vocab, max_len = 64, 16
    params = convert.init_params("tiny", vocab, torch.Generator().manual_seed(0), max_len)
    model = TransformerLM("tiny", vocab_size=vocab, max_seq_len=max_len,
                          dtype=torch.float32, device="cpu")
    engine = SlotEngine(model, params, num_slots=2, max_len=max_len, buckets=(4,),
                        device="cpu")
    engine.warmup()
    rng = np.random.RandomState(0)
    # A warm request before the plane starts: the CPU's first calls of
    # each op are slow, and the TTFT spans (stamped at submission) of a
    # first tick slower than the SLO window would miss it. (The JAX
    # engine pays that cost when it compiles at warmup.)
    warm = Server(engine)
    warm.submit(Request(prompt=np.arange(3, dtype=np.int32), max_new_tokens=6))
    warm.drain()
    bus = obs.configure(str(tmp_path), run_id="r-e2e")
    slo = SloEngine(parse_slo_spec("serve.ttft:p99 < 0.01ms over 2s"))
    plane = LivePlane(str(tmp_path), window_s=2.0, slice_s=0.25, slo_engine=slo)
    policy = AdaptiveAdmissionPolicy(snapshot_path=plane.snapshot_path, refresh_s=0.0,
                                     derate_prefills=1, derate_queue_frac=0.5)
    server = Server(engine, queue_depth=8, prefills_per_step=2, admission_policy=policy)
    # One arrival a tick, so each TTFT span (stamped at its submission)
    # is fresh when the plane next polls, however slow a loaded CPU's
    # ticks are; the plane polls in lockstep with the scheduler.
    prompts = [rng.randint(0, vocab, size=(3,)).astype(np.int32) for _ in range(6)]
    busy, derated = True, []
    while busy or prompts:
        if prompts:
            server.submit(Request(prompt=prompts.pop(0), max_new_tokens=6))
        busy = server.step()
        bus.flush()
        plane.poll(now=time.time())
        if policy.derated:
            derated.append((server.prefills_per_step, server.queue_limit))
    assert derated and set(derated) == {(1, 4)}  # the breach arrived with work in flight
    deadline = time.time() + 15.0
    while slo.any_burning and time.time() < deadline:
        time.sleep(0.15)
        bus.flush()
        plane.poll(now=time.time())
    assert not slo.any_burning
    server.step()  # the policy's tick on the recovered rollup
    assert not policy.derated
    assert server.prefills_per_step == 2 and server.queue_limit == 8
    bus.flush()
    merged = report.merge_run_dir(str(tmp_path))
    events = [json.loads(ln) for ln in open(merged)]
    seq = [e["name"] for e in events if e.get("kind") != "meta" and e["name"] in (
        "slo_breach", "serve.admission_derate", "slo_recover", "serve.admission_restore")]
    assert seq == ["slo_breach", "serve.admission_derate", "slo_recover",
                   "serve.admission_restore"]
    gauges = [(e["name"], e["value"]) for e in events if e.get("kind") == "gauge"
              and e["name"] == "serve.admission_prefills"]
    assert gauges == [("serve.admission_prefills", 1.0), ("serve.admission_prefills", 2.0)]
    assert server.stats["completed"] == 6
    recon = traces.reconstruct(events)
    # Every request's critical path, no orphan. (Whether each gap is
    # inside the 0.5 s floor depends on the CPU's load here: the smoke's
    # servegraph phase checks it on the card.)
    assert recon["count"] == 6 and recon["orphan_count"] == 0
    summary = report.summarize(report.load([str(tmp_path)]))
    slo_sec = summary["slo"]["serve.ttft:p99 < 0.01ms over 2s"]
    assert slo_sec["breaches"] == 1 and slo_sec["recovers"] == 1
    text = report.render(summary)
    assert "SLO (breach/recover timeline" in text
    assert "traces (request critical paths" in text
