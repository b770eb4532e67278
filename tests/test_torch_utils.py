"""The port's host-side utilities against the JAX package's tests of
them: twins of ``tests/test_timer.py`` (``utils/timer.py``, a copy) and
``tests/test_hostsync.py`` (``utils/hostsync.py``: the accountant, its
bus counter, ``track()`` patching the torch materialisers and
``StepClock``), and the heartbeat copy."""

import io
import time

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.utils import heartbeat, hostsync
from distributeddeeplearning_tpu_torch.utils.timer import Timer, timer


def test_timer_context_manager():
    with Timer() as t:
        time.sleep(0.01)
    assert 0.005 < t.elapsed < 1.0


def test_timer_output_sink():
    out = []
    with Timer(output=out.append, fmt="{:.1f}"):
        pass
    assert len(out) == 1


def test_timer_accumulates():
    t = Timer()
    t.start()
    t.stop()
    first = t.elapsed
    t.start()
    time.sleep(0.01)
    t.stop()
    assert t.elapsed > first


def test_timer_reset():
    t = Timer()
    t.start()
    t.stop()
    t.reset()
    assert t.elapsed == 0.0


def test_timer_decorator():
    out = []

    @timer(output=out.append)
    def add(a, b):
        return a + b

    assert add(2, 3) == 5
    assert len(out) == 1 and "add" in out[0]


def test_accountant_counts_and_labels():
    acct = hostsync.accountant()
    acct.reset()
    bus = obs.get_bus()
    x = torch.arange(4.0)
    y = hostsync.device_get(x, label="alpha")
    hostsync.device_get(x, label="alpha")
    hostsync.device_get({"a": x, "b": x}, label="beta")  # one tree = one sync
    np.testing.assert_array_equal(y.numpy(), np.arange(4.0))
    assert acct.count == 3
    assert acct.by_label == {"alpha": 2, "beta": 1}
    labels = [(e.get("labels") or {}).get("label") for e in list(bus.ring)
              if e.get("kind") == "counter" and e.get("name") == "host_sync"][-3:]
    assert labels == ["alpha", "alpha", "beta"]
    acct.reset()
    assert acct.count == 0 and acct.by_label == {}


def test_track_counts_every_materialisation():
    acct = hostsync.accountant()
    acct.reset()
    x = torch.arange(4.0)
    with hostsync.track() as tracked:
        x.sum().item()
        float(x[0])
        bool(x[1] > 0)
        x.tolist()
        host = hostsync.device_get({"a": x, "b": [x, 3]}, label="wrapped")
        host["a"].tolist()  # a booked host copy: not counted again
    assert tracked is acct
    assert acct.by_label == {"tensor.item": 1, "tensor.__float__": 1, "tensor.__bool__": 1,
                             "tensor.tolist": 1, "wrapped": 1}
    assert host["b"][1] == 3 and torch.equal(host["b"][0], x)
    x.add_(1)  # the host copy is a copy
    assert host["a"].tolist() == [0.0, 1.0, 2.0, 3.0]
    before = acct.count
    x.tolist()  # patches removed on exit
    assert acct.count == before


def test_step_clock_percentiles_and_wait():
    clock = hostsync.StepClock()
    for ms in (1, 2, 3, 4, 100):
        clock.note_dispatch(ms / 1e3)
    with clock.waiting():
        pass
    s = clock.summary()
    assert s["steps"] == 5
    assert s["dispatch_p50_ms"] == 3.0
    assert s["dispatch_p99_ms"] == 100.0
    assert s["wait_total_s"] >= 0.0
    assert abs(s["dispatch_total_s"] - 0.110) < 1e-9


def test_step_clock_empty_summary():
    s = hostsync.StepClock().summary()
    assert s["steps"] == 0 and s["dispatch_p99_ms"] == 0.0


def test_heartbeat_beats_only_inside_during():
    sink = io.StringIO()
    with heartbeat.during("first_step_compile", interval_s=0.01, sink=sink):
        time.sleep(0.08)
    beats = sink.getvalue().splitlines()
    assert beats and all(b == f"{heartbeat.MAGIC} first_step_compile" for b in beats)
    n = len(beats)
    time.sleep(0.05)
    assert len(sink.getvalue().splitlines()) == n
    assert heartbeat.interval({}) == 0.0 and heartbeat.interval({heartbeat.ENV_VAR: "3"}) == 3.0
