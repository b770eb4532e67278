"""The port's triggered profiler capture (``obs/trace.py``) against the
JAX package's: ``from_env`` decides as JAX's for the same envs (on or
off, ``every_n``, the directory); a controller starts every n-th epoch,
on request and on SIGUSR1, never nests, and writes
``trace-epochNNNN/rank0.pt.trace.json`` at each stop; a CPU ``fit`` with
``TRACE_EVERY_N_EPOCHS=1`` writes one trace an epoch and puts
``trace_start``/``trace_stop`` on the bus, as JAX's ``fit`` does (its
profiler faked, as ``tests/test_obs.py`` fakes it)."""

import json
import os
import signal
import types

import pytest
import torch

from distributeddeeplearning_tpu_torch import obs
from distributeddeeplearning_tpu_torch.obs import trace as obs_trace


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _keep_sigusr1():
    old = signal.getsignal(signal.SIGUSR1)
    yield
    signal.signal(signal.SIGUSR1, old)


ENVS = [{}, {"TRACE_EVERY_N_EPOCHS": "0"}, {"TRACE_EVERY_N_EPOCHS": "3"},
        {"TRACE_ON_SIGNAL": "1"}, {"TRACE_ON_SIGNAL": "off"},
        {"TRACE_ON_SIGNAL": "yes", "TRACE_DIR": "/tmp/elsewhere"},
        {"TRACE_EVERY_N_EPOCHS": "2", "TRACE_DIR": "/tmp/t"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items())
                         or "empty")
def test_from_env_decides_like_jax(env, tmp_path):
    from distributeddeeplearning_tpu import obs as jax_obs
    from distributeddeeplearning_tpu.obs import trace as jax_trace

    jax_obs.configure(str(tmp_path))
    obs.configure(str(tmp_path))
    try:
        mine, ref = obs_trace.from_env(env=env), jax_trace.from_env(env=env)
        assert (mine is None) == (ref is None)
        if ref is not None:
            assert (mine.every_n, mine.directory) == (ref.every_n, ref.directory)
    finally:
        jax_obs.reset()
        obs.reset()


def _files(ctrl):
    return sorted(os.listdir(ctrl.directory))


def test_every_n_request_and_nesting(tmp_path):
    ctrl = obs_trace.TraceController(str(tmp_path), every_n=2)
    ctrl.cuda = False
    assert ctrl.maybe_start(0) and ctrl.active
    assert not ctrl.maybe_start(0)  # never nested
    torch.ones(4).sum()
    assert ctrl.maybe_stop(0) and not ctrl.active
    assert not ctrl.maybe_start(1)  # 1 % 2 != 0
    ctrl.request()
    assert ctrl.maybe_start(1)
    assert ctrl.maybe_stop(1)
    assert not ctrl.maybe_stop(1)  # stop is idempotent
    assert _files(ctrl) == ["trace-epoch0000", "trace-epoch0001"]
    path = tmp_path / "trace-epoch0000" / "rank0.pt.trace.json"
    assert "traceEvents" in json.loads(path.read_text())


def test_sigusr1_requests_the_next_epoch(tmp_path):
    ctrl = obs_trace.TraceController(str(tmp_path))
    ctrl.cuda = False
    assert ctrl.install_signal()
    assert not ctrl.maybe_start(4)
    os.kill(os.getpid(), signal.SIGUSR1)
    assert ctrl.maybe_start(5)
    assert ctrl.maybe_stop(5)
    assert _files(ctrl) == ["trace-epoch0005"]


def test_fit_traces_each_epoch_like_jax(tmp_path, monkeypatch):
    import jax

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.synthetic import SyntheticTokenDataset as JaxTokens
    from distributeddeeplearning_tpu.models import get_model as jax_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import loop as jax_loop
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import loop

    calls = []
    monkeypatch.setattr(jax, "profiler", types.SimpleNamespace(
        start_trace=lambda d: calls.append(("start", d)),
        stop_trace=lambda: calls.append(("stop",))))
    monkeypatch.setenv("TRACE_EVERY_N_EPOCHS", "1")
    monkeypatch.setenv("TRACE_DIR", str(tmp_path / "traces"))
    kw = dict(model="lm_tiny", num_classes=64, batch_size_per_device=2, fake_data_length=4,
              epochs=2, compute_dtype="float32", weight_decay=0.0, log_every_steps=0)
    data = dict(length=4, global_batch_size=2, seq_len=16, vocab_size=64)
    jax_loop.fit(jax_model("lm_tiny", num_classes=64, dtype="float32", max_seq_len=16),
                 JaxConfig(**kw), JaxTokens(**data),
                 mesh=create_mesh(devices=jax.devices()[:1]), add_default_logger=False)
    obs.reset()
    res = loop.fit(get_model("lm_tiny", num_classes=64, dtype="float32", max_seq_len=16,
                             device="cpu"),
                   TrainConfig(**kw), SyntheticTokenDataset(**data), device="cpu",
                   add_default_logger=False)
    points = [(r["name"], r["labels"]["epoch"]) for r in obs.get_bus().ring
              if r["kind"] == "point" and r["name"].startswith("trace_")]
    assert points == [("trace_start", 0), ("trace_stop", 0), ("trace_start", 1),
                      ("trace_stop", 1)]
    assert [c[0] for c in calls] == ["start", "stop", "start", "stop"]
    assert [os.path.basename(c[1]) for c in calls if c[0] == "start"] == sorted(
        os.listdir(tmp_path / "traces"))
    trace = json.loads((tmp_path / "traces" / "trace-epoch0001" / "rank0.pt.trace.json")
                       .read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    # no CUDA activity on the CPU: no device drain, the epochs' one sync each
    assert res.perf["host_sync_count"] == 2
