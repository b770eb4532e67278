"""The port's training loop (``training/loop.fit``): its sync-free
contract and its non-finite guard, on a ResNet-18 (16 px, 8 classes, f32,
2 images a step, 4 steps an epoch):

* exactly one host materialisation an epoch under ``hostsync.track()``
  (every ``Tensor.item``/``.cpu``/``.tolist``/``.numpy``/``float``/
  ``int``/``bool`` counted), and ``perf["host_sync_count"]`` says so;
* the epoch means in the history equal, bit for bit, a host f32 running
  mean of the per-step metrics a loop that reads every step sees (and the
  accumulator alone, on long-mantissa values, with its non-finite count);
* ``FAULT_PLAN=nan:step=N`` with ``NONFINITE_ACTION=abort`` raises
  ``NonFiniteLossError`` (exit 121) at the epoch boundary; ``warn`` and
  ``off`` run on; the fault plan parses as JAX's.
"""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_dataset
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    loop,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.training.metrics import (
    METRIC_KEYS,
    accumulate_metrics,
    accumulator_logs,
    finalize_accumulator,
    init_accumulator,
)
from distributeddeeplearning_tpu_torch.utils import hostsync


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(**kw):
    base = dict(model="resnet18", num_classes=8, image_size=16, batch_size_per_device=2,
                fake_data_length=8, epochs=3, compute_dtype="float32", log_every_steps=0)
    base.update(kw)
    cfg = TrainConfig(**base)
    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      device="cpu")
    data = make_dataset(cfg)
    tx, _ = create_optimizer(cfg, data.steps_per_epoch)
    return cfg, model, data, tx, create_train_state(model, cfg, tx, device="cpu")


def test_loop_performs_at_most_one_sync_per_epoch():
    cfg, model, data, tx, state = _tiny()
    hostsync.accountant().reset()
    with hostsync.track():
        res = loop.fit(model, cfg, data, device="cpu", tx=tx, state=state,
                       add_default_logger=False)
    acct = hostsync.accountant()
    assert acct.count == cfg.epochs, acct.by_label
    assert acct.by_label == {"epoch_metrics": cfg.epochs}
    assert res.perf["host_sync_count"] == cfg.epochs
    assert res.history[0]["epoch_images"] == cfg.fake_data_length // 2 * 2
    assert res.perf["steps"] == cfg.epochs * data.steps_per_epoch


def test_epoch_means_match_host_running_mean_bitwise():
    cfg, model, data, tx, state = _tiny(epochs=2)
    res = loop.fit(model, cfg, data, device="cpu", tx=tx, state=state,
                   add_default_logger=False)

    cfg, model, data, tx, state = _tiny(epochs=2)
    step = make_train_step(model, tx, cfg, device="cpu")
    for epoch in range(cfg.epochs):
        sums = {k: np.float32(0.0) for k in METRIC_KEYS}
        steps = 0
        for batch in data.epoch(epoch):
            state, m = step(state, batch)
            for k in sums:
                sums[k] = np.float32(sums[k] + np.float32(float(m[k])))
            steps += 1
        for k in sums:
            want = np.float32(sums[k] / np.float32(steps))
            got = np.float32(res.history[epoch][k])
            assert got.tobytes() == want.tobytes(), (epoch, k, got, want)

    # the accumulator alone, on values with long mantissas, and its
    # non-finite count
    rng = np.random.RandomState(0)
    vals = rng.randn(37, 3).astype(np.float32) * 1e3
    vals[5, 0] = np.nan
    vals[9, 0] = np.inf
    acc = init_accumulator("cpu")
    sums = np.zeros(3, np.float32)
    for row in vals:
        acc = accumulate_metrics(acc, dict(zip(METRIC_KEYS, map(torch.tensor, row))))
        sums = (sums + row).astype(np.float32)
    logs = accumulator_logs(finalize_accumulator(acc))
    assert logs["nonfinite_steps"] == 2
    want = sums / np.float32(len(vals))
    np.testing.assert_array_equal(np.float32([logs[k] for k in METRIC_KEYS])[1:], want[1:])


@pytest.mark.parametrize("action", ["abort", "warn", "off"])
def test_nonfinite_guard(action, monkeypatch):
    monkeypatch.setenv("FAULT_PLAN", "nan:step=3")
    cfg, model, data, tx, state = _tiny(epochs=2, nonfinite_action=action)
    if action == "abort":
        with pytest.raises(faults.NonFiniteLossError) as e:
            loop.fit(model, cfg, data, device="cpu", tx=tx, state=state,
                     add_default_logger=False)
        assert e.value.code == faults.EXIT_NONFINITE == 121
        assert e.value.epoch == 0 and e.value.nonfinite_steps >= 1
        return
    res = loop.fit(model, cfg, data, device="cpu", tx=tx, state=state,
                   add_default_logger=False)
    assert len(res.history) == 2 and not np.isfinite(res.history[0]["loss"])


def test_fault_plan_parses_like_jax(tmp_path):
    from distributeddeeplearning_tpu import faults as jax_faults

    text = "kill:step=3,rank=1; nan:step=2;hang:step=5,secs=2.5;exit:step=7,code=4"
    assert faults.parse_fault_plan(text) == [
        faults.Fault(**vars(f)) for f in jax_faults.parse_fault_plan(text)]
    for bad in ("boom:step=1", "kill", "kill:step=0", "nan:step=1,ranks=2", "kill:step"):
        with pytest.raises(ValueError):
            jax_faults.parse_fault_plan(bad)
        with pytest.raises(ValueError):
            faults.parse_fault_plan(bad)
    # The elasticity verbs execute since the process tier (they raised
    # before): a surviving rank's shrink writes the capacity file.
    cap = str(tmp_path / "capacity.json")
    inj = faults.FaultInjector(faults.parse_fault_plan("shrink:step=3"), rank=0, world=2,
                               capacity_file=cap)
    assert inj.due_after(3)
    inj.fire_after(3)
    assert faults.probe_capacity(cap, 2) == 1
    inj = faults.FaultInjector.from_env({"FAULT_PLAN": "nan:step=2,rank=1", "RANK": "1"})
    batch = (torch.ones(2, 3), torch.arange(2))
    assert inj.poison(1, batch) is batch
    poisoned = inj.poison(2, batch)
    assert torch.isnan(poisoned[0]).all() and torch.equal(poisoned[1], batch[1])
    assert faults.FaultInjector.from_env({"FAULT_PLAN": "nan:step=2,rank=1"}) is None
