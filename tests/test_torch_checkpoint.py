"""Checkpoint / resume of the port (``training/checkpoint.py``), twins of
``tests/test_checkpoint.py:22,54,64,75,185`` and
``tests/test_fault_tolerance.py:49,75,92,173``:

* the manifest equals JAX's ``build_manifest`` for the same arguments;
* save/restore round trip of a trained state (parameters, BatchNorm
  buffers, momentum, schedule count, step) and the restored state
  driving the step; epoch keying every n epochs; a disabled manager;
  ``max_to_keep``; a checkpoint of an ``ACCUM_STEPS=1`` run driving an
  ``ACCUM_STEPS=2`` step;
* step-granular keys and their ``(epoch, step_in_epoch)`` decode, the
  epoch mode skipless, a truncated newest checkpoint falling back to the
  previous one and an all-corrupt directory to a cold start;
* an async save keeps the values of the moment it was called.

``tests/test_torch_checkpoint_resume.py`` holds the resumes through
``fit``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.training.checkpoint import (
    CheckpointManager,
    build_manifest,
)

CFG = TrainConfig(model="resnet18", num_classes=10, image_size=16, compute_dtype="float32",
                  batch_size_per_device=4)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _state(cfg=CFG):
    model = get_model("resnet18", num_classes=10, dtype="float32", device="cpu")
    tx, _ = create_optimizer(cfg, 10)
    return model, tx, create_train_state(model, cfg, tx, device="cpu")


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randn(4, 16, 16, 3).astype(np.float32), rng.randint(0, 10, 4).astype(np.int32))


def _flat(state):
    out = {f"model/{k}": v.clone() for k, v in state.model.state_dict().items()}
    out.update({f"trace/{i}": t.clone() for i, t in enumerate(state.opt_state["trace"])})
    return out


@pytest.mark.parametrize("kw", [
    dict(global_step=7, steps_per_epoch=4, effective_batch=64, world_size=8, process_count=2),
    dict(global_step=12, steps_per_epoch=4, effective_batch=32, accum_steps=2, world_size=1,
         process_count=1, data_cursor={"seed": 3, "epoch": 3, "offset": 0}),
    dict(global_step=0, steps_per_epoch=0, effective_batch=8, world_size=4, process_count=4),
])
def test_manifest_equals_jax_build_manifest(kw):
    from distributeddeeplearning_tpu.training.checkpoint import build_manifest as jax_manifest

    assert build_manifest(**kw) == jax_manifest(**kw)
    default = build_manifest(global_step=5, steps_per_epoch=4, effective_batch=8)
    assert default["world_size"] == default["process_count"] == 1  # no process group
    assert (default["format"], default["epoch"], default["step_in_epoch"]) == (1, 1, 1)


def test_save_restore_roundtrip(tmp_path):
    model, tx, state = _state()
    step = make_train_step(model, tx, CFG, device="cpu")
    state, _ = step(state, _batch())
    saved = _flat(state)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_every_epochs=1)
    assert mgr.save(0, state)
    mgr.wait()
    assert mgr.latest_epoch() == 0
    assert sorted(os.listdir(tmp_path / "ckpt" / "0")) == ["manifest.json", "state.pt"]

    model2, tx2, fresh = _state()
    restored, start_epoch = mgr.maybe_restore(fresh)
    assert start_epoch == 1 and restored is fresh
    assert restored.step == state.step == 1
    assert restored.opt_state["count"] == 1
    for k, v in _flat(restored).items():
        assert torch.equal(v, saved[k]), k
    restored, metrics = make_train_step(model2, tx2, CFG, device="cpu")(restored, _batch())
    assert np.isfinite(float(metrics["loss"])) and restored.step == 2
    mgr.close()


def test_save_every_n_epochs(tmp_path):
    _, _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_every_epochs=2)
    assert not mgr.save(0, state)  # epoch 0 not due
    assert mgr.save(1, state)  # epoch 1 due (every 2)
    assert mgr.save(2, state, force=True)
    mgr.close()
    assert faults.checkpoint_steps(str(tmp_path / "ckpt")) == [1, 2]


def test_disabled_manager():
    mgr = CheckpointManager(None)
    assert not mgr.enabled
    assert not mgr.save(0, {"a": torch.zeros(2)})
    assert mgr.latest_epoch() is None
    state, start = mgr.maybe_restore({"a": torch.zeros(2)})
    assert start == 0
    with pytest.raises(RuntimeError):
        mgr.restore({"a": torch.zeros(2)})


def test_max_to_keep(tmp_path):
    _, _, state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for e in range(4):
        mgr.save(e, state)
    mgr.wait()
    assert mgr.latest_epoch() == 3
    assert faults.checkpoint_steps(str(tmp_path / "ckpt")) == [2, 3]
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state()[2], epoch=0)  # garbage-collected
    mgr.close()


def test_accum_steps_checkpoint_compat(tmp_path):
    """A checkpoint of an ACCUM_STEPS=1 run drives an ACCUM_STEPS=2 step:
    the microbatch sums never enter the state."""
    model, tx, state = _state()
    state, _ = make_train_step(model, tx, CFG, device="cpu")(state, _batch())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(0, state)
    mgr.close()

    model2, tx2, fresh = _state()
    restored, start = CheckpointManager(str(tmp_path / "ckpt")).maybe_restore(fresh)
    assert start == 1
    step = make_train_step(model2, tx2, CFG.replace(accum_steps=2), device="cpu")
    restored, metrics = step(restored, _batch())
    assert np.isfinite(float(metrics["loss"])) and restored.step == 2


def _tree(v: float):
    return {"w": torch.full((4,), float(v)), "b": torch.full((2,), float(v) * 10)}


def test_step_granular_save_and_resume_keying(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_every_steps=2, async_save=False,
                            max_to_keep=10)
    assert mgr.step_granular
    assert not mgr.save_step(1, _tree(1))  # not due
    assert mgr.save_step(2, _tree(2))  # due every 2
    assert not mgr.save_step(3, _tree(3))
    # an epoch boundary (epoch 0 of a 4-step epoch) forces the save
    # under its global-step key
    assert mgr.save_epoch_end(0, _tree(4), global_step=4)
    assert mgr.save_step(4, _tree(4)) is False  # already saved: idempotent
    assert mgr.save_step(6, _tree(6))
    mgr.close()

    mgr2 = CheckpointManager(str(tmp_path / "ckpt"), save_every_steps=2, async_save=False)
    state, epoch, skip = mgr2.maybe_restore_at(_tree(0), steps_per_epoch=4)
    assert (epoch, skip) == (1, 2)  # key 6 of a 4-step epoch
    assert torch.equal(state["w"], torch.full((4,), 6.0))
    mgr2.close()


def test_epoch_mode_unchanged_and_skipless(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    assert not mgr.step_granular
    assert mgr.save_step(5, _tree(5)) is False  # step saves are inert
    assert mgr.save_epoch_end(0, _tree(1), global_step=4)
    state, epoch, skip = mgr.maybe_restore_at(_tree(0), steps_per_epoch=4)
    assert (epoch, skip) == (1, 0)
    assert torch.equal(state["w"], torch.full((4,), 1.0))
    mgr.close()


def test_corrupt_latest_checkpoint_falls_back(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt_dir, save_every_steps=2, async_save=False, max_to_keep=10)
    assert mgr.save_step(2, _tree(2))
    assert mgr.save_step(4, _tree(4))
    mgr.close()
    assert faults.corrupt_latest_checkpoint(ckpt_dir) == os.path.join(ckpt_dir, "4")

    mgr2 = CheckpointManager(ckpt_dir, save_every_steps=2, async_save=False)
    state, epoch, skip = mgr2.maybe_restore_at(_tree(0), steps_per_epoch=4)
    assert (epoch, skip) == (0, 2)  # fell back from 4 to 2
    assert torch.equal(state["w"], torch.full((4,), 2.0))
    mgr2.close()

    shutil.rmtree(os.path.join(ckpt_dir, "4"))  # only step 2 remains...
    faults.corrupt_latest_checkpoint(ckpt_dir)  # ...and now it is corrupt
    mgr3 = CheckpointManager(ckpt_dir, save_every_steps=2, async_save=False)
    state, epoch, skip = mgr3.maybe_restore_at(_tree(0), steps_per_epoch=4)
    assert (epoch, skip) == (0, 0)
    assert torch.equal(state["w"], torch.zeros(4))
    mgr3.close()


def test_async_save_keeps_the_values_of_its_call(tmp_path):
    tree = _tree(1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    assert mgr.save(0, tree)
    tree["w"].add_(100.0)  # the optimizer updates parameters in place
    mgr.wait()
    restored, start = mgr.maybe_restore(_tree(0))
    assert start == 1 and torch.equal(restored["w"], torch.full((4,), 1.0))
    mgr.close()
