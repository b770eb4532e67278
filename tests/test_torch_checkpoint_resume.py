"""Resume through the port's ``fit`` (``training/checkpoint.py`` +
``training/loop.py``), twin of ``tests/test_fault_tolerance.py:173``:

* a mid-epoch resume (newer checkpoints deleted, ``fit`` run again)
  ending BITWISE equal to the uninterrupted run, with checkpointing not
  perturbing the run either: ``lm_tiny``, ``lm_tiny`` under
  ``GRAD_ACCUM_STEPS=2`` (the ``MultiSteps`` mean restored half full)
  and a ResNet-18 under ``ACCUM_STEPS=2`` (BatchNorm running statistics);
* a 2-rank gloo ``fit`` (``_torch_dp_worker.py``) writing its checkpoints
  once, from rank 0, and matching one process fed the global batch.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset, make_dataset
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    loop,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


VOCAB, T = 64, 16


def _fit(kind, **kw):
    """2 epochs of 4 steps: ``lm`` (lm_tiny, f32), ``lm_multisteps``
    (the same under GRAD_ACCUM_STEPS=2) or ``resnet_accum`` (resnet18,
    16 px, ACCUM_STEPS=2, BatchNorm)."""
    if kind.startswith("lm"):
        cfg = TrainConfig(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=2,
                          fake_data_length=8, epochs=2, compute_dtype="float32",
                          weight_decay=0.0, log_every_steps=0,
                          grad_accum_steps=2 if kind == "lm_multisteps" else 1, **kw)
        data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                     global_batch_size=cfg.global_batch_size, seq_len=T,
                                     vocab_size=VOCAB)
        model = get_model("lm_tiny", num_classes=VOCAB, dtype="float32", max_seq_len=T,
                          device="cpu")
    else:
        cfg = TrainConfig(model="resnet18", num_classes=8, image_size=16,
                          batch_size_per_device=4, fake_data_length=16, epochs=2,
                          compute_dtype="float32", log_every_steps=0, accum_steps=2, **kw)
        data = make_dataset(cfg)
        model = get_model("resnet18", num_classes=8, dtype="float32", device="cpu")
    return loop.fit(model, cfg, data, device="cpu", add_default_logger=False)


@pytest.mark.parametrize("kind", ["lm", "lm_multisteps", "resnet_accum"])
def test_midepoch_resume_is_bitwise_equivalent(kind, tmp_path):
    ref = _fit(kind)
    ckpt_dir = str(tmp_path / "ckpt")
    kw = dict(model_dir=ckpt_dir, checkpoint_every_steps=3, checkpoint_async=False,
              checkpoint_keep=10)
    full = _fit(kind, **kw)
    ref_sd, full_sd = ref.state.model.state_dict(), full.state.model.state_dict()
    for k in ref_sd:  # checkpointing does not perturb the run
        assert torch.equal(ref_sd[k], full_sd[k]), k

    # "Preempted at step 3": key 3 of a 4-step epoch is mid-epoch 0 (and,
    # under GRAD_ACCUM_STEPS=2, half way through an accumulation).
    steps = faults.checkpoint_steps(ckpt_dir)
    assert steps == [3, 4, 6, 8], steps
    for s in steps:
        if s > 3:
            shutil.rmtree(os.path.join(ckpt_dir, str(s)))
    resumed = _fit(kind, **kw)
    assert resumed.history[0]["epoch_images"] == (2 if kind.startswith("lm") else 4)
    assert resumed.state.step == ref.state.step == 8
    got = resumed.state.model.state_dict()
    for k in ref_sd:
        assert torch.equal(ref_sd[k], got[k]), k
    for a, b in zip(ref.state.opt_state.get("trace") or ref.state.opt_state["inner"]["trace"],
                    resumed.state.opt_state.get("trace")
                    or resumed.state.opt_state["inner"]["trace"]):
        assert torch.equal(a, b)
    assert ref.history[-1]["loss"] == resumed.history[-1]["loss"]


def test_two_rank_gloo_fit_checkpoints_once_and_matches_one_process(tmp_path):
    """A 2-rank gloo ``fit`` (``lm_tiny``, 2 sequences a rank, the global
    token stream, step checkpoints every 3 steps, the broadcast check at
    train begin) against one process fed the whole global batch: the
    same steps and history (1e-6 relative: the mean of two half-batch
    gradients against the full batch's, f32 re-association; measured
    9.8e-8) and parameters within rtol 1e-5 / atol 1e-7 (measured: at
    most 1.5e-8 apart);
    on rank 0 one host sync an epoch and one a save; the checkpoints
    written once, by rank 0, their manifests naming a world of 2 and the
    global batch."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_train_step_dp import _free_port

    root = Path(__file__).resolve().parent.parent
    ckpt_dir = str(tmp_path / "ckpt")
    cfg = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=2, epochs=2,
               compute_dtype="float32", weight_decay=0.0, log_every_steps=0,
               model_dir=ckpt_dir, checkpoint_every_steps=3, checkpoint_async=False,
               checkpoint_keep=10, scale_lr_by_world_size=False,
               warmup_epochs=0)  # one LR schedule for both worlds
    model = get_model("lm_tiny", num_classes=VOCAB, dtype="float32", max_seq_len=T,
                      device="cpu")
    sd = {k: v.clone() for k, v in create_train_state(
        model, TrainConfig(**cfg), create_optimizer(TrainConfig(**cfg), 4)[0],
        device="cpu").model.state_dict().items()}
    payload = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    payload.update({f"cfg/{k}": np.asarray(v) for k, v in cfg.items()})
    payload.update(length=np.asarray(16), seq_len=np.asarray(T))
    path_in, path_out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(path_in, **payload)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'tests'}")
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "_torch_dp_worker.py"), str(r), "2", str(port),
         "fit", str(path_in), str(path_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = np.load(path_out)
    assert float(out["host_sync_count"]) == 2 + 4  # rank 0: an epoch's readback, a save's copy

    steps = faults.checkpoint_steps(ckpt_dir)
    assert steps == [3, 4, 6, 8], steps
    assert not [n for n in os.listdir(ckpt_dir) if not n.isdigit()]  # no leftover temp dir
    with open(os.path.join(ckpt_dir, "6", "manifest.json")) as fh:
        manifest = json.load(fh)
    assert (manifest["world_size"], manifest["process_count"]) == (2, 2)
    assert manifest["effective_batch"] == 4 and manifest["steps_per_epoch"] == 4

    one = dict(cfg, batch_size_per_device=4, model_dir=None)
    model = get_model("lm_tiny", num_classes=VOCAB, dtype="float32", max_seq_len=T,
                      device="cpu")
    data = SyntheticTokenDataset(length=16, global_batch_size=4, seq_len=T, vocab_size=VOCAB,
                                 topology="global")
    res = loop.fit(model, TrainConfig(**one), data, device="cpu", state=create_train_state(
        model, TrainConfig(**one), create_optimizer(TrainConfig(**one), 4)[0], device="cpu",
        state_dict=sd), add_default_logger=False)
    assert res.state.step == 8
    for e, h in enumerate(res.history):
        assert float(out[f"history{e}/global_step"]) == h["global_step"]
        assert float(out[f"history{e}/epoch_images"]) == h["epoch_images"] == 16
        for k in ("loss", "accuracy", "grad_norm"):
            got = float(out[f"history{e}/{k}"])
            assert abs(got - h[k]) <= 1e-6 * max(abs(h[k]), 1.0), (e, k, got, h[k])
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(out[f"sd/{k}"], v.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
