"""The elastic math contract through the port's ``fit``, the twin of
``tests/test_elastic.py::test_inprocess_elastic_shrink_grow_is_ulp_equivalent``
with real process groups: ``lm_tiny`` f32 (vocab 64, T 16) from weights
converted from JAX's init, 3 epochs of 4 steps of a global batch of 4 on
the global token stream, step checkpoints.

1. A 2-rank gloo world (``tests/_torch_dp_worker.py ... fit``) trains
   uninterrupted; its checkpoints past step 6 are deleted (a preemption
   mid-epoch 1).
2. A 1-rank world resumes at step 6 with ``BATCHSIZE`` x2 (4),
   ``ACCUM_STEPS`` x2 and ``LR_WORLD_SIZE=2``, ``ELASTIC=1`` (the
   effective batch and the LR schedule unchanged), for the rest of
   epoch 1.
3. A 2-rank world grows back from step 8 and trains epoch 2.

Each leg's final parameters and momentum trace are held to JAX's
uninterrupted ``fit`` on a 2-device mesh within JAX's own limit for the
same contract (rtol 2e-4, atol 2e-7: ``tests/test_elastic.py:614-615``),
and the parameter updates within 2e-5 of their norm together. Every leg
reads one host sync an epoch (``epoch_metrics``) and one a save
(``checkpoint``); the resized restores emit ``elastic.world_resized``
(2 -> 1, then 1 -> 2) and ``elastic.reshard_ms``. A resume at a wrong
effective batch is refused under ``ELASTIC=1`` and only warns without
it, as in JAX.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch import faults
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import create_optimizer, create_train_state, loop

ROOT = Path(__file__).resolve().parent.parent
VOCAB, T, LENGTH, GLOBAL_BATCH = 64, 16, 16, 4
BASE = dict(model="lm_tiny", num_classes=VOCAB, compute_dtype="float32", weight_decay=0.0,
            base_lr=0.1, warmup_epochs=1, log_every_steps=0, epochs=3)
CKPT = dict(checkpoint_every_steps=1, checkpoint_async=False, checkpoint_keep=20)
RTOL, ATOL = 2e-4, 2e-7  # JAX's own limit for this contract
UPDATE_REL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_reference():
    """JAX's uninterrupted 3-epoch ``fit`` on a 2-device mesh, and its
    initial parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data import SyntheticTokenDataset as JaxTokens
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import loop as jax_loop

    cfg = JaxConfig(**BASE, batch_size_per_device=2)
    data = JaxTokens(length=LENGTH, global_batch_size=GLOBAL_BATCH, seq_len=T,
                     vocab_size=VOCAB, seed=cfg.seed)
    model = jax_get_model(cfg.model, **cfg.model_kwargs(), max_seq_len=T)
    tx, _ = jax_opt(cfg, data.steps_per_epoch, world_size=2)
    state = jax_state(model, cfg, tx, input_shape=(1, T), input_dtype=jnp.int32)
    init = jax.tree.map(np.asarray, state.params)
    res = jax_loop.fit(model, cfg, data, mesh=create_mesh(devices=jax.devices()[:2]),
                       state=state, add_default_logger=False)
    traces = [s for s in jax.tree.leaves(res.state.opt_state,
                                          is_leaf=lambda x: isinstance(x, optax.TraceState))
              if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    return (init, jax.tree.map(np.asarray, res.state.params),
            jax.tree.map(np.asarray, traces[0].trace), res.history)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _worker(tmp_path, name, world, cfg, sd, obs_dir):
    """One leg: ``world`` ranks of ``_torch_dp_worker.py fit``; rank 0's
    output."""
    from test_torch_train_step_dp import _free_port

    payload = {f"sd/{k}": v.numpy() for k, v in sd.items()}
    payload.update({f"cfg/{k}": np.asarray(v) for k, v in cfg.items()})
    payload.update(length=np.asarray(LENGTH), seq_len=np.asarray(T))
    path_in, path_out = tmp_path / f"{name}_in.npz", tmp_path / f"{name}_out.npz"
    np.savez(path_in, **payload)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
               OBS_DIR=str(obs_dir), OBS_PROC_SUFFIX=f"-{name}")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"), str(r), str(world),
         str(port), "fit", str(path_in), str(path_out)],
        env=dict(env, DDL_PROCESS_ID=str(r)),  # each rank its own event file
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return np.load(path_out)


def _hold_to_jax(out, init, want_params, want_trace, what):
    got = dict(_leaves(convert.params_to_flax(
        {k[3:]: torch.from_numpy(out[k]) for k in out.files if k.startswith("sd/")})))
    got_trace = dict(_leaves(convert.params_to_flax(
        {k[4:]: torch.from_numpy(out[k]) for k in out.files if k.startswith("opt/")})))
    p0, pw, tw = dict(_leaves(init)), dict(_leaves(want_params)), dict(_leaves(want_trace))
    assert got.keys() == pw.keys() == got_trace.keys() == tw.keys()
    num = den = 0.0
    for k in pw:
        np.testing.assert_allclose(got[k], pw[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
        np.testing.assert_allclose(got_trace[k], tw[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} trace {k}")
        d = (got[k] - p0[k]) - (pw[k] - p0[k])
        num, den = num + float(np.sum(d * d)), den + float(np.sum((pw[k] - p0[k]) ** 2))
    assert np.sqrt(num) <= UPDATE_REL * np.sqrt(den), (what, np.sqrt(num / den))


def _events(obs_dir, suffix):
    recs = []
    for p in sorted(Path(obs_dir).glob(f"events-p0-{suffix}.jsonl")):
        recs += [json.loads(ln) for ln in open(p)]
    return recs


def test_shrink_and_grow_back_through_fit_matches_jax_uninterrupted(tmp_path):
    init, want_params, want_trace, want_history = _jax_reference()
    sd = convert.params_from_flax(init)
    ckpt_dir = str(tmp_path / "ckpt")
    obs_dir = tmp_path / "obs"

    # 1. the full world, uninterrupted, every step checkpointed
    full = _worker(tmp_path, "full", 2, dict(BASE, **CKPT, batch_size_per_device=2,
                                             model_dir=ckpt_dir), sd, obs_dir)
    assert float(full["sync/epoch_metrics"]) == 3 and float(full["sync/checkpoint"]) == 12
    for e, h in enumerate(want_history):
        got = float(full[f"history{e}/loss"])
        assert abs(got - h["loss"]) <= 1e-5 * max(abs(h["loss"]), 1.0), (e, got, h["loss"])
    _hold_to_jax(full, init, want_params, want_trace, "uninterrupted")

    # preempted at step 6: mid-epoch 1, 2 of its 4 batches done
    for s in faults.checkpoint_steps(ckpt_dir):
        if s > 6:
            shutil.rmtree(os.path.join(ckpt_dir, str(s)))
    assert faults.checkpoint_steps(ckpt_dir)[-1] == 6

    # 2. shrunken to one rank, the math held: the rest of epoch 1
    elastic = dict(BASE, **CKPT, model_dir=ckpt_dir, elastic=True, lr_world_size=2)
    shrunk = _worker(tmp_path, "shrunk", 1, dict(elastic, batch_size_per_device=4,
                                                 accum_steps=2, epochs=2), sd, obs_dir)
    assert float(shrunk["history0/global_step"]) == 8
    assert float(shrunk["history0/epoch_images"]) == 2 * GLOBAL_BATCH  # 2 batches replayed
    assert float(shrunk["sync/epoch_metrics"]) == 1 and float(shrunk["sync/checkpoint"]) == 2
    ev = _events(obs_dir, "shrunk")
    resized = [e["labels"] for e in ev if e.get("name") == "elastic.world_resized"]
    assert resized == [{"step": 6, "from_world": 2, "to_world": 1}], resized
    assert any(e.get("name") == "elastic.reshard_ms" for e in ev)

    # 3. grown back to two ranks: epoch 2
    grown = _worker(tmp_path, "grown", 2, dict(elastic, batch_size_per_device=2), sd, obs_dir)
    assert float(grown["history0/global_step"]) == 12
    assert float(grown["sync/epoch_metrics"]) == 1 and float(grown["sync/checkpoint"]) == 4
    ev = _events(obs_dir, "grown")
    resized = [e["labels"] for e in ev if e.get("name") == "elastic.world_resized"]
    assert resized == [{"step": 8, "from_world": 1, "to_world": 2}], resized
    h = want_history[-1]
    got = float(grown["history0/loss"])
    assert abs(got - h["loss"]) <= 1e-4 * max(abs(h["loss"]), 1e-6), (got, h["loss"])
    _hold_to_jax(grown, init, want_params, want_trace, "shrunk and grown")

    # A resume at the wrong effective batch: one rank at 2 a rank
    # delivers 2, the checkpoint was trained at 4.
    class _Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    def refit(elastic_on):
        cfg = TrainConfig(**dict(BASE, **CKPT, model_dir=ckpt_dir, batch_size_per_device=2,
                                 elastic=elastic_on, lr_world_size=2))
        data = SyntheticTokenDataset(length=LENGTH, global_batch_size=2, seq_len=T,
                                     vocab_size=VOCAB, topology="global")
        model = get_model("lm_tiny", num_classes=VOCAB, dtype="float32", max_seq_len=T,
                          device="cpu")
        tx, _ = create_optimizer(cfg, data.steps_per_epoch, world_size=2)
        state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
        return loop.fit(model, cfg, data, device="cpu", tx=tx, state=state,
                        add_default_logger=False)

    with pytest.raises(ValueError, match="ELASTIC resume refused.*effective batch 4"):
        refit(True)
    handler = _Warnings()
    logging.getLogger("ddl_tpu").addHandler(handler)
    try:
        refit(False)
    finally:
        logging.getLogger("ddl_tpu").removeHandler(handler)
    assert any("effective batch 4" in m and "ELASTIC is off" in m for m in handler.messages)
