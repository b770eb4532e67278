"""The port's pipeline engine (``models/pipeline_lm.py``,
``training/pp_step.py``) in a 2-rank gloo world, one stage a rank,
against the JAX package's ``make_pp_train_step`` on a ``(data 1, pipe
2)`` mesh of the first two forced CPU devices, from the same weights
(JAX's ``PipelineLM.init`` carried over stage by stage with
``convert.pipeline_params_from_flax``), f32, two steps of 8 rows in 4
microbatches with weight decay:

* GPipe and 1F1B each against JAX's same schedule: loss, accuracy and
  gradient norm within 1e-5 relative; parameters within 1e-4 of the
  largest value (``assert_step_matches``); a missing or doubled pipe sum
  of the embedding's or head's gradient moves them by far more;
* the port's 1F1B against its GPipe, and with dropout 0.3 the two
  schedules against each other, as tight as JAX's own oracle
  (``tests/test_pp_step.py``: loss 1e-5 relative, parameters 2e-5);
* eval through the relay against JAX's ``make_pp_eval_step`` (1e-5);
* the stacked-tree carry-over round trip and the step's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import assert_step_matches, run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models.pipeline_lm import PipelineLM
from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
from distributeddeeplearning_tpu_torch.training import create_optimizer
from distributeddeeplearning_tpu_torch.training.pp_step import create_pp_state, make_pp_train_step

VOCAB, T, ROWS, M, SPE = 64, 16, 8, 4, 10
CFG = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=ROWS,
           compute_dtype="float32", base_lr=0.5, warmup_epochs=1, weight_decay=1e-3,
           scale_lr_by_world_size=False, engine="pp", pp_microbatches=M,
           mesh_axes=("data", "pipe"), mesh_shape=(1, 2))
MODEL = dict(name="lm_tiny", kwargs=dict(max_seq_len=T))


def _rows(seed):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, VOCAB, size=(ROWS, T + 1)).astype(np.int32)
    return r[:, :-1], r[:, 1:]


DATA = [_rows(1), _rows(2)]


def _jax_pl(dropout=0.0):
    from distributeddeeplearning_tpu.models.pipeline_lm import PipelineLM as JaxPL

    return JaxPL(variant="tiny", vocab_size=VOCAB, max_seq_len=T, num_stages=2, n_layers=2,
                 dtype=jnp.float32, dropout=dropout)


@pytest.fixture(scope="module")
def params():
    return _jax_pl().init(jax.random.PRNGKey(0), T)


def run_jax(params, schedule, eval_batch=None):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh as jax_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import pp_step as jpp

    cfg = JaxConfig(**dict(CFG, pp_schedule=schedule))
    mesh = jax_mesh(devices=jax.devices()[:2], axes=("data", "pipe"), shape=(1, 2))
    pl = _jax_pl()
    tx, _ = jax_opt(cfg, SPE, world_size=1)
    # the fixture's params: pl.init(PRNGKey(0), T)
    state = jpp.create_pp_state(pl, cfg, tx, mesh, T, rng=jax.random.PRNGKey(0))
    step = jpp.make_pp_train_step(pl, tx, mesh, cfg, num_microbatches=M, schedule=schedule,
                                  donate_state=False)
    metrics = []
    for batch in DATA:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": jax.tree.map(np.asarray, state.params)}
    if eval_batch is not None:
        ev = jpp.make_pp_eval_step(pl, mesh)(state, eval_batch)
        out["eval"] = {k: float(v) for k, v in ev.items()}
    return out


def _stage_sds(params):
    return [convert.pipeline_params_from_flax(params, s) for s in range(2)]


def _flax(state_dict):
    """The worker's whole state (core stacked [S, ...]) as JAX's tree."""
    stages = [{k: (v[s] if k.startswith("core.") else v) for k, v in state_dict.items()}
              for s in range(2)]
    return convert.pipeline_params_to_flax(stages)


@pytest.fixture(scope="module")
def port(params, tmp_path_factory):
    sds = _stage_sds(params)
    jobs = [dict(kind="step", cfg=dict(CFG, pp_schedule=s), model=MODEL, state=sds,
                 batches=DATA, steps_per_epoch=SPE, eval=DATA[0] if s == "gpipe" else None)
            for s in ("gpipe", "1f1b")]
    drop = dict(MODEL, kwargs=dict(max_seq_len=T, dropout=0.3))
    jobs += [dict(kind="step", cfg=dict(CFG, pp_schedule=s), model=drop, state=sds,
                  batches=DATA, steps_per_epoch=SPE) for s in ("gpipe", "1f1b")]
    return run_world(jobs, 2, tmp_path_factory.mktemp("pp"))


def _metrics_close(got, want, rtol=1e-5):
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1.0), (k, g[k], w[k])


@pytest.mark.parametrize("schedule,idx", [("gpipe", 0), ("1f1b", 1)])
def test_pp_step_matches_jax_schedule(params, port, schedule, idx):
    want = run_jax(params, schedule)
    got = port[idx]
    _metrics_close(got["metrics"], want["metrics"])
    assert_step_matches(want["params"], _flax(got["state"]["model"]), rel=1e-4)


def test_pp_1f1b_matches_gpipe(port):
    g, o = port[0], port[1]
    _metrics_close(o["metrics"], g["metrics"])
    assert_step_matches(_flax(g["state"]["model"]), _flax(o["state"]["model"]), rel=2e-5)


def test_pp_schedules_agree_with_dropout(port):
    g, o = port[2], port[3]
    _metrics_close(o["metrics"], g["metrics"])
    assert_step_matches(_flax(g["state"]["model"]), _flax(o["state"]["model"]), rel=2e-5)
    # dropout changed the trajectory (the masks were drawn)
    assert abs(g["metrics"][1]["loss"] - port[0]["metrics"][1]["loss"]) > 1e-4


def test_pp_eval_matches_jax(params, port):
    want = run_jax(params, "gpipe", eval_batch=DATA[0])["eval"]
    got = port[0]["eval"]
    for k in ("loss", "top1", "top5", "count"):
        assert abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1.0), (k, got[k], want[k])


def test_pipeline_params_round_trip(params):
    back = convert.pipeline_params_to_flax(_stage_sds(params))
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_pp_state_holds_its_stage_only():
    cfg = TrainConfig(**dict(CFG, mesh_shape=(1, 1)))
    pl = PipelineLM("tiny", VOCAB, T, num_stages=1, n_layers=2, dtype=torch.float32,
                    device="cpu")
    tx, _ = create_optimizer(cfg, SPE)
    state = create_pp_state(pl, cfg, tx, create_mesh(axes=("data", "pipe")), device="cpu")
    assert len(pl.core.layers) == 2 and state.layout.names[0].startswith("embed.")
    assert len(state.opt_state["trace"]) == len(list(pl.parameters()))


def test_pp_step_refusals():
    cfg = TrainConfig(**dict(CFG, mesh_shape=(1, 1)))
    pl = PipelineLM("tiny", VOCAB, T, num_stages=1, n_layers=2, dtype=torch.float32,
                    device="cpu")
    tx, _ = create_optimizer(cfg, SPE)
    mesh = create_mesh(axes=("data", "pipe"))
    state = create_pp_state(pl, cfg, tx, mesh, device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        make_pp_train_step(pl, tx, mesh, cfg, state.layout, device="cpu", schedule="zb")
    with pytest.raises(ValueError, match="pipe"):
        make_pp_train_step(pl, tx, create_mesh(), cfg, state.layout, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        PipelineLM("tiny", VOCAB, T, num_stages=3, dtype=torch.float32, device="cpu")
    step = make_pp_train_step(pl, tx, mesh, cfg, state.layout, device="cpu", num_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(state, DATA[0])
