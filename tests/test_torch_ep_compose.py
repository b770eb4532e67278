"""Expert parallelism composed with the other axes, in 4-rank gloo
worlds of the port's pjit engine against the JAX package's GSPMD step
on the matching mesh of the first four forced CPU devices
(``tests/test_moe.py``'s twins; the 2-rank worlds:
``test_torch_ep.py``).

``lm_moe_tiny`` (4 experts) in f32, two steps of 8 rows. In a 2-rank
world: ``(data 1, expert 2)`` with ``ACCUM_STEPS=2`` and with AdamW, and
the replicated ``dp`` rules on ``(data 2)`` (the load-balance loss the
global batch's, as GSPMD computes it, not each data shard's). In a
4-rank world, top-2 and top-1: ``(data 2, expert 2)`` (each data shard's tokens over its expert
pair, the load-balance loss the global batch's) and ``(expert 2, model
2)`` (every expert weight split two ways: the expert dim over
``expert``, its ``mlp`` dim over ``model``). Loss, accuracy and gradient
norm within 1e-5 relative, parameters within 1e-4 of the largest value;
the parameters the layout does not split bitwise equal across the
expert ranks after the steps. JAX's own oracle
(``test_ep_matches_dense_replicated``): the ``(data 2, expert 2)`` step
from the seeded init equals the port's one-rank dp step, loss within
1e-5 relative and every parameter within 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import assert_step_matches, jax_pjit, metrics_close, run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import create_optimizer, engines

VOCAB, T, ROWS, SPE, EXPERTS = 64, 16, 8, 10, 4
LM = dict(model="lm_moe_tiny", num_classes=VOCAB, batch_size_per_device=ROWS // 4,
          compute_dtype="float32", base_lr=0.5, warmup_epochs=1, weight_decay=1e-3,
          engine="pjit", param_sharding="tp", moe_experts=EXPERTS)
ADAMW = dict(optimizer="adamw", decoupled_weight_decay=0.1, weight_decay=0.0, base_lr=1e-3)
# name: (mesh axes, mesh shape, top_k, extra config)
WORLDS = {
    "ep_x_data": (("data", "expert"), (2, 2), 2, {}),
    "ep_x_data_top1": (("data", "expert"), (2, 2), 1, {}),
    "ep_x_model": (("expert", "model"), (2, 2), 2, {}),
    "ep_x_model_top1": (("expert", "model"), (2, 2), 1, {}),
}
WORLDS2 = {
    "ep_accum": (("data", "expert"), (1, 2), 2, dict(accum_steps=2)),
    "ep_adamw": (("data", "expert"), (1, 2), 2, ADAMW),
    "dp_moe": (("data",), (2,), 2, dict(param_sharding="dp")),
}
ALL = {**WORLDS, **WORLDS2}


def _rows(seed):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, VOCAB, size=(ROWS, T + 1)).astype(np.int32)
    return r[:, :-1], r[:, 1:]


DATA = [_rows(1), _rows(2)]


def _cfg(name):
    axes, shape, _, extra = ALL[name]
    rows = ROWS // (4 if name in WORLDS else 2)
    return dict(LM, mesh_axes=axes, mesh_shape=shape, batch_size_per_device=rows, **extra)


def _model_kw(name):
    return dict(max_seq_len=T, moe_top_k=ALL[name][2])


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    return {w: jax_pjit(_cfg(w), "lm_moe_tiny", _model_kw(w), (1, T), jnp.int32, DATA, SPE,
                        n_devices=4 if w in WORLDS else 2)
            for w in ALL}


ORACLE = dict(LM, weight_decay=0.0, base_lr=0.1, mesh_axes=("data", "expert"),
              mesh_shape=(2, 2))


@pytest.fixture(scope="module")
def port(jax_runs, tmp_path_factory):
    model = lambda w: dict(name="lm_moe_tiny", kwargs=dict(_model_kw(w), moe_experts=EXPERTS))
    jobs = {w: dict(kind="step", cfg=_cfg(w), model=model(w), batches=DATA,
                    steps_per_epoch=SPE, replicas=["expert"] if "expert" in ALL[w][0] else None,
                    state=convert.params_from_flax(jax_runs[w][0][0]))
            for w in ALL}
    jobs["oracle"] = dict(kind="step", cfg=ORACLE, model=model("ep_x_data"), batches=DATA[:1],
                          steps_per_epoch=SPE, lr_world=1)
    four = [j for w, j in jobs.items() if w not in WORLDS2]
    two = [jobs[w] for w in WORLDS2]
    out = run_world(four, 4, tmp_path_factory.mktemp("ep4"))
    out2 = run_world(two, 2, tmp_path_factory.mktemp("ep2"))
    return {**dict(zip([w for w in jobs if w not in WORLDS2], out)), **dict(zip(WORLDS2, out2))}


@pytest.mark.parametrize("world", list(ALL))
def test_composed_ep_step_matches_jax(jax_runs, port, world):
    _, want_metrics, (want_params, _) = jax_runs[world]
    got = port[world]
    metrics_close(got["metrics"], want_metrics)
    assert_step_matches(want_params, convert.params_to_flax(got["state"]["model"]), rel=1e-4)
    if "expert" in ALL[world][0]:
        assert got["replicas_agree"] == {"expert": True}


def test_ep_matches_dense_replicated(port):
    """EP only moves where the experts live: the sharded step equals the
    one-rank step from the same seeded init."""
    cfg = TrainConfig(**dict(ORACLE, engine="dp", mesh_axes=("data",), mesh_shape=None,
                             batch_size_per_device=ROWS))
    model = get_model("lm_moe_tiny", num_classes=VOCAB, dtype=torch.float32, device="cpu",
                      moe_experts=EXPERTS, **_model_kw("ep_x_data"))
    tx, _ = create_optimizer(cfg, SPE, world_size=1)
    eng = engines.build_engine(model, cfg, tx, device="cpu")
    state, m = eng.train_step(eng.state, tuple(torch.as_tensor(x) for x in DATA[0]))
    got = port["oracle"]
    assert np.isclose(got["metrics"][0]["loss"], float(m["loss"]), rtol=1e-5)
    want = {k: v.detach() for k, v in state.model.state_dict().items()}
    for k, v in got["state"]["model"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=2e-5, rtol=0, err_msg=k)
