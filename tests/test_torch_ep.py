"""Expert parallelism in the port's pjit engine (``models/moe.py``,
``training/pjit_step._shard_experts``) in 2-rank gloo worlds against the
JAX package's GSPMD step on the matching mesh of the first two forced
CPU devices (twins of ``tests/test_moe.py``'s EP tests,
``tests/test_fsdp.py::test_fsdp_moe_composition`` and
``tests/test_checkpoint.py::test_ep_sharded_state_roundtrip``).

``lm_moe_tiny`` (4 experts, block 1 routed) in f32, JAX's
sharded-at-birth init carried over with ``convert.params_from_flax``,
two steps of 8 rows, top-2 and top-1 routing: the experts over
``expert`` on ``(data 1, expert 2)``, over ``model`` inside each expert
under ``tp`` on ``(data 1, model 2)``, their ``embed`` dims over
``data`` under ``fsdp`` on ``(data 2)``. Loss, accuracy and gradient norm
within 1e-5 relative, parameters within 1e-4 of the largest value
(``assert_step_matches``); after the steps the parameters the layout
does not split are bitwise equal across the expert (or model) ranks.
An EP checkpoint restores bitwise into EP and into dp, and a dp one
into EP; an expert count the ``expert`` axis does not divide raises a
``ValueError`` naming both. (``ACCUM_STEPS``, AdamW, the ``dp`` rules
and the 4-rank worlds: ``test_torch_ep_compose.py``.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import assert_step_matches, jax_pjit, metrics_close, run_world
from distributeddeeplearning_tpu_torch.models import convert

VOCAB, T, ROWS, SPE, EXPERTS = 64, 16, 8, 10, 4
LM = dict(model="lm_moe_tiny", num_classes=VOCAB, batch_size_per_device=ROWS // 2,
          compute_dtype="float32", base_lr=0.5, warmup_epochs=1, weight_decay=1e-3,
          engine="pjit", moe_experts=EXPERTS)
EP, TP, DATA2 = (("data", "expert"), (1, 2)), (("data", "model"), (1, 2)), (("data",), (2,))
# name: (param_sharding, mesh, top_k, extra config)
WORLDS = {
    "ep": ("tp", EP, 2, {}), "ep_top1": ("tp", EP, 1, {}),
    "tp_moe": ("tp", TP, 2, {}), "tp_moe_top1": ("tp", TP, 1, {}),
    "fsdp_moe": ("fsdp", DATA2, 2, {}), "fsdp_moe_top1": ("fsdp", DATA2, 1, {}),
}
# the replicated copies held bitwise equal after the steps, by world
REPLICAS = {"ep": ["expert"], "ep_top1": ["expert"], "tp_moe": ["model"]}


def _rows(seed, n=ROWS):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, VOCAB, size=(n, T + 1)).astype(np.int32)
    return r[:, :-1], r[:, 1:]


DATA = [_rows(1), _rows(2)]


def _cfg(name):
    sharding, (axes, shape), _, extra = WORLDS[name]
    return dict(LM, param_sharding=sharding, mesh_axes=axes, mesh_shape=shape, **extra)


def _model_kw(name):
    return dict(max_seq_len=T, moe_top_k=WORLDS[name][2])


def _port_model(name):
    return dict(name="lm_moe_tiny", kwargs=dict(_model_kw(name), moe_experts=EXPERTS))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    return {w: jax_pjit(_cfg(w), "lm_moe_tiny", _model_kw(w), (1, T), jnp.int32, DATA, SPE)
            for w in WORLDS}


def _ckpt_runs(tmp):
    """Save under one layout, restore under another: EP -> EP, EP -> dp,
    dp -> EP (a restore's seed differs from the save's)."""
    ep, dp = _cfg("ep"), dict(_cfg("ep"), engine="dp", mesh_axes=("data",), mesh_shape=None,
                              param_sharding="tp")
    job = dict(kind="ckpt", model=_port_model("ep"), batch=DATA[0], steps_per_epoch=SPE)
    return [dict(job, dir=str(tmp / "ep"), runs=[dict(cfg=ep, save=True),
                                                 dict(cfg=dict(ep, seed=7), save=False),
                                                 dict(cfg=dict(dp, seed=7), save=False)]),
            dict(job, dir=str(tmp / "dp"), runs=[dict(cfg=dp, save=True),
                                                 dict(cfg=dict(ep, seed=7), save=False)])]


@pytest.fixture(scope="module")
def port(jax_runs, tmp_path_factory):
    """Every world's port run, the checkpoint round trips and the refused
    split in one 2-rank world, by name."""
    tmp = tmp_path_factory.mktemp("ep")
    jobs = {w: dict(kind="step", cfg=_cfg(w), model=_port_model(w), batches=DATA,
                    steps_per_epoch=SPE, replicas=REPLICAS.get(w),
                    state=convert.params_from_flax(jax_runs[w][0][0]))
            for w in WORLDS}
    ckpt = _ckpt_runs(tmp)
    jobs["ckpt_ep"], jobs["ckpt_dp"] = ckpt
    # no MESH_SHAPE: the expert size is the world's, so the layout checks it
    jobs["odd"] = dict(kind="layout_error",
                       cfg=dict(_cfg("ep"), moe_experts=3, mesh_shape=None),
                       model=dict(name="lm_moe_tiny", kwargs=dict(_model_kw("ep"), moe_experts=3)))
    out = run_world(list(jobs.values()), 2, tmp)
    return dict(zip(jobs, out))


@pytest.mark.parametrize("world", list(WORLDS))
def test_moe_pjit_step_matches_jax(jax_runs, port, world):
    _, want_metrics, (want_params, _) = jax_runs[world]
    got = port[world]
    metrics_close(got["metrics"], want_metrics)
    assert_step_matches(want_params, convert.params_to_flax(got["state"]["model"]), rel=1e-4)


@pytest.mark.parametrize("world", sorted(REPLICAS))
def test_replicated_parameters_bitwise_equal_across_the_group(port, world):
    assert port[world]["replicas_agree"] == {a: True for a in REPLICAS[world]}


def test_expert_weights_gather_whole_in_flax_layout(port):
    """The whole state gathers back to the dp model's shapes (the expert
    dim and, under tp, the ``mlp`` dim joined), the momentum too."""
    for w in ("ep", "tp_moe", "fsdp_moe"):
        model = port[w]["state"]["model"]
        assert tuple(model["blocks.1.moe.w1"].shape) == (EXPERTS, 128, 512)
        assert tuple(model["blocks.1.moe.router"].shape) == (128, EXPERTS)
        names = [k for k in model if not k.endswith(("running_mean", "running_var"))]
        trace = port[w]["state"]["opt"]["trace"]
        assert [tuple(t.shape) for t in trace] == [tuple(model[n].shape) for n in names]


def _same(a, b):
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt"]["trace"], b["opt"]["trace"]):
        assert torch.equal(x, y)


def test_ep_checkpoint_restores_bitwise_into_ep_and_dp(port):
    saved, into_ep, into_dp = port["ckpt_ep"]
    assert saved["step"] == 1
    _same(saved, into_ep)
    _same(saved, into_dp)


def test_dp_checkpoint_restores_bitwise_into_ep(port):
    saved, into_ep = port["ckpt_dp"]
    _same(saved, into_ep)


def test_experts_not_divisible_by_the_expert_axis_raise(port):
    msg = port["odd"]
    assert msg is not None and "3 experts" in msg and "expert=2" in msg
