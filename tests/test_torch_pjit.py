"""The port's pjit engine (``training/pjit_step.py``) in 2-rank gloo
worlds against the JAX package's GSPMD step on the matching mesh of the
first two forced CPU devices (twins of ``tests/test_pjit_step.py`` and
``tests/test_fsdp.py``).

``lm_tiny`` in f32, JAX's sharded-at-birth init carried over with
``convert.params_from_flax``, two steps of 8 rows: ``tp`` on ``(data 1,
model 2)`` (Megatron halves), ``fsdp`` and ``dp`` on ``(data 2)``, and
``dp`` with ``ACCUM_STEPS=2``; loss, accuracy and gradient norm within
1e-5 relative, parameters within 1e-4 of the largest value
(``assert_step_matches``). ``ASYNC_COLLECTIVES`` on against off: the
same bits. The fused ResNet is refused without ``ALLOW_SYNC_BN``; the
rules tables and the logical axes are JAX's. (BatchNorm under pjit:
``test_torch_pjit_bn.py``; the dW+db route: ``test_torch_pjit_vit.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import assert_step_matches, jax_pjit, leaves, metrics_close, run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.models.sharding import logical_axes, rules_table
from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
from distributeddeeplearning_tpu_torch.training import create_optimizer
from distributeddeeplearning_tpu_torch.training.pjit_step import build_pjit_state

VOCAB, T, ROWS, SPE = 64, 16, 8, 10
LM = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=ROWS // 2,
          compute_dtype="float32", base_lr=0.5, warmup_epochs=1, weight_decay=1e-3,
          engine="pjit")
MODEL = dict(name="lm_tiny", kwargs=dict(max_seq_len=T))
DATA2, TP = (("data",), (2,)), (("data", "model"), (1, 2))
# name: (param_sharding, mesh, accum_steps)
MESHES = {"tp": ("tp", TP, 1), "fsdp": ("fsdp", DATA2, 1), "dp": ("dp", DATA2, 1),
          "dp_accum": ("dp", DATA2, 2)}
RN = dict(model="resnet18", num_classes=10, image_size=64, batch_size_per_device=4,
          compute_dtype="float32", base_lr=0.1, warmup_epochs=1,
          scale_lr_by_world_size=False)


def _rows(seed):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, VOCAB, size=(ROWS, T + 1)).astype(np.int32)
    return r[:, :-1], r[:, 1:]


DATA = [_rows(1), _rows(2)]


def _cfg(name):
    sharding, (axes, shape), k = MESHES[name]
    return dict(LM, param_sharding=sharding, mesh_axes=axes, mesh_shape=shape, accum_steps=k)


@pytest.fixture(scope="module")
def jax_runs():
    return {s: jax_pjit(_cfg(s), "lm_tiny", dict(max_seq_len=T), (1, T), jnp.int32, DATA, SPE)
            for s in MESHES}


@pytest.fixture(scope="module")
def port(jax_runs, tmp_path_factory):
    """The port's runs in one 2-rank world, by name (``tp_sync``: ``tp``
    with ``ASYNC_COLLECTIVES=0``)."""
    jobs = {s: dict(kind="step", cfg=_cfg(s), model=MODEL, batches=DATA, steps_per_epoch=SPE,
                    state=convert.params_from_flax(jax_runs[s][0][0]))
            for s in MESHES}
    jobs["tp_sync"] = dict(jobs["tp"], cfg=dict(jobs["tp"]["cfg"], async_collectives=False))
    out = run_world(list(jobs.values()), 2, tmp_path_factory.mktemp("pjit"))
    return dict(zip(jobs, out))


@pytest.mark.parametrize("sharding", list(MESHES))
def test_pjit_step_matches_jax(jax_runs, port, sharding):
    _, want_metrics, (want_params, _) = jax_runs[sharding]
    got = port[sharding]
    metrics_close(got["metrics"], want_metrics)
    assert_step_matches(want_params, convert.params_to_flax(got["state"]["model"]), rel=1e-4)


def test_async_collectives_on_and_off_same_bits(port):
    on, off = port["tp"], port["tp_sync"]
    assert on["metrics"] == off["metrics"]
    for k, v in on["state"]["model"].items():
        assert torch.equal(v, off["state"]["model"][k]), k


def test_optimizer_moments_take_their_parameters_layout(port):
    """The whole momentum trace gathers back in the dp model's order,
    shaped as the parameters."""
    for s in ("tp", "fsdp", "dp"):
        trace = port[s]["state"]["opt"]["trace"]
        model = port[s]["state"]["model"]
        names = [k for k in model if not k.endswith(("running_mean", "running_var"))]
        assert [tuple(t.shape) for t in trace] == [tuple(model[n].shape) for n in names]


def test_incapable_bn_models_refused_under_pjit():
    cfg = TrainConfig(**dict(RN, engine="pjit"))
    tx, _ = create_optimizer(cfg, SPE)
    fused = get_model("resnet50", num_classes=10, dtype=torch.float32, fused=True, device="cpu")
    assert not fused.per_replica_bn_capable
    with pytest.raises(ValueError, match="per_replica_bn_capable"):
        build_pjit_state(fused, cfg, tx, create_mesh(), device="cpu")
    assert get_model("resnet18", num_classes=10, device="meta").per_replica_bn_capable
    assert get_model("efficientnet_b0", num_classes=10, device="meta").per_replica_bn_capable


def test_rules_tables_match_jax():
    from distributeddeeplearning_tpu.models import sharding as jsh

    for name in ("tp", "fsdp", "dp"):
        assert rules_table(name) == jsh.rules_table(name)
    with pytest.raises(ValueError):
        rules_table("zero")


@pytest.mark.parametrize("model_name", ["lm_tiny", "vit_ti16", "lm_moe_tiny"])
def test_logical_axes_match_the_jax_models(model_name):
    """The port's logical axes per parameter, read off JAX's abstract
    init (``nn.get_partition_spec``), through the flax path and the
    port's layout (Dense and conv weights transposed; the MoE leaves keep
    flax's layout)."""
    import flax.linen as nn

    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu_torch.models.sharding import flax_path

    if model_name.startswith("lm_"):
        jm = jax_get_model(model_name, num_classes=VOCAB, max_seq_len=T)
        x = jnp.zeros((1, T), jnp.int32)
        pm = get_model(model_name, num_classes=VOCAB, max_seq_len=T, device="meta")
    else:
        jm = jax_get_model(model_name, num_classes=10)
        x = jnp.zeros((1, 32, 32, 3))
        pm = get_model(model_name, num_classes=10, image_size=32, device="meta")
    abstract = jax.eval_shape(lambda r: jm.init(r, x, train=False), jax.random.PRNGKey(0))
    specs = dict(leaves(jax.tree.map(lambda s: tuple(s), nn.get_partition_spec(abstract)["params"],
                                     is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
    for name, p in pm.named_parameters():
        path = "/".join(flax_path(name))
        want = tuple(specs[path]) if path in specs else ()
        got = logical_axes(name, p.dim())
        if name.endswith(".weight") and p.dim() == 2:  # Dense [out, in] vs kernel [in, out]
            got = got[::-1]
        elif name.endswith(".weight") and p.dim() == 4:  # conv OIHW vs HWIO
            got = (got[2], got[3], got[1], got[0])
        want = want + (None,) * (p.dim() - len(want))
        assert got == want, (name, got, want)
