"""BatchNorm under the port's pjit engine against the JAX package's
(``models/norm.py`` ``per_replica_bn``, ``ALLOW_SYNC_BN``; twin of
``tests/test_pjit_step.py``'s ResNet cases): ResNet-18 at 64 px in f32,
8 images, from JAX's init and running statistics (``convert``), in a
2-rank gloo world against JAX on the matching mesh of the first two
forced CPU devices.

Per-replica statistics (the default) on ``(data 2)``, each rank its own
rows as the dp engine, and on ``(data 1, model 2)``, where the model
ranks of one data shard see the same rows and must count once, not be
averaged twice. (Sync BN: ``test_torch_pjit_sync_bn.py``.)

One step, as JAX's own oracle (``test_resnet_pjit_matches_dp_engine``):
the stem's max-pool routes its gradient by argmax, so round-off-level
differences of the forward flip near-ties from the second step on (the
port's one-rank dp step and JAX's one-device step part there too, by
6e-4 of the gradient norm). Limits: loss, accuracy and gradient norm
within 1e-5 relative; parameters and running statistics within 1e-4 of
the largest value of each (``assert_step_matches``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_common import assert_step_matches, jax_pjit, metrics_close, run_world
from distributeddeeplearning_tpu_torch.models import convert

SPE = 10
RN = dict(model="resnet18", num_classes=10, image_size=64, batch_size_per_device=4,
          compute_dtype="float32", base_lr=0.1, warmup_epochs=1,
          scale_lr_by_world_size=False, engine="pjit", param_sharding="dp")
# name: (mesh axes, mesh shape, allow_sync_bn)
CASES = {"per_replica_data2": (("data",), (2,), False),
         "per_replica_data1_model2": (("data", "model"), (1, 2), False),
         "sync_data2": (("data",), (2,), True)}
PER_REPLICA = ["per_replica_data2", "per_replica_data1_model2"]


def _images(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 64, 64, 3).astype(np.float32),
            rng.randint(0, 10, size=(8,)).astype(np.int32))


IMAGES = [_images(3)]


def _cfg(name):
    axes, shape, sync = CASES[name]
    return dict(RN, mesh_axes=axes, mesh_shape=shape, allow_sync_bn=sync)


def jax_runs_of(names):
    return {s: jax_pjit(_cfg(s), "resnet18", {}, (1, 64, 64, 3), jnp.float32, IMAGES, SPE)
            for s in names}


def port_runs_of(names, runs, tmp):
    """The port's steps of ``names`` in one 2-rank world, each from the
    initial state of its JAX run in ``runs`` (the first one's for a name
    ``runs`` lacks)."""
    first = next(iter(runs.values()))
    jobs = [dict(kind="step", cfg=_cfg(s), model=dict(name="resnet18"), batches=IMAGES,
                 steps_per_epoch=SPE,
                 state=convert.resnet_params_from_flax(*runs.get(s, first)[0]))
            for s in names]
    return dict(zip(names, run_world(jobs, 2, tmp)))


def assert_matches_jax(want, got):
    _, want_metrics, (want_params, want_stats) = want
    metrics_close(got["metrics"], want_metrics)
    got_params, got_stats = convert.resnet_params_to_flax(got["state"]["model"])
    assert_step_matches(want_params, got_params, rel=1e-4)
    assert_step_matches(want_stats, got_stats, rel=1e-4)


@pytest.fixture(scope="module")
def jax_runs():
    return jax_runs_of(PER_REPLICA)


@pytest.fixture(scope="module")
def port(jax_runs, tmp_path_factory):
    return port_runs_of(PER_REPLICA, jax_runs, tmp_path_factory.mktemp("pjit_bn"))


@pytest.mark.parametrize("name", PER_REPLICA)
def test_resnet_bn_under_pjit_matches_jax(jax_runs, port, name):
    assert_matches_jax(jax_runs[name], port[name])

