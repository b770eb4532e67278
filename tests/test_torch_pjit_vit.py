"""The dW+db route (``FUSED_DENSE_GRAD=1``) under the port's pjit
engine against the JAX package's GSPMD step: ``vit_s16`` at 16 px
(one patch and the cls token) in f32, two steps of 8 images, ``xla``
attention, from JAX's init (``convert``), in a 2-rank gloo world against
JAX on the matching mesh of the first two forced CPU devices.

Each rank of the port runs its own tensors eagerly, so its
``FusedGradDense`` layers keep their dW+db route (on the CPU its plain
version, whose calls the worker counts): under ``fsdp`` on ``(data 2)``
all 49 of them (on the gathered weights), under ``tp`` on ``(data 1,
model 2)`` the head (the blocks' layers are the Megatron halves). JAX's
step takes the plain dense there, since the SPMD partitioner cannot
split a Pallas call; the numbers must agree (``tp``:
``test_torch_pjit_vit_tp.py``). Limits: loss, accuracy and
gradient norm within 1e-5 relative; parameters within 1e-4 of the
largest value (``assert_step_matches``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_common import assert_step_matches, jax_pjit, metrics_close, run_world
from distributeddeeplearning_tpu_torch.models import convert

SPE, PX = 10, 16
VIT = dict(model="vit_s16", num_classes=10, image_size=PX, batch_size_per_device=4,
           compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl="xla",
           engine="pjit")
MESHES = {"fsdp": (("data",), (2,)), "tp": (("data", "model"), (1, 2))}
DENSE_A_STEP = {"fsdp": 49, "tp": 1}


def _images(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, PX, PX, 3).astype(np.float32),
            rng.randint(0, 10, size=(8,)).astype(np.int32))


IMAGES = [_images(5), _images(6)]


def _cfg(name):
    axes, shape = MESHES[name]
    return dict(VIT, param_sharding=name, mesh_axes=axes, mesh_shape=shape)


def jax_runs_of(names):
    old = os.environ.get("FUSED_DENSE_GRAD")
    os.environ["FUSED_DENSE_GRAD"] = "1"  # read where each Dense is built
    try:
        return {s: jax_pjit(_cfg(s), "vit_s16", {}, (1, PX, PX, 3), jnp.float32, IMAGES, SPE)
                for s in names}
    finally:
        if old is None:
            del os.environ["FUSED_DENSE_GRAD"]
        else:
            os.environ["FUSED_DENSE_GRAD"] = old


def port_runs_of(runs, tmp):
    """The port's steps of every run of ``runs`` in one 2-rank world."""
    model = dict(name="vit_s16", kwargs=dict(image_size=PX, attn_impl="xla",
                                             fused_dense_grad=True))
    jobs = [dict(kind="step", cfg=_cfg(s), model=model, batches=IMAGES, steps_per_epoch=SPE,
                 state=convert.vit_params_from_flax(runs[s][0][0]), count_dw_db=True)
            for s in runs]
    return dict(zip(runs, run_world(jobs, 2, tmp)))


def assert_matches_jax(sharding, want, got):
    _, want_metrics, (want_params, _) = want
    assert got["dw_db_calls"] == DENSE_A_STEP[sharding] * len(IMAGES)
    metrics_close(got["metrics"], want_metrics)
    assert_step_matches(want_params, convert.vit_params_to_flax(got["state"]["model"]),
                        rel=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = jax_runs_of(["fsdp"])
    return want, port_runs_of(want, tmp_path_factory.mktemp("pjit_vit"))


def test_fused_grad_dense_under_pjit_fsdp_matches_jax(runs):
    want, got = runs
    assert_matches_jax("fsdp", want["fsdp"], got["fsdp"])
