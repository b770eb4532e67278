"""The port's rank mesh and collectives (``parallel/mesh.py``,
``parallel/collectives.py``; twins of ``tests/test_collectives.py``).

Mesh shapes and the ``-1`` wildcard as JAX's ``MeshConfig``; in a
4-rank gloo world the row-major layout of ``(data, model)``, axes-only
and hybrid (``replica``) meshes against JAX's meshes over the first four
forced CPU devices (device ids for ranks), each rank's coordinates and
the members of its axis groups; the collectives' values on fixed inputs
(means and sums, the hierarchical mean equal to the flat one, the
autograd-aware sums' gradients and the gather whose gradient is the
rank's slice, gather, reduce-scatter, point to point,
broadcast), exact.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_common import run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import (
    MeshConfig,
    batch_axes,
    batch_sharding,
    create_mesh,
    dp_size,
    mesh_from_config,
)

W = 4
MESHES = [
    dict(kind="mesh", axes=("data", "model"), shape=(2, 2),
         groups=[("data",), ("model",), ("data", "model")]),
    dict(kind="mesh", axes=("data", "seq"), groups=[("seq",), ("data",)]),
    dict(kind="mesh", axes=("data",), slices=2, groups=[("replica",), ("data",),
                                                        ("replica", "data")]),
    dict(kind="mesh", axes=("data", "pipe"), shape=(-1, 2), groups=[("pipe",)]),
    dict(kind="mesh", axes=("data", "expert"), shape=(2, 2),
         groups=[("expert",), ("data",), ("data", "expert")]),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(MESHES + [dict(kind="collectives")], W, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("axes,shape,n", [(("data",), (-1,), 8), (("data", "model"), (-1, 2), 8),
                                          (("data", "model", "pipe"), (2, -1, 2), 8)])
def test_mesh_wildcard_resolution_matches_jax(axes, shape, n):
    from distributeddeeplearning_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    assert MeshConfig(axes, shape).resolve_shape(n) == JaxMeshConfig(axes, shape).resolve_shape(n)


@pytest.mark.parametrize("axes,shape", [(("data",), (3,)), (("data", "model"), (-1, -1)),
                                        (("data", "model"), (2,)), (("data", "model"), (-1, 3))])
def test_mesh_bad_shapes_raise(axes, shape):
    from distributeddeeplearning_tpu.parallel.mesh import MeshConfig as JaxMeshConfig

    with pytest.raises(ValueError):
        JaxMeshConfig(axes, shape).resolve_shape(8)
    with pytest.raises(ValueError):
        MeshConfig(axes, shape).resolve_shape(8)


def test_single_process_mesh():
    mesh = create_mesh()
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    assert mesh.group("data") is None and dp_size(mesh) == 1 and batch_sharding(mesh) == (0, 1)
    cfg = TrainConfig(engine="pjit", mesh_axes=("data", "model"))
    assert mesh_from_config(cfg).shape == {"data": 1, "model": 1}
    assert collectives.rank() == 0 and collectives.size() == 1 and collectives.is_master()
    assert collectives.local_rank() == 0 and collectives.local_size() == 1
    assert collectives.num_processes() == 1
    assert collectives.broadcast_from_master({"a": 1}) == {"a": 1}
    assert collectives.allreduce_host_scalar(3.0) == 3.0
    g = [torch.ones(2)]
    assert collectives.allreduce_gradients(g, None)[0] is g[0]


def test_expert_axis_and_replica_without_shape_refused():
    """An 'expert' axis is a mesh axis like the others; what still raises
    is an expert count it does not divide (named with both numbers) and
    a replica axis whose slice count nothing gives."""
    mesh = create_mesh(axes=("data", "expert"))
    assert mesh.shape == {"data": 1, "expert": 1} and batch_axes(mesh) == ("data",)
    with pytest.raises(ValueError, match="8 experts do not split over expert=3"):
        TrainConfig(engine="pjit", mesh_axes=("data", "expert"), mesh_shape=(1, 3),
                    moe_experts=8)
    with pytest.raises(ValueError, match="slice count"):
        mesh_from_config(TrainConfig(mesh_axes=("replica", "data")))


def _jax_devices(idx, kind):
    from distributeddeeplearning_tpu.parallel.mesh import create_hybrid_mesh, create_mesh as cm

    devs = jax.devices()[:W]
    job = MESHES[idx]
    if job.get("slices"):
        mesh = create_hybrid_mesh(job["slices"], axes=job["axes"], devices=devs)
    else:
        mesh = cm(devices=devs, axes=job["axes"], shape=job.get("shape"))
    ids = np.vectorize(lambda d: d.id - devs[0].id)(mesh.devices)
    return ids.tolist(), dict(mesh.shape)


@pytest.mark.parametrize("idx", range(len(MESHES)))
def test_mesh_layout_matches_jax(world, idx):
    every = world[idx]
    want_devices, want_shape = _jax_devices(idx, None)
    for rank, got in enumerate(every):
        assert got["devices"] == want_devices
        assert got["shape"] == want_shape
        coords = np.argwhere(np.asarray(want_devices) == rank)[0]
        assert list(got["coords"].values()) == list(coords)
        names = list(got["shape"])
        for axes, members in got["groups"].items():
            axes = axes.split(",")
            live = [a for a in axes if want_shape[a] > 1]
            if not live:
                assert members is None
                continue
            same = [r for r in range(W)
                    if all(np.argwhere(np.asarray(want_devices) == r)[0][names.index(a)]
                           == coords[names.index(a)] for a in names if a not in live)]
            assert members == sorted(same), (axes, rank)


def test_collectives_values(world):
    every = world[len(MESHES)]
    ranks = np.arange(W)
    for r, res in enumerate(every):
        assert torch.equal(res["mean"][0], torch.full((3,), float(np.mean(ranks + 1))))
        assert torch.equal(res["mean"][1], torch.full((2, 2), float(np.mean(10 * ranks))))
        assert torch.equal(res["sum"][0], torch.full((3,), float(np.sum(ranks + 1))))
        assert float(res["metrics"]["loss"]) == float(np.mean(ranks))
        for a, b in zip(res["hier"], res["mean"]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        # psum_keepgrad: the gradient passes through as it is (the broadcast)
        assert torch.equal(res["psum_keepgrad_grad"], torch.ones(2))
        # copy_to_group and sum_both_ways: each rank's upstream (r + 1) summed
        assert torch.equal(res["copy_grad"], torch.full((2,), float(np.sum(ranks + 1))))
        assert torch.equal(res["both_grad"], torch.full((2,), float(np.sum(ranks + 1))))
        # all_gather_keepgrad: every rank's row, and back this rank's slice
        # of the (same on every rank) upstream
        assert torch.equal(res["gather_keepgrad"], torch.tensor(ranks + 1.0)[:, None]
                           .expand(W, 2))
        assert torch.equal(res["gather_keepgrad_grad"], torch.full((1, 2), float(r)))
        assert torch.equal(res["gather"], torch.tensor(ranks, dtype=torch.float32)[:, None]
                           .expand(W, 2))
        full = sum(torch.arange(2.0 * W).reshape(W, 2) * (q + 1) for q in ranks)
        assert torch.equal(res["scatter"], full[r:r + 1])
        assert torch.equal(res["exchange"], torch.full((3,), float((r - 1) % W)))
        assert res["bcast"] == {"r": 0}
        assert res["host"] == float(np.mean(ranks))
