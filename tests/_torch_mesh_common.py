"""Shared helpers of the port's mesh-engine tests: a gloo world of the
port's ranks on the CPU (``_torch_mesh_worker.py``), the JAX meshes on
the suite's forced CPU devices, and the update comparison."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(jobs, world, tmp_path, timeout=240):
    """Run ``jobs`` on every rank of a ``world``-rank gloo world; rank
    0's results."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    path_in, path_out = tmp_path / "jobs.pt", tmp_path / "results.pt"
    torch.save({"jobs": jobs}, path_in)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"), str(r), str(world),
         str(port), str(path_in), str(path_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(path_out, weights_only=False)["results"]


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def assert_step_matches(want, got, rel=1e-4):
    """Parameters after a step within ``rel`` of the largest value (JAX's
    ``assert_step_matches``)."""
    pw, pg = dict(leaves(want)), dict(leaves(got))
    assert pw.keys() == pg.keys(), sorted(set(pw) ^ set(pg))
    scale = max(float(np.abs(v).max()) for v in pw.values())
    for k in pw:
        np.testing.assert_allclose(pg[k], pw[k], rtol=0, atol=rel * scale, err_msg=k)


def jax_pjit(cfg_kw, model_name, model_kw, input_shape, input_dtype, batches, steps_per_epoch,
             n_devices=2):
    """JAX's pjit steps (``TrainConfig(**cfg_kw)``, ``get_model(model_name,
    **model_kw)``) over the first ``n_devices`` forced CPU devices;
    (initial state, metrics, final state) as numpy, states ``(params,
    batch_stats)``."""
    import jax
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.pipeline import shard_batch
    from distributeddeeplearning_tpu.models import get_model as jax_get_model
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh as jax_mesh
    from distributeddeeplearning_tpu.parallel.mesh import dp_size
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import pjit_step as jps

    cfg = JaxConfig(**cfg_kw)
    mesh = jax_mesh(devices=jax.devices()[:n_devices], axes=cfg.mesh_axes, shape=cfg.mesh_shape)
    model = jax_get_model(model_name, **cfg.model_kwargs(), **model_kw)
    tx, _ = jax_opt(cfg, steps_per_epoch, world_size=dp_size(mesh))
    state = jps.build_pjit_state(model, cfg, tx, mesh, input_shape=input_shape,
                                 input_dtype=input_dtype)

    def host(st):
        return jax.tree.map(np.asarray, jax.device_get((st.params, st.batch_stats)))

    init = host(state)
    step = jps.make_pjit_train_step(model, tx, mesh, cfg, donate_state=False)
    metrics = []
    with mesh:
        for batch in batches:
            state, m = step(state, shard_batch(batch, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, host(state)


def metrics_close(got, want, rtol=1e-5):
    """Loss, accuracy and gradient norm of every step within ``rtol``
    relative (of at least 1)."""
    for g, w in zip(got, want):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= rtol * max(abs(w[k]), 1.0), (k, g[k], w[k])

