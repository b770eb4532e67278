"""Two processes: the port's ``lm_tiny`` train step with
``attn_impl="pallas"`` (f32, the flash path's plain versions on the CPU)
in a 2-rank gloo world, each rank with half of every global batch of
tokens, against the JAX package's dp step on a 2-device CPU mesh (the
Pallas kernel in interpret mode), from the same weights over two
batches: the gradients must come out as the mean over the ranks.
Tolerances: ``test_torch_lm_train.py``'s for one device (metrics 1e-5
relative, updates 2e-4 per parameter and 2e-5 together); measured
metrics 1.6e-7, updates 8.0e-6 per parameter and 9.7e-7 together. A
summed instead of averaged gradient moves the updates by 100 %.
(``test_torch_train_step_dp.py`` holds the ResNet step the same way.)"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from test_torch_lm_train import (  # noqa: F401 (jax_lm is a fixture)
    BATCH,
    CFG,
    STEPS_PER_EPOCH,
    _data,
    assert_updates_close,
    jax_lm,
    run_jax,
)
from test_torch_train_step_dp import _free_port
from distributeddeeplearning_tpu_torch.models import convert

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2


def run_ranks(params, data, tmp_path):
    """The port's step in a 2-rank gloo world: metrics per step and the
    final flax tree."""
    payload = {f"sd/{k}": v.numpy() for k, v in convert.params_from_flax(params).items()}
    payload.update({f"cfg/{k}": np.asarray(v) for k, v in CFG.items()})
    payload["steps_per_epoch"] = np.asarray(STEPS_PER_EPOCH)
    for i, (tokens, labels) in enumerate(data):
        payload[f"images{i}"], payload[f"labels{i}"] = tokens, labels
    path_in, path_out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(path_in, **payload)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"), str(r), str(WORLD),
         str(port), "0", str(path_in), str(path_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    out = np.load(path_out)
    metrics = [{k: float(out[f"metric{i}/{k}"]) for k in ("loss", "accuracy", "grad_norm")}
               for i in range(len(data))]
    sd = {k[3:]: torch.from_numpy(out[k]) for k in out if k.startswith("sd/")}
    return metrics, convert.params_to_flax(sd)


def test_two_rank_gloo_lm_step_matches_jax_two_device_dp_step(jax_lm, tmp_path):
    _, params = jax_lm
    data = _data(2, WORLD * BATCH, seed=2)
    want_metrics, want_params = run_jax(params, data, world=WORLD)

    got_metrics, got_params = run_ranks(params, data, tmp_path)
    for w, g in zip(want_metrics, got_metrics):
        for k in ("loss", "accuracy", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * max(abs(w[k]), 1.0), (k, g[k], w[k])
    init = jax.tree.map(np.asarray, params)
    assert_updates_close(init, want_params, got_params, per_leaf=2e-4, total=2e-5)
