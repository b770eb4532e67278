"""Two processes: the port's fused ResNet-50 train step in a 2-rank gloo
world, each rank with half of every global batch, against the JAX
package's dp step on a 2-device CPU mesh, from the same weights over
two batches. The ranks see different images, so their BatchNorm
statistics differ: the running statistics must come out as the mean
over the ranks (the JAX step's pmean), not as rank 0's, and the
gradients as the mean, not the sum. Tolerances:
``_torch_train_common.assert_step_matches``."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from _torch_train_common import CFG, STEPS_PER_EPOCH, assert_step_matches, batches, run_jax
from distributeddeeplearning_tpu_torch.models import convert

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_step_matches_jax_two_device_dp_step(tmp_path):
    data = batches(2, global_batch=WORLD * CFG["batch_size_per_device"])
    init, want_metrics, want_final = run_jax(True, WORLD, data)

    payload = {f"sd/{k}": v.numpy()
               for k, v in convert.resnet_params_from_flax(*init).items()}
    payload.update({f"cfg/{k}": np.asarray(v) for k, v in CFG.items()})
    payload["steps_per_epoch"] = np.asarray(STEPS_PER_EPOCH)
    for i, (images, labels) in enumerate(data):
        payload[f"images{i}"], payload[f"labels{i}"] = images, labels
    path_in, path_out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(path_in, **payload)

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_dp_worker.py"), str(r), str(WORLD),
         str(port), "1", str(path_in), str(path_out)],
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
    got_metrics = [{k: float(out[f"metric{i}/{k}"]) for k in ("loss", "accuracy", "grad_norm")}
                   for i in range(len(data))]
    sd = {k[3:]: out[k] for k in out if k.startswith("sd/")}
    import torch

    got_final = convert.resnet_params_to_flax({k: torch.from_numpy(v) for k, v in sd.items()})
    assert_step_matches(init, want_metrics, want_final, got_metrics, got_final)
