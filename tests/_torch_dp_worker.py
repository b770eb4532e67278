"""One rank of the port's data-parallel train step in a gloo world on the
CPU (driven by ``test_torch_train_step_dp.py``; imports no JAX).

    python _torch_dp_worker.py RANK WORLD PORT FUSED IN.npz OUT.npz

``IN.npz`` holds the initial state dict (``sd/<name>``), the config
(``cfg/<field>``) and the global batches (``images<i>``, ``labels<i>``:
images, or ``[B, T]`` tokens for an ``lm_*`` model); rank 0 writes the
metrics of every step and the final state dict to ``OUT.npz``.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import shard_batch
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)


def main(rank, world, port, fused, path_in, path_out):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    data = np.load(path_in)
    cfg = TrainConfig(**{k[4:]: v.item() for k, v in data.items() if k.startswith("cfg/")})
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("sd/")}
    if cfg.model.startswith("lm_"):
        kw = dict(attn_impl=cfg.attn_impl, max_seq_len=int(data["images0"].shape[1]))
    else:
        kw = dict(fused=fused)
    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      device="cpu", **kw)
    tx, _ = create_optimizer(cfg, int(data["steps_per_epoch"]))  # world from the group
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
    step = make_train_step(model, tx, cfg, device="cpu")
    out = {}
    n = sum(1 for k in data if k.startswith("images"))
    for i in range(n):
        batch = shard_batch((data[f"images{i}"], data[f"labels{i}"]), rank, world)
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            out[f"metric{i}/{k}"] = np.float32(v)
    if rank == 0:
        out.update({f"sd/{k}": v.numpy() for k, v in model.state_dict().items()})
        np.savez(path_out, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p, f, i, o = sys.argv[1:]
    main(int(r), int(w), int(p), f == "1", i, o)
