"""One rank of the port's data-parallel train step in a gloo world on the
CPU (driven by ``test_torch_train_step_dp.py``; imports no JAX).

    python _torch_dp_worker.py RANK WORLD PORT FUSED IN.npz OUT.npz

With ``FUSED`` = ``fit`` the rank runs ``training.loop.fit`` instead
(driven by ``test_torch_checkpoint_resume.py`` and
``test_torch_elastic_fit.py``): an ``lm_*`` model on the global
synthetic token stream (``length``, ``seq_len`` in ``IN.npz``), with the
``BroadcastGlobalVariablesCallback`` and the optimizer's LR world from
``lr_world_size`` when the config pins it (``LR_WORLD_SIZE``), else the
process group's; rank 0 writes each epoch's history
(``history<e>/<key>``), ``host_sync_count``, the host syncs by label
(``sync/<label>``), the final state dict and the optimizer's momentum
trace (``opt/<name>``, by parameter name).

``IN.npz`` holds the initial state dict (``sd/<name>``), the config
(``cfg/<field>``) and the global batches (``images<i>``, ``labels<i>``:
images, or ``[B, T]`` tokens for an ``lm_*`` model); rank 0 writes the
metrics of every step and the final state dict to ``OUT.npz``. For an
``efficientnet_*`` model every rank also writes its final state dict and
the dropout keep masks it drew (``mask<i>``, in order) to
``OUT_rank<r>.npz``.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import shard_batch
from distributeddeeplearning_tpu_torch.models import efficientnet, get_model
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)
from distributeddeeplearning_tpu_torch.utils import hostsync


def fit_main(rank, world, cfg, data, sd, path_out):
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.training import loop
    from distributeddeeplearning_tpu_torch.training.callbacks import (
        BroadcastGlobalVariablesCallback,
    )

    seq_len = int(data["seq_len"])
    ds = SyntheticTokenDataset(length=int(data["length"]), global_batch_size=cfg.global_batch_size,
                               seq_len=seq_len, vocab_size=cfg.num_classes, seed=cfg.seed,
                               process_index=rank, process_count=world, topology="global")
    model = get_model(cfg.model, num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                      max_seq_len=seq_len, device="cpu")
    tx, _ = create_optimizer(cfg, ds.steps_per_epoch, world_size=cfg.lr_world_size or world)
    state = create_train_state(model, cfg, tx, device="cpu", state_dict=sd)
    syncs0 = dict(hostsync.accountant().by_label)
    res = loop.fit(model, cfg, ds, device="cpu", tx=tx, state=state,
                   callbacks=[BroadcastGlobalVariablesCallback()], add_default_logger=False)
    out = {f"history{e}/{k}": np.float64(v) for e, h in enumerate(res.history)
           for k, v in h.items()}
    out["host_sync_count"] = np.float64(res.perf["host_sync_count"])
    out.update({f"sync/{k}": np.float64(v - syncs0.get(k, 0))
                for k, v in hostsync.accountant().by_label.items()})
    out.update({f"sd/{k}": v.numpy() for k, v in model.state_dict().items()})
    opt = res.state.opt_state
    trace = opt["trace"] if "trace" in opt else opt["inner"]["trace"]
    out.update({f"opt/{name}": t.numpy()
                for (name, _), t in zip(model.named_parameters(), trace)})
    if rank == 0:
        np.savez(path_out, **out)


def main(rank, world, port, fused, path_in, path_out):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    data = np.load(path_in)
    cfg = TrainConfig(**{k[4:]: v.item() for k, v in data.items() if k.startswith("cfg/")})
    sd = {k[3:]: torch.from_numpy(v) for k, v in data.items() if k.startswith("sd/")}
    if fused == "fit":
        fit_main(rank, world, cfg, data, sd, path_out)
        dist.barrier()
        dist.destroy_process_group()
        return
    masks = []
    if cfg.model.startswith("lm_"):
        kw = dict(attn_impl=cfg.attn_impl, max_seq_len=int(data["images0"].shape[1]))
    elif cfg.model.startswith("efficientnet_"):
        kw = {}
        draw = efficientnet.keep_mask

        def record(*args):
            masks.append(draw(*args))
            return masks[-1]

        efficientnet.keep_mask = record
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
    out.update({f"sd/{k}": v.numpy() for k, v in model.state_dict().items()})
    if rank == 0:
        np.savez(path_out, **out)
    if masks:
        out.update({f"mask{i:03d}": m.numpy() for i, m in enumerate(masks)})
        np.savez(path_out[:-len(".npz")] + f"_rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p, f, i, o = sys.argv[1:]
    main(int(r), int(w), int(p), f if f == "fit" else f == "1", i, o)
