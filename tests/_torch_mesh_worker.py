"""One rank of a gloo world on the CPU running the port's mesh engines
(driven by ``tests/test_torch_{mesh,pjit,sp,pp,engines}.py``; imports
no JAX).

    python _torch_mesh_worker.py RANK WORLD PORT IN.pt OUT.pt

``IN.pt`` holds ``{"jobs": [job, ...]}``; every rank runs every job in
order, and rank 0 writes ``{"results": [result, ...]}`` to ``OUT.pt``.
A job is a dict with ``kind``:

* ``step`` — ``cfg`` (``TrainConfig`` fields), ``model`` (``get_model``
  name and kwargs), ``state`` (the whole dp state dict to start from;
  for ``pp`` the list of the stages' state dicts), ``batches`` (global
  ``(inputs, labels)``), ``steps_per_epoch`` (and ``lr_world``, the
  schedule's world, default the batch shards): each rank steps on its
  data shard through ``engines.build_engine``; the result holds the
  metrics of every step and the whole state after them
  (``checkpoint._payload``: the dp model's names, stages stacked);
  with ``count_dw_db`` also ``dw_db_calls``, the calls of the dW+db
  route (``ops/fused_grads.matmul_dw_db``) over the steps.
* ``ring`` — ``q``, ``k``, ``v``, ``dout`` (global ``[B, T, H, d]``),
  ``causal``: ring attention over a ``seq`` mesh of the world; the
  whole output and gradients.
* ``collectives`` — the collectives on fixed inputs over the world.
* ``mesh`` — ``axes``, ``shape``: every rank's coordinates and groups.
* ``fit`` — ``cfg``, ``model``, ``data`` (``SyntheticTokenDataset``
  kwargs), ``model_dir``, ``epochs``: ``loop.fit`` with checkpoints and
  ``VALIDATION`` through ``evaluate``; the history and whole state.
* ``ckpt`` — ``model``, ``batch``, ``steps_per_epoch``, ``dir`` and
  ``runs`` (each ``cfg`` and ``save``): each run builds its engine from
  the seeded init, then either steps once on ``batch`` and saves
  through ``CheckpointManager`` (JAX's manifest) or restores the newest
  key; each run's whole state.
* ``layout_error`` — ``cfg``, ``model``: the error ``build_pjit_state``
  raises, as a string.

A ``step`` job with ``replicas`` (mesh axis names) also reports, in
``replicas_agree``, whether the parameters the layout does not split
are bitwise equal across the ranks of each of those axes after the
steps.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh, create_hybrid_mesh
from distributeddeeplearning_tpu_torch.training import checkpoint, create_optimizer, engines
from distributeddeeplearning_tpu_torch.training import pjit_step, pp_step
from distributeddeeplearning_tpu_torch.training.state import create_train_state


def _model(cfg, spec):
    kw = dict(spec.get("kwargs", {}))
    return get_model(spec["name"], num_classes=cfg.num_classes, dtype=cfg.compute_dtype,
                     device="cpu", **kw)


def _state(model, cfg, tx, mesh, job):
    sd = job.get("state")
    if cfg.engine == "pjit":
        return model, pjit_step.build_pjit_state(model, cfg, tx, mesh, device="cpu",
                                                 state_dict=sd)
    if cfg.engine == "pp":
        pl = engines.adapt_model(model, "pp", mesh, cfg, "cpu")
        stage_sd = None if sd is None else sd[mesh.coords["pipe"]]
        return pl, pp_step.create_pp_state(pl, cfg, tx, mesh, device="cpu",
                                           state_dict=stage_sd)
    if cfg.engine == "sp":
        model = engines.adapt_model(model, "sp", mesh, cfg, "cpu")
    return model, create_train_state(model, cfg, tx, device="cpu", state_dict=sd)


def step_job(job):
    if not job.get("count_dw_db"):
        return _step_job(job)
    from distributeddeeplearning_tpu_torch.ops import fused_grads

    calls = [0]
    plain = fused_grads.matmul_dw_db

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    fused_grads.matmul_dw_db = counted
    try:
        out = _step_job(job)
    finally:
        fused_grads.matmul_dw_db = plain
    return dict(out, dw_db_calls=calls[0])


def _step_job(job):
    cfg = TrainConfig(**job["cfg"])
    mesh = engines.resolve_mesh(cfg)
    model = _model(cfg, job["model"])
    width = collectives.size() if mesh is None else engines.dp_size(mesh)
    tx, _ = create_optimizer(cfg, job["steps_per_epoch"], world_size=job.get("lr_world", width))
    model, state = _state(model, cfg, tx, mesh, job)
    eng = engines.build_engine(model, cfg, tx, state=state, device="cpu", mesh=mesh)
    index, count = eng.batch_shard()
    metrics = []
    for batch in job["batches"]:
        n = batch[0].shape[0] // count
        local = tuple(torch.as_tensor(np.asarray(x[index * n:(index + 1) * n])) for x in batch)
        state, m = eng.train_step(eng.state, local)
        eng.state = state
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "state": checkpoint._payload(eng.state)}
    if job.get("replicas"):
        out["replicas_agree"] = {a: state.layout.replicas_agree(mesh.group(a))
                                 for a in job["replicas"]}
    if job.get("eval") is not None:
        batch = job["eval"]
        n = batch[0].shape[0] // count
        local = tuple(torch.as_tensor(np.asarray(x[index * n:(index + 1) * n])) for x in batch)
        out["eval"] = {k: float(v) for k, v in eng.eval_step(eng.state, local).items()}
    return out


def ring_job(job):
    from distributeddeeplearning_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ring_axis,
    )

    mesh = create_mesh(axes=("seq",))
    n, i = mesh.shape["seq"], mesh.coords["seq"]
    t = job["q"].shape[1] // n
    part = [torch.as_tensor(job[x][:, i * t:(i + 1) * t]).clone().requires_grad_()
            for x in ("q", "k", "v")]
    with ring_axis(mesh.group("seq")):
        out = ring_attention(*part, causal=job["causal"])
    out.backward(torch.as_tensor(job["dout"][:, i * t:(i + 1) * t]))
    grp = mesh.group("seq")
    return {"out": collectives.all_gather(out.detach(), grp, 1),
            **{f"d{x}": collectives.all_gather(p.grad, grp, 1)
               for x, p in zip("qkv", part)}}


def collectives_job(job):
    r, w = collectives.rank(), collectives.size()
    world = dist.group.WORLD
    res = {}
    g = [torch.full((3,), float(r + 1)), torch.full((2, 2), float(10 * r))]
    res["mean"] = collectives.allreduce_gradients(g, world)
    res["sum"] = collectives.allreduce_sum(g, world)
    res["metrics"] = collectives.allreduce_metrics({"loss": torch.tensor(float(r))}, world)
    mesh = create_hybrid_mesh(2, axes=("data",)) if w % 2 == 0 else None
    if mesh is not None:
        res["hier"] = collectives.hierarchical_allreduce_gradients(
            g, mesh.group("data"), mesh.group("replica"))
    x = torch.full((2,), float(r + 1), requires_grad=True)
    collectives.psum_keepgrad(x, world).sum().backward()
    res["psum_keepgrad_grad"] = x.grad
    x = torch.full((2,), float(r + 1), requires_grad=True)
    (collectives.copy_to_group(x, world) * (r + 1)).sum().backward()
    res["copy_grad"] = x.grad
    x = torch.full((2,), float(r + 1), requires_grad=True)
    (collectives.sum_both_ways(x, world) * (r + 1)).sum().backward()
    res["both_grad"] = x.grad
    x = torch.full((1, 2), float(r + 1), requires_grad=True)
    y = collectives.all_gather_keepgrad(x, world, 0)
    (y * torch.arange(float(w))[:, None]).sum().backward()
    res["gather_keepgrad"], res["gather_keepgrad_grad"] = y.detach(), x.grad
    res["gather"] = collectives.all_gather(torch.full((1, 2), float(r)), world, 0)
    res["scatter"] = collectives.reduce_scatter(torch.arange(2.0 * w).reshape(w, 2) * (r + 1),
                                                world, 0)
    buf = torch.empty(3)
    collectives.exchange([(torch.full((3,), float(r)), (r + 1) % w)], [(buf, (r - 1) % w)])
    res["exchange"] = buf
    res["bcast"] = collectives.broadcast_from_master({"r": r})
    res["host"] = collectives.allreduce_host_scalar(float(r))
    every = [None] * w
    dist.all_gather_object(every, res)
    return every


def mesh_job(job):
    mesh = (create_hybrid_mesh(job["slices"], axes=job["axes"], shape=job.get("shape"))
            if job.get("slices") else create_mesh(axes=job["axes"], shape=job.get("shape")))
    mine = {"coords": mesh.coords, "shape": mesh.shape, "devices": mesh.devices.tolist(),
            "groups": {",".join(a): (None if mesh.group(a) is None else
                                     dist.get_process_group_ranks(mesh.group(a)))
                       for a in job.get("groups", [])}}
    every = [None] * collectives.size()
    dist.all_gather_object(every, mine)
    return every


def fit_job(job):
    from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
    from distributeddeeplearning_tpu_torch.training import loop

    cfg = TrainConfig(**job["cfg"])
    mesh = engines.resolve_mesh(cfg)
    index, count = (collectives.rank(), collectives.size()) if mesh is None else \
        engines.batch_sharding(mesh)
    data = dict(job["data"], global_batch_size=cfg.global_batch_size)
    ds = SyntheticTokenDataset(**data, process_index=index, process_count=count,
                               topology="global")
    val = SyntheticTokenDataset(**dict(data, seed=data.get("seed", 0) + 1),
                                process_index=index, process_count=count, topology="global")
    model = _model(cfg, job["model"])
    res = loop.fit(model, cfg, ds, device="cpu", mesh=mesh, epochs=job["epochs"],
                   eval_data=val, add_default_logger=False)
    model = res.state.model
    ev = loop.evaluate(model, cfg, val, res.state, device="cpu", mesh=mesh)
    return {"history": res.history, "state": checkpoint._payload(res.state), "eval": ev,
            "step": res.state.step}


def ckpt_job(job):
    out = []
    for run in job["runs"]:
        cfg = TrainConfig(**run["cfg"])
        mesh = engines.resolve_mesh(cfg)
        width = collectives.size() if mesh is None else engines.dp_size(mesh)
        tx, _ = create_optimizer(cfg, job["steps_per_epoch"], world_size=width)
        model, state = _state(_model(cfg, job["model"]), cfg, tx, mesh, {})
        eng = engines.build_engine(model, cfg, tx, state=state, device="cpu", mesh=mesh)
        mgr = checkpoint.CheckpointManager(job["dir"])
        if run["save"]:
            index, count = eng.batch_shard()
            batch = job["batch"]
            n = batch[0].shape[0] // count
            local = tuple(torch.as_tensor(np.asarray(x[index * n:(index + 1) * n]))
                          for x in batch)
            state, _ = eng.train_step(eng.state, local)
            mgr.save(0, state, force=True, manifest=checkpoint.build_manifest(
                global_step=state.step, steps_per_epoch=job["steps_per_epoch"],
                effective_batch=batch[0].shape[0]))
        else:
            state = mgr.restore(eng.state)
        mgr.wait()
        mgr.close()
        out.append(checkpoint._payload(state))
    return out


def layout_error_job(job):
    cfg = TrainConfig(**job["cfg"])
    mesh = engines.resolve_mesh(cfg)
    tx, _ = create_optimizer(cfg, 10)
    try:
        pjit_step.build_pjit_state(_model(cfg, job["model"]), cfg, tx, mesh, device="cpu")
    except ValueError as e:
        return str(e)
    return None


KINDS = {"step": step_job, "ckpt": ckpt_job, "layout_error": layout_error_job,
         "ring": ring_job, "collectives": collectives_job,
         "mesh": mesh_job, "fit": fit_job}


def main():
    rank, world, port, path_in, path_out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    jobs = torch.load(path_in, weights_only=False)["jobs"]
    results = []
    for job in jobs:
        results.append(KINDS[job["kind"]](job))
    if rank == 0:
        torch.save({"results": results}, path_out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
