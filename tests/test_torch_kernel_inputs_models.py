"""The model level of the kernel inputs JAX takes and the port's fast
kernels refuse: models at those head dims and dtypes, the port on the
CPU (its kernels' plain versions) against the JAX package (its Pallas
kernels in interpret mode) from the same converted weights.

* A 2-layer LM with head dim 96 (hidden 192, 2 heads: lm_large's head
  dim) served paged with the fused decode kernel: the greedy streams of
  the JAX ``Server`` and the port's, token for token, and the same
  allocator decisions (``test_torch_serving.py``'s exactness: f32
  logits agree to round-off, far inside a random model's top-two gap).
* A 2-layer ViT with head dim 80 (width 160, 2 heads: ViT-H/16's head
  dim) with ``attn_impl="pallas"``, 8-pixel patches at 16 px, one f32
  train step against JAX's dp step; and ``vit_ti`` with
  ``attn_impl="auto"`` at f32 (on the CPU both packages resolve it to
  the einsum path), one step. Limits: ``test_torch_vit_train.py``'s
  (loss, accuracy and gradient norm within 1e-5 relative; updates
  within 2e-4 of their norm per parameter, 2e-5 in all).

The width-160 and hidden-192 models are registered for the test only,
in both packages' variant tables (``monkeypatch.setitem``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vit_train import _leaves

from distributeddeeplearning_tpu.models import transformer_lm as jax_lm
from distributeddeeplearning_tpu.models import vit as jax_vit
from distributeddeeplearning_tpu.serving import Request as JaxRequest
from distributeddeeplearning_tpu.serving import Server as JaxServer
from distributeddeeplearning_tpu.serving import SlotEngine as JaxEngine
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticImageDataset
from distributeddeeplearning_tpu_torch.models import convert
from distributeddeeplearning_tpu_torch.models import transformer_lm as port_lm
from distributeddeeplearning_tpu_torch.models import vit as port_vit
from distributeddeeplearning_tpu_torch.ops import flash
from distributeddeeplearning_tpu_torch.serving import Request, Server, SlotEngine
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)

VOCAB, MAX_LEN, BUCKETS = 64, 32, (8, 16)
LM_D96 = (192, 2, 2, 384)  # hidden, depth, heads, mlp: head dim 96
VIT_D80 = (160, 2, 2, 320)  # width 160, 2 heads: head dim 80
CLASSES, BATCH = 10, 4


@pytest.fixture(autouse=True)
def _variants(monkeypatch):
    """Register the test's widths in both packages' variant tables."""
    for table in (jax_lm._VARIANTS, port_lm._VARIANTS):
        monkeypatch.setitem(table, "d96", LM_D96)
    for table in (jax_vit._VARIANTS, port_vit._VARIANTS):
        monkeypatch.setitem(table, "d80", VIT_D80)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serve(server_cls, request_cls, engine, reqs):
    server = server_cls(engine, prefills_per_step=1)
    handles = [server.submit(request_cls(prompt=p, max_new_tokens=m)) for p, m in reqs]
    server.drain()
    assert all(h.status == "done" for h in handles)
    return [list(h.new_tokens) for h in handles]


def test_head_dim_96_lm_served_paged_fused_matches_jax_streams():
    model = jax_lm.TransformerLM(variant="d96", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                                 dtype=jnp.float32)
    params = fnn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((2, MAX_LEN), jnp.int32),
                                  train=False)["params"])
    rng = np.random.RandomState(96)
    shared = rng.randint(0, VOCAB, size=8).astype(np.int32)
    reqs = [(rng.randint(0, VOCAB, size=n).astype(np.int32), m) for n, m in ((3, 6), (12, 4))]
    reqs += [(np.concatenate([shared, rng.randint(0, VOCAB, size=3).astype(np.int32)]), 7),
             (np.concatenate([shared, rng.randint(0, VOCAB, size=5).astype(np.int32)]), 5)]
    kw = dict(kv_layout="paged", block_size=4, decode_kernel="fused")
    jax_engine = JaxEngine(model, params, num_slots=3, max_len=MAX_LEN, buckets=BUCKETS, **kw)
    want = _serve(JaxServer, JaxRequest, jax_engine, reqs)
    port_model = port_lm.TransformerLM("d96", vocab_size=VOCAB, max_seq_len=MAX_LEN,
                                       dtype=torch.float32, device="cpu")
    assert port_model.blocks[0].attn.head_dim == 96
    port_engine = SlotEngine(port_model, convert.params_from_flax(params), num_slots=3,
                             max_len=MAX_LEN, buckets=BUCKETS, device="cpu", **kw)
    got = _serve(Server, Request, port_engine, reqs)
    assert got == want
    assert [len(t) for t in got] == [m for _, m in reqs]
    assert port_engine.allocator.snapshot() == jax_engine.allocator.snapshot()
    assert port_engine.allocator.stats["prefix_hit_requests"] >= 1


def _vit_cfg(cls, size, impl):
    return cls(model="vit", num_classes=CLASSES, image_size=size, batch_size_per_device=BATCH,
               compute_dtype="float32", base_lr=0.5, warmup_epochs=1, attn_impl=impl)


def _vit_step_both(variant, patch, size, impl):
    """One f32 dp step of JAX's ViT (1-device mesh) and of the port's from
    JAX's initial weights on the same batch: (initial, JAX and port
    metrics and parameters)."""
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.pipeline import shard_batch
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import make_train_step as jax_step
    from distributeddeeplearning_tpu.training.train_step import replicate_state

    batch = next(iter(SyntheticImageDataset(length=BATCH, global_batch_size=BATCH,
                                            image_size=size, num_classes=CLASSES,
                                            num_physical_batches=1, seed=3).epoch(0)))
    cfg = _vit_cfg(JaxConfig, size, impl)
    model = jax_vit.ViT(variant=variant, patch_size=patch, num_classes=CLASSES,
                        dtype=jnp.float32, attn_impl=impl)
    tx, _ = jax_opt(cfg, 10, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, size, size, 3))
    init = jax.tree.map(np.asarray, fnn.unbox(state.params))
    mesh = create_mesh(devices=jax.devices()[:1])
    step = jax_step(model, tx, mesh, cfg, donate_state=False, check_vma=False)
    state, m = step(replicate_state(state, mesh), shard_batch(batch, mesh))
    want_m = {k: float(v) for k, v in m.items()}
    want = jax.tree.map(np.asarray, fnn.unbox(state.params))

    pcfg = _vit_cfg(TrainConfig, size, impl)
    pmodel = port_vit.ViT(variant=variant, patch_size=patch,
                          **dict(pcfg.model_kwargs(), dtype=pcfg.torch_dtype), device="cpu")
    ptx, _ = create_optimizer(pcfg, 10, world_size=1)
    pstate = create_train_state(pmodel, pcfg, ptx, device="cpu",
                                state_dict=convert.vit_params_from_flax(init))
    pstate, pm = make_train_step(pmodel, ptx, pcfg, device="cpu")(pstate, batch)
    return (init, want_m, want, {k: float(v) for k, v in pm.items()},
            convert.vit_params_to_flax(pmodel.state_dict()), pmodel)


def _assert_step_matches(init, want_m, want, got_m, got):
    for k in ("loss", "accuracy", "grad_norm"):
        assert abs(got_m[k] - want_m[k]) <= 1e-5 * max(abs(want_m[k]), 1.0), (k, got_m, want_m)
    p0, pw, pg = dict(_leaves(init)), dict(_leaves(want)), dict(_leaves(got))
    assert pw.keys() == pg.keys() == p0.keys()
    num = den = 0.0
    for k in pw:
        dw, dg = pw[k] - p0[k], pg[k] - p0[k]
        e = np.linalg.norm(dg - dw)
        assert e <= 2e-4 * np.linalg.norm(dw) + 2 ** -23 * np.linalg.norm(p0[k]), k
        num, den = num + e * e, den + np.sum(dw * dw)
    assert np.sqrt(num) <= 2e-5 * np.sqrt(den)


def test_head_dim_80_vit_pallas_step_matches_jax():
    before = dict(flash.launches_by_op)
    init, want_m, want, got_m, got, model = _vit_step_both("d80", 8, 16, "pallas")
    assert model.blocks[0].attn.head_dim == 80
    # on the CPU the wrapper runs the plain versions and launches nothing
    assert flash.launches_by_op == before
    _assert_step_matches(init, want_m, want, got_m, got)


def test_f32_vit_auto_step_matches_jax():
    init, want_m, want, got_m, got, model = _vit_step_both("ti", 16, 32, "auto")
    assert model.blocks[0].attn._resolve_impl(torch.zeros(1, 5, 192), 64) == "xla"
    _assert_step_matches(init, want_m, want, got_m, got)
