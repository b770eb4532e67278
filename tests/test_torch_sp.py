"""The port's sequence parallelism (``parallel/ring_attention.py``,
``training/sp_step.py``) in 2-rank gloo worlds against the JAX
package's, on the first two forced CPU devices.

* Ring attention, causal and not, f32 ``[2, 32, 4, 16]`` over a 2-rank
  ``seq`` ring: the output and dQ, dK, dV (the hand-written reverse
  ring) against JAX's ring under ``shard_map`` and ``jax.grad`` and
  against plain attention (``_xla_attention``), within 1e-5 (the same f32
  sums in another order; a causal block masked in local instead of
  global coordinates moves them by O(1)).
* The sp step, ``lm_tiny`` f32 on ``(data 1, seq 2)``, two steps from
  JAX's init: loss, accuracy and gradient norm within 1e-5 relative,
  parameters within 1e-4 of the largest value, against JAX's
  ``make_sp_train_step`` on the same mesh; the step's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_common import assert_step_matches, run_world
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.ops.attention import dot_product_attention
from distributeddeeplearning_tpu_torch.parallel.mesh import create_mesh
from distributeddeeplearning_tpu_torch.training import create_optimizer
from distributeddeeplearning_tpu_torch.training.pjit_step import layout_model
from distributeddeeplearning_tpu_torch.training.sp_step import make_sp_train_step

VOCAB, T, ROWS, SPE = 64, 32, 4, 10
CFG = dict(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=ROWS,
           compute_dtype="float32", base_lr=0.5, warmup_epochs=1, weight_decay=1e-3,
           engine="sp", mesh_axes=("data", "seq"), mesh_shape=(1, 2))


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, T, 4, 16).astype(np.float32) for _ in range(4)]


def _rows(seed):
    rng = np.random.RandomState(seed)
    r = rng.randint(0, VOCAB, size=(ROWS, T + 1)).astype(np.int32)
    return r[:, :-1], r[:, 1:]


DATA = [_rows(1), _rows(2)]


def jax_ring(q, k, v, dout, causal):
    from jax.sharding import PartitionSpec as P

    from distributeddeeplearning_tpu.parallel.mesh import create_mesh as jax_mesh
    from distributeddeeplearning_tpu.parallel.ring_attention import ring_attention

    mesh = jax_mesh(devices=jax.devices()[:2], axes=("seq",))
    spec = P(None, "seq")
    fn = jax.shard_map(lambda a, b, c: ring_attention(a, b, c, axis_name="seq", causal=causal),
                       mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    out, vjp = jax.vjp(jax.jit(fn), q, k, v)
    return [np.asarray(x) for x in (out,) + vjp(jnp.asarray(dout))]


def run_jax():
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.models.transformer_lm import TransformerLM as JaxLM
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh as jax_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training.sp_step import make_sp_train_step as jax_sp
    from distributeddeeplearning_tpu.training.train_step import replicate_state
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = JaxConfig(**CFG)
    mesh = jax_mesh(devices=jax.devices()[:2], axes=("data", "seq"), shape=(1, 2))
    model = JaxLM(variant="tiny", vocab_size=VOCAB, max_seq_len=T, dtype=jnp.float32,
                  attn_impl="ring", seq_axis="seq")
    tx, _ = jax_opt(cfg, SPE, world_size=1)
    state = jax_state(model, cfg, tx, input_shape=(1, T), input_dtype=jnp.int32)
    init = jax.tree.map(np.asarray, state.params)
    state = replicate_state(state, mesh)
    step = jax_sp(model, tx, mesh, cfg, donate_state=False)
    spec = NamedSharding(mesh, P("data", "seq"))
    metrics = []
    for tokens, labels in DATA:
        state, m = step(state, (jax.device_put(tokens, spec), jax.device_put(labels, spec)))
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.tree.map(np.asarray, jax.device_get(state.params))


@pytest.fixture(scope="module")
def jax_sp():
    return run_jax()


@pytest.fixture(scope="module")
def port(jax_sp, tmp_path_factory):
    q, k, v, dout = _qkv()
    jobs = [dict(kind="ring", q=q, k=k, v=v, dout=dout, causal=c) for c in (False, True)]
    jobs.append(dict(kind="step", cfg=CFG, model=dict(name="lm_tiny", kwargs=dict(max_seq_len=T)),
                     state=convert.params_from_flax(jax_sp[0]), batches=DATA,
                     steps_per_epoch=SPE))
    return run_world(jobs, 2, tmp_path_factory.mktemp("sp"))


@pytest.mark.parametrize("idx,causal", [(0, False), (1, True)])
def test_ring_attention_matches_jax_ring_and_plain(port, idx, causal):
    q, k, v, dout = _qkv()
    want = jax_ring(q, k, v, dout, causal)
    got = port[idx]
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=1e-5, err_msg=name)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    plain = dot_product_attention(tq, tk, tv, causal=causal, impl="xla")
    plain.backward(torch.tensor(dout))
    for name, ref in zip(("out", "dq", "dk", "dv"), (plain, tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got[name].numpy(), ref.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_sp_step_matches_jax(jax_sp, port):
    _, want_metrics, want_params = jax_sp
    got = port[2]
    for g, w in zip(got["metrics"], want_metrics):
        for key in ("loss", "accuracy", "grad_norm"):
            assert abs(g[key] - w[key]) <= 1e-5 * max(abs(w[key]), 1.0), (key, g[key], w[key])
    assert_step_matches(want_params, convert.params_to_flax(got["state"]["model"]), rel=1e-4)


def test_sp_step_refusals():
    cfg = TrainConfig(**dict(CFG, mesh_shape=(1, 1)))
    mesh = create_mesh(axes=("data", "seq"))
    tx, _ = create_optimizer(cfg, SPE)
    model = get_model("lm_tiny", num_classes=VOCAB, max_seq_len=T, dtype=torch.float32,
                      device="cpu")
    layout = layout_model(model, mesh, "dp")
    with pytest.raises(ValueError, match="seq_axis"):
        make_sp_train_step(model, tx, mesh, cfg, layout, device="cpu")
    model.seq_axis = "seq"
    with pytest.raises(ValueError, match="ring"):
        make_sp_train_step(model, tx, mesh, cfg, layout, device="cpu")
    with pytest.raises(ValueError, match="no ring axis"):
        dot_product_attention(*(torch.zeros(1, 4, 2, 8),) * 3, impl="ring")
