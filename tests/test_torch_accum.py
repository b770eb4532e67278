"""Gradient accumulation in the port: ``ACCUM_STEPS`` (in-step
microbatches, ``training/accum.py``) and ``GRAD_ACCUM_STEPS``
(``training/optimizer.MultiSteps``), twins of
``tests/test_grad_accum.py:121,155,276`` plus the JAX comparisons.

* ``ACCUM_STEPS`` k in {2, 4} against k = 1 on ``lm_tiny`` (f32, 8
  sequences a step, an epoch of 4 steps): parameters within rtol 2e-4 /
  atol 2e-7 and the last step's metrics within rtol 1e-4 / atol 1e-6
  (JAX's limits: splitting the batch re-associates the f32 sums), one
  optimizer step per dispatch either way;
* the accumulated step BITWISE equal to driving the same microbatches by
  hand: each microbatch's gradient, summed in f32 in order, divided by
  k, one SGD update;
* ghost BatchNorm: with frozen parameters, one ``ACCUM_STEPS=2`` dispatch
  folds the running statistics bit for bit like two sequential plain
  dispatches over the same microbatches (one process: no all-reduce sits
  between the folds, so the port needs no tolerance where JAX's 8-device
  mesh allows 1e-6);
* the port's ``ACCUM_STEPS=2`` ResNet-18 step (64 px, f32, 4 images) against
  JAX's accumulated step on a 1-device mesh over two steps, within
  ``_torch_train_common.assert_step_matches``'s limits;
* ``GRAD_ACCUM_STEPS`` k in {2, 3}: the port's ``MultiSteps`` over its
  SGD against ``optax.MultiSteps(optax.sgd)`` from each package's
  ``create_optimizer``, over 7 micro-steps of the same gradients:
  parameters within rtol/atol 1e-6 after every call (f32 Welford means
  computed in another order of ops), the returned schedules equal, and
  a ``fit`` under it moving the parameters every k-th dispatch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.training import (
    MomentumSGD,
    create_optimizer,
    create_train_state,
    cross_entropy_loss,
    loop,
    make_train_step,
)

VOCAB, T = 64, 16



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once on the
    CPU, and eight threads each would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _lm(k=1, batch=8, **kw):
    cfg = TrainConfig(model="lm_tiny", num_classes=VOCAB, batch_size_per_device=batch,
                      fake_data_length=32, epochs=1, compute_dtype="float32",
                      weight_decay=0.0, log_every_steps=0, accum_steps=k, **kw)
    model = get_model(cfg.model, num_classes=VOCAB, dtype="float32", max_seq_len=T,
                      device="cpu")
    data = SyntheticTokenDataset(length=cfg.fake_data_length,
                                 global_batch_size=cfg.global_batch_size, seq_len=T,
                                 vocab_size=VOCAB, seed=0)
    return cfg, model, data


def _run_epoch(k):
    cfg, model, data = _lm(k)
    tx, _ = create_optimizer(cfg, data.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device="cpu")
    step = make_train_step(model, tx, cfg, device="cpu")
    assert step.accum_steps == k
    for batch in data.epoch(0):
        state, metrics = step(state, batch)
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {n: float(v) for n, v in metrics.items()}, state.step, data.steps_per_epoch)


def test_accum_equivalent_to_unaccumulated():
    params1, metrics1, steps1, n = _run_epoch(1)
    assert steps1 == n == 4
    for k in (2, 4):
        params_k, metrics_k, steps_k, _ = _run_epoch(k)
        assert steps_k == steps1
        for name in params1:
            np.testing.assert_allclose(params_k[name].numpy(), params1[name].numpy(),
                                       rtol=2e-4, atol=2e-7, err_msg=f"k={k} {name}")
        for m in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(metrics_k[m], metrics1[m], rtol=1e-4, atol=1e-6,
                                       err_msg=f"k={k} {m}")


def test_accum_loop_is_chunked_math_bitwise():
    k = 2
    cfg, model, _ = _lm(k, batch=4)
    tx = MomentumSGD(lambda count: 0.1, momentum=0.9)
    rng = np.random.RandomState(0)
    rows = rng.randint(0, VOCAB, size=(4, T + 1)).astype(np.int32)
    tokens, labels = torch.from_numpy(rows[:, :-1]), torch.from_numpy(rows[:, 1:])

    state = create_train_state(model, cfg, tx, device="cpu")
    init = [p.detach().clone() for p in model.parameters()]
    make_train_step(model, tx, cfg, device="cpu")(state, (tokens, labels))
    got = [p.detach().clone() for p in model.parameters()]

    with torch.no_grad():
        for p, v in zip(model.parameters(), init):
            p.copy_(v)
    gacc = [torch.zeros_like(p) for p in init]
    for j in range(k):
        mb = slice(2 * j, 2 * j + 2)
        loss = cross_entropy_loss(model(tokens[mb]), labels[mb], 0.0)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        gacc = [a + g for a, g in zip(gacc, grads)]
    want = [p + (a / k) * -0.1 for p, a in zip(init, gacc)]  # fresh momentum: trace = g
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_ghost_batch_norm_folds_like_sequential_steps():
    k = 2
    cfg = TrainConfig(model="resnet18", num_classes=8, image_size=16, compute_dtype="float32",
                      weight_decay=0.0, batch_size_per_device=4)
    tx = MomentumSGD(lambda count: 0.0)  # frozen parameters
    rng = np.random.RandomState(0)
    images = rng.randn(4, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 8, 4).astype(np.int32)

    def fresh():
        model = get_model("resnet18", num_classes=8, dtype="float32", device="cpu")
        return model, create_train_state(model, cfg, tx, device="cpu")

    model_a, state_a = fresh()
    make_train_step(model_a, tx, cfg.replace(accum_steps=k), device="cpu")(
        state_a, (images, labels))
    model_b, state_b = fresh()
    plain = make_train_step(model_b, tx, cfg, device="cpu")
    for j in range(k):
        plain(state_b, (images[2 * j:2 * j + 2], labels[2 * j:2 * j + 2]))
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert any("running" in name for name in sa)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name


def test_accum_step_matches_jax_accumulated_step():
    from _torch_train_common import assert_step_matches, batches
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.data.pipeline import shard_batch
    from distributeddeeplearning_tpu.models.resnet import ResNet
    from distributeddeeplearning_tpu.parallel.mesh import create_mesh
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt
    from distributeddeeplearning_tpu.training import create_train_state as jax_state
    from distributeddeeplearning_tpu.training import make_train_step as jax_step
    from distributeddeeplearning_tpu.training.train_step import replicate_state

    kw = dict(model="resnet18", num_classes=10, image_size=64, batch_size_per_device=4,
              compute_dtype="float32", base_lr=0.01, label_smoothing=0.1, warmup_epochs=1,
              accum_steps=2)
    data = batches(2, global_batch=4)
    jcfg = JaxConfig(**kw)
    jmodel = ResNet(depth=18, num_classes=10, dtype=jnp.float32)
    tx, _ = jax_opt(jcfg, 10, world_size=1)
    mesh = create_mesh(devices=jax.devices()[:1])
    jstate = replicate_state(jax_state(jmodel, jcfg, tx, input_shape=(1, 64, 64, 3)), mesh)
    init = (jax.tree.map(np.asarray, jstate.params),
            jax.tree.map(np.asarray, jstate.batch_stats))
    jstep = jax_step(jmodel, tx, mesh, jcfg, donate_state=False)
    assert jstep.accum_steps == 2
    want = []
    for batch in data:
        jstate, m = jstep(jstate, shard_batch(batch, mesh))
        want.append({k: float(v) for k, v in m.items()})
    want_final = (jax.tree.map(np.asarray, jstate.params),
                  jax.tree.map(np.asarray, jstate.batch_stats))

    cfg = TrainConfig(**kw)
    model = get_model("resnet18", num_classes=10, dtype="float32", device="cpu")
    ptx, _ = create_optimizer(cfg, 10, world_size=1)
    state = create_train_state(model, cfg, ptx, device="cpu",
                               state_dict=convert.resnet_params_from_flax(*init))
    step = make_train_step(model, ptx, cfg, device="cpu")
    got = []
    for batch in data:
        state, m = step(state, batch)
        got.append({k: float(v) for k, v in m.items()})
    assert state.step == 2
    assert_step_matches(init, want, want_final, got,
                        convert.resnet_params_to_flax(model.state_dict()))


@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_steps_matches_optax_multisteps(k):
    import optax

    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training import create_optimizer as jax_opt

    kw = dict(base_lr=0.1, warmup_epochs=1, grad_accum_steps=k)
    tx, sched = create_optimizer(TrainConfig(**kw), 6, world_size=2)
    jtx, jsched = jax_opt(JaxConfig(**kw), 6, world_size=2)
    assert isinstance(jtx, optax.MultiSteps)
    for s in range(40):
        assert np.float32(sched(s)) == np.float32(jsched(s)), s
    rng = np.random.RandomState(k)
    p = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    jp = [np.array(x) for x in p]
    tp = [torch.tensor(x) for x in p]
    tstate, jstate = tx.init(tp), jtx.init(jp)
    for i in range(7):
        g = [rng.randn(*x.shape).astype(np.float32) for x in p]
        upd, jstate = jtx.update(g, jstate, jp)
        jp = [np.asarray(a + u) for a, u in zip(jp, upd)]
        moved = tx.apply(tp, [torch.tensor(x) for x in g], tstate)
        assert (moved is not None) == ((i + 1) % k == 0)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6, err_msg=f"call {i}")
        assert tstate["mini_step"] == int(jstate.mini_step)
        assert tstate["gradient_step"] == int(jstate.gradient_step)
        assert tstate["inner"]["count"] == (i + 1) // k

    # fit under GRAD_ACCUM_STEPS: the parameters move every k-th dispatch
    cfg, model, data = _lm(grad_accum_steps=k, batch=4)
    res = loop.fit(model, cfg, data, device="cpu", add_default_logger=False)
    assert res.state.step == data.steps_per_epoch == 8
    assert res.state.opt_state["gradient_step"] == 8 // k
    assert res.state.opt_state["inner"]["count"] == 8 // k
    assert res.state.opt_state["mini_step"] == 8 % k
