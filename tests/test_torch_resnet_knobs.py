"""The ResNet knobs of the port: the MLPerf space-to-depth stem
(``s2d_stem``) and bf16 batch statistics (``stats_dtype``), against the
JAX package's ``ResNet`` on the same flax variables (64 px, 10 classes).

* The twin of JAX's ``test_perf_knobs_bf16_stats_and_s2d_stem``: ResNet-18
  in bf16 with both knobs builds a ``[64, 12, 4, 4]`` stem (flax's
  ``(4, 4, 12, 64)`` transposed), returns f32 logits, and keeps its
  running statistics f32.
* ``space_to_depth`` equals JAX's bit for bit (channel order
  ``(bh·2 + bw)·3 + c``).
* f32 with the s2d stem, random BatchNorm scales and statistics (as
  ``test_torch_resnet.py`` draws them): the train-mode forward's logits
  within 1e-4 of max |logit| and the running statistics within 1e-4 of
  their largest value (measured 6.6e-6 and 3.0e-6); one dp step (SGD, L2
  5e-5, from JAX's own init) against JAX's ``value_and_grad`` and
  optimizer update within ``_torch_train_common.assert_step_matches``'s
  limits.
* bf16 with ``stats_dtype=bfloat16``: the statistics reduced in bf16 as
  flax's ``force_float32_reductions=False`` reduces them. bf16 rounding
  sets the gap to JAX (jitted): measured 6.1e-2 of max |logit| and
  1.7e-2 on the running statistics, against 5.3e-2 and 1.2e-2 for the
  same bf16 model with the default f32 statistics. Held: the logits'
  gap within twice the f32-statistics model's (and 0.1), the running
  statistics within 5e-2, all f32. The bf16 reduction moves the port's
  logits away from its f32-statistics ones.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_train_common import assert_step_matches, leaves

from distributeddeeplearning_tpu.models.resnet import ResNet as JaxResNet
from distributeddeeplearning_tpu.models.resnet import space_to_depth as jax_s2d
from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.models.resnet import space_to_depth
from distributeddeeplearning_tpu_torch.training import (
    create_optimizer,
    create_train_state,
    make_train_step,
)

SIZE, CLASSES = 64, 10
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _images(n=2, seed=5):
    return np.random.RandomState(seed).randn(n, SIZE, SIZE, 3).astype(np.float32)


def _jax(dtype, stats_dtype, s2d=True):
    return JaxResNet(depth=18, num_classes=CLASSES, dtype=JAX_DTYPES[dtype],
                     stats_dtype=JAX_DTYPES[stats_dtype], s2d_stem=s2d)


@pytest.fixture(scope="module")
def flax_init():
    """One flax init of the s2d ResNet-18 (its parameters are f32 whatever
    the compute dtype): ``(params, batch_stats)`` as numpy."""
    model = _jax(torch.float32, torch.float32)
    init = jax.jit(lambda k, x: model.init(k, x, train=False))
    v = init(jax.random.PRNGKey(1), jnp.zeros((2, SIZE, SIZE, 3)))
    return (jax.tree.map(np.asarray, fnn.unbox(v["params"])),
            jax.tree.map(np.asarray, v["batch_stats"]))


def _perturbed(flax_init, seed=1):
    """Random BatchNorm scales, biases and statistics, so that every
    residual branch contributes (the init's zero γ would hide them)."""
    params, stats = (jax.tree.map(np.array, t) for t in flax_init)
    rng = np.random.RandomState(seed)

    def perturb(tree, path=()):
        for key, val in tree.items():
            if isinstance(val, dict):
                perturb(val, path + (key,))
            elif key == "scale":
                tree[key] = (1.0 + 0.3 * rng.randn(*val.shape)).astype(np.float32)
            elif key in ("bias", "mean") and path[-1] != "head":
                tree[key] = (0.1 * rng.randn(*val.shape)).astype(np.float32)
            elif key == "var":
                tree[key] = (1.0 + 0.2 * rng.rand(*val.shape)).astype(np.float32)
    perturb(params)
    perturb(stats)
    return params, stats


def _port(dtype, stats_dtype, params, stats, s2d=True):
    model = get_model("resnet18", num_classes=CLASSES, dtype=dtype, device="cpu",
                      s2d_stem=s2d, stats_dtype=stats_dtype)
    model.load_state_dict(convert.resnet_params_from_flax(params, stats))
    return model.train()


def _train_forward(flax_init, dtype, stats_dtype):
    """(JAX logits, JAX running stats, port logits, port running stats,
    port model)."""
    jm = _jax(dtype, stats_dtype)
    params, stats = _perturbed(flax_init)
    x = _images()
    ref, mut = jax.jit(lambda p, s, xx: jm.apply({"params": p, "batch_stats": s}, xx,
                                                 train=True, mutable=["batch_stats"]))(
        params, stats, jnp.asarray(x))
    model = _port(dtype, stats_dtype, params, stats)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    got_stats = convert.resnet_params_to_flax(model.state_dict())[1]
    return (np.asarray(ref), dict(leaves(jax.tree.map(np.asarray, mut["batch_stats"]))), out,
            dict(leaves(got_stats)), model)


def test_perf_knobs_bf16_stats_and_s2d_stem(flax_init):
    params, stats = flax_init
    assert params["stem_conv_s2d"]["kernel"].shape == (4, 4, 12, 64)
    model = _port(torch.bfloat16, torch.bfloat16, params, stats)
    assert model.stem_conv_s2d.weight.shape == (64, 12, 4, 4)
    np.testing.assert_array_equal(model.stem_conv_s2d.weight.detach().numpy(),
                                  params["stem_conv_s2d"]["kernel"].transpose(3, 2, 0, 1))
    with torch.no_grad():
        out = model(torch.from_numpy(_images()))
    assert out.shape == (2, CLASSES) and out.dtype == torch.float32
    for name, buf in model.named_buffers():
        assert buf.dtype == torch.float32, name
    assert "stem_conv" not in dict(model.named_modules())
    init = convert.init_resnet_params(18, CLASSES, torch.Generator().manual_seed(0), s2d_stem=True)
    assert init["stem_conv_s2d.weight"].shape == (64, 12, 4, 4)


def test_space_to_depth_equals_jax_bitwise():
    x = np.random.RandomState(0).randn(3, 8, 6, 5).astype(np.float32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x))))


def test_s2d_stem_train_forward_matches_jax(flax_init):
    ref, want_stats, out, got_stats, _ = _train_forward(flax_init, torch.float32, torch.float32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert want_stats.keys() == got_stats.keys()
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=0,
                                   atol=1e-4 * np.abs(want_stats[k]).max(), err_msg=k)


def test_s2d_stem_step_matches_jax(flax_init):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig
    from distributeddeeplearning_tpu.training import create_optimizer as jax_optimizer
    from distributeddeeplearning_tpu.training.train_step import (
        cross_entropy_loss,
        l2_kernel_penalty,
    )

    kw = dict(model="resnet18", num_classes=CLASSES, image_size=SIZE, batch_size_per_device=4,
              compute_dtype="float32", base_lr=0.1, warmup_epochs=0, lr_schedule="constant")
    jm = _jax(torch.float32, torch.float32)
    params, stats = flax_init
    x, y = _images(4, seed=7), np.random.RandomState(7).randint(0, CLASSES, 4).astype(np.int32)
    jcfg = JaxConfig(**kw)
    tx, _ = jax_optimizer(jcfg, 10, world_size=1)

    @jax.jit
    def step(p0):
        def loss_fn(p):
            logits, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                                   train=True, mutable=["batch_stats"])
            loss = cross_entropy_loss(logits, jnp.asarray(y)) + l2_kernel_penalty(
                p, jcfg.weight_decay)
            return loss, (logits, mut["batch_stats"])

        (loss, (logits, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p0)
        updates, _ = tx.update(grads, tx.init(p0), p0)
        acc = jnp.mean((jnp.argmax(logits, -1) == jnp.asarray(y)).astype(jnp.float32))
        return ({"loss": loss, "accuracy": acc, "grad_norm": jnp.sqrt(sum(
            jnp.sum(g * g) for g in jax.tree.leaves(grads)))},
                jax.tree.map(lambda a, u: a + u, p0, updates), new_stats)

    want_m, want_p, want_s = step(params)
    cfg = TrainConfig(**kw)
    model = get_model("resnet18", num_classes=CLASSES, dtype=torch.float32, device="cpu",
                      s2d_stem=True)
    ptx, _ = create_optimizer(cfg, 10, world_size=1)
    state = create_train_state(model, cfg, ptx, device="cpu",
                               state_dict=convert.resnet_params_from_flax(params, stats))
    state, got_m = make_train_step(model, ptx, cfg, device="cpu")(state, (x, y))
    got = convert.resnet_params_to_flax(model.state_dict())
    assert_step_matches((params, stats), [{k: float(v) for k, v in want_m.items()}],
                        (jax.tree.map(np.asarray, want_p), jax.tree.map(np.asarray, want_s)),
                        [{k: float(v) for k, v in got_m.items()}], got)


def test_bf16_statistics_forward_gap(flax_init):
    """bf16 rounding, amplified by train-mode BatchNorm at 64 px, sets the
    gap: the port's bf16-statistics model is held as close to JAX's as
    the same bf16 model with f32 statistics is to its JAX twin (twice
    that gap, and at most 0.1 of max |logit|; running statistics within
    5e-2 of their largest value)."""
    gaps = {}
    for sd in (torch.bfloat16, torch.float32):
        ref, want_stats, out, got_stats, model = _train_forward(flax_init, torch.bfloat16, sd)
        gaps[sd] = np.abs(out - ref).max() / np.abs(ref).max()
        for k in want_stats:
            assert got_stats[k].dtype == np.float32
            assert (np.abs(got_stats[k] - want_stats[k]).max()
                    <= 5e-2 * np.abs(want_stats[k]).max()), k
        if sd == torch.bfloat16:
            assert model.stem_bn.reduce_dtype == torch.bfloat16
            outs = {sd: out}
        else:
            outs[sd] = out
    assert gaps[torch.bfloat16] <= min(2 * gaps[torch.float32], 0.1), gaps
    assert not np.array_equal(outs[torch.bfloat16], outs[torch.float32])


def test_even_kernel_pads_same_like_flax():
    """A 4×4 stride-1 conv pads SAME as flax does, 1 low and 2 high, by
    padding before ``F.conv2d``."""
    from distributeddeeplearning_tpu_torch.models.resnet import Conv2d

    x = np.random.RandomState(3).randn(2, 9, 7, 12).astype(np.float32)
    conv = fnn.Conv(5, (4, 4), strides=(1, 1), padding="SAME", use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))
    port = Conv2d(12, 5, 4, 1, torch.float32, device="cpu")
    assert port.pads == (1, 2)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1).copy()))
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_fused_blocks_keep_f32_statistics(flax_init):
    """With ``fused=True`` the bottleneck's own BatchNorms stay f32 (the
    kernels' statistics), while the stem and projection BatchNorms
    reduce in bf16, as JAX's fused block does; the model trains a step."""
    model = get_model("resnet50", num_classes=CLASSES, dtype=torch.bfloat16, device="cpu",
                      fused=True, s2d_stem=True, stats_dtype=torch.bfloat16)
    block = model.stage1_block1
    assert model.stem_bn.reduce_dtype == torch.bfloat16
    assert block.proj_bn.reduce_dtype == torch.bfloat16
    assert all(getattr(block, f"BatchNorm_{i}").reduce_dtype == torch.float32 for i in range(3))
    unfused = get_model("resnet50", num_classes=CLASSES, dtype=torch.bfloat16, device="meta",
                        stats_dtype=torch.bfloat16)
    assert unfused.stage1_block1.BatchNorm_0.reduce_dtype == torch.bfloat16
    cfg = TrainConfig(model="resnet50", num_classes=CLASSES, image_size=32,
                      batch_size_per_device=2)
    tx, _ = create_optimizer(cfg, 10)
    state = create_train_state(model, cfg, tx, device="cpu")
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    state, m = make_train_step(model, tx, cfg, device="cpu")(state, (images, np.array([1, 2])))
    assert np.isfinite(float(m["loss"]))
