"""The port's ResNet v1 against the JAX package's (``models/resnet.py``).

From the same converted weights (64 px, 10 classes, batch 2, f32), the
train-mode forward of resnet50, unfused and fused (the Pallas kernels
interpreted on the JAX side, the plain versions on the port's), gives
the same logits and the same BatchNorm running-stat updates, and so
does the eval-mode forward. The BN scales are drawn at random first, so
every residual branch contributes (the init's zero γ would hide them).
Tolerances. A single block (``test_block_matches_jax``) agrees to
5e-7 of its largest output; it is held to 1e-5. The whole train-mode
resnet50 amplifies f32 round-off: its BNs normalise 8 to 32 values per
channel in stages 3-4, so a 1e-7 relative perturbation of the input
alone moves the port's logits by 1e-4 of max |logit|, and the port in
f32 against itself in f64 differs by 7e-5. JAX and the port differ by
4e-4; the logits are held to 2e-3 of max |logit| and each running
statistic to 2e-3 of its largest |value|. A biased/unbiased variance mix-up moves
the running variances by 1/7 at 8 values; a padding or layout error
moves the logits by far more than 2e-3. Eval mode has no such
amplification and is held to 1e-4. The images are 64 px, not 32: at 32
px stage 4 is 1×1, its BNs normalise 2 values, and the fast variance
of 2 values cancels so far that reduction order alone moves the logits
by 3 % (resnet18 at 32 px: 2.6e-2 of max |logit|; at 64 px: 7e-6).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.resnet import ResNet as JaxResNet
from distributeddeeplearning_tpu_torch.models import available_models, convert, get_model
from distributeddeeplearning_tpu_torch.models.resnet import max_pool_same


SIZE = 64


def _flax_variables(depth, num_classes=10, size=SIZE, seed=0):
    model = JaxResNet(depth=depth, num_classes=num_classes, dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, size, size, 3)), train=False)
    params = jax.tree.map(np.asarray, nn.unbox(variables["params"]))
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
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


@pytest.fixture(scope="module")
def resnet50_vars():
    return _flax_variables(50)


def _images(n=2, size=SIZE, seed=3):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_train_forward_and_running_stats_match_jax(resnet50_vars, fused):
    params, stats = resnet50_vars
    x = _images()
    jmodel = JaxResNet(depth=50, num_classes=10, dtype=jnp.float32, fused=fused)
    ref, mutated = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
    ref = np.asarray(ref)
    model = get_model("resnet50", num_classes=10, dtype=torch.float32, fused=fused, device="cpu")
    model.load_state_dict(convert.resnet_params_from_flax(params, stats))
    model.train()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == (2, 10)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3 * np.abs(ref).max())
    _, new_stats = convert.resnet_params_to_flax(model.state_dict())
    want = dict(_leaves(jax.tree.map(np.asarray, mutated["batch_stats"])))
    got = dict(_leaves(new_stats))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=2e-3 * np.abs(want[k]).max(), err_msg=k)


@pytest.mark.parametrize("kind,c_in,filters,stride,fused", [
    ("bottleneck", 32, 16, 1, False), ("bottleneck", 64, 16, 2, False),
    ("bottleneck", 64, 16, 1, False), ("bottleneck", 32, 16, 1, True),
    ("bottleneck", 64, 16, 2, True), ("bottleneck", 64, 16, 1, True),
    ("basic", 16, 32, 2, False), ("basic", 16, 16, 1, False)],
    ids=["bottleneck-proj", "bottleneck-s2", "bottleneck-identity", "fused-proj", "fused-s2",
         "fused-identity", "basic-s2", "basic-identity"])
def test_block_matches_jax(kind, c_in, filters, stride, fused):
    """One block, train mode, random γ: output and running stats."""
    from distributeddeeplearning_tpu.models import resnet as jres
    from distributeddeeplearning_tpu_torch.models import resnet as tres

    rng = np.random.RandomState(c_in + filters + stride)
    if kind == "bottleneck":
        jm = jres.BottleneckBlock(filters=filters, strides=stride, dtype=jnp.float32, fused=fused)
        tm = tres.BottleneckBlock(c_in, filters, stride, torch.float32, "cpu", fused=fused)
    else:
        jm = jres.BasicBlock(filters=filters, strides=stride, dtype=jnp.float32)
        tm = tres.BasicBlock(c_in, filters, stride, torch.float32, "cpu")
    x = rng.randn(2, 8, 8, c_in).astype(np.float32)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree.map(np.asarray, nn.unbox(v["params"]))
    for mod in params.values():
        if "scale" in mod:
            mod["scale"] = (1.0 + 0.3 * rng.randn(*mod["scale"].shape)).astype(np.float32)
    ref, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x),
                        train=True, mutable=["batch_stats"])
    ref = np.asarray(ref)
    sd = convert.resnet_params_from_flax({"b": params}, {"b": v["batch_stats"]})
    tm.load_state_dict({k[2:]: t for k, t in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = tm.train()(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    _, stats = convert.resnet_params_to_flax({f"b.{k}": t for k, t in tm.state_dict().items()})
    want = dict(_leaves(jax.tree.map(np.asarray, mut["batch_stats"])))
    got = dict(_leaves(stats["b"]))
    assert got.keys() == want.keys()
    for k, val in got.items():
        np.testing.assert_allclose(val, want[k], rtol=0, atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_resnet50_eval_forward_matches_jax(resnet50_vars, fused):
    params, stats = resnet50_vars
    x = _images(seed=4)
    jmodel = JaxResNet(depth=50, num_classes=10, dtype=jnp.float32, fused=fused)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                  train=False))
    model = get_model("resnet50", num_classes=10, dtype=torch.float32, fused=fused, device="cpu")
    model.load_state_dict(convert.resnet_params_from_flax(params, stats))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_resnet18_forward_matches_jax():
    params, stats = _flax_variables(18, seed=1)
    x = _images(seed=5)
    ref = np.asarray(JaxResNet(depth=18, num_classes=10, dtype=jnp.float32).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])[0])
    model = get_model("resnet18", num_classes=10, dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.resnet_params_from_flax(params, stats))
    with torch.no_grad():
        out = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("depth,count", [(50, 25_557_032), (18, 11_689_512)])
def test_param_count_matches_reference(depth, count):
    model = get_model(f"resnet{depth}", device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


def test_registry_has_resnet_family():
    for d in (18, 34, 50, 101, 152, 200):
        assert f"resnet{d}" in available_models()


def test_converter_round_trips_and_fused_tree_equals_unfused(resnet50_vars):
    params, stats = resnet50_vars
    sd = convert.resnet_params_from_flax(params, stats)
    unfused = get_model("resnet50", num_classes=10, device="meta").state_dict()
    fused = get_model("resnet50", num_classes=10, fused=True, device="meta").state_dict()
    assert list(unfused) == list(fused)
    assert {k: tuple(v.shape) for k, v in unfused.items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    p2, s2 = convert.resnet_params_to_flax(sd)
    for tree, back in ((params, p2), (stats, s2)):
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_init_matches_jax_initialisers():
    """Same tree as the flax init, with γ = 0 exactly where flax zeroes
    it, and the kernels' spreads of variance_scaling(2, fan_out) and the
    head's lecun normal (within 5 % at these sizes)."""
    jax_params = jax.tree.map(np.asarray, nn.unbox(JaxResNet(depth=50, dtype=jnp.float32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)["params"]))
    sd = convert.init_resnet_params(50, 1000, torch.Generator().manual_seed(0))
    p, s = convert.resnet_params_to_flax(sd)
    want, got = dict(_leaves(jax_params)), dict(_leaves(p))
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if k.endswith(("scale", "bias")):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif v.size >= 4096:
            assert abs(got[k].std() / v.std() - 1) < 0.05, k
            assert np.abs(got[k]).max() <= 2 * got[k].std() * 1.2, k
    assert all((v == (1.0 if k.endswith("var") else 0.0)).all() for k, v in _leaves(s))


def test_max_pool_pads_like_flax_same():
    x = np.random.RandomState(0).randn(2, 112, 112, 4).astype(np.float32)
    ref = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    out = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == (2, 56, 56, 4)
    np.testing.assert_array_equal(out, ref)
    naive = torch.nn.functional.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
    assert not np.array_equal(naive.permute(0, 2, 3, 1).numpy(), ref)


def test_activations_stay_channels_last():
    """The fused blocks see conv activations as [M, C] rows without a
    copy: every block's input and output is channels_last."""
    model = get_model("resnet50", num_classes=10, dtype=torch.float32, fused=True, device="cpu")
    model.load_state_dict(convert.init_resnet_params(50, 10, torch.Generator().manual_seed(0)))
    seen = []
    for name in model.block_names:
        getattr(model, name).register_forward_hook(
            lambda m, i, o: seen.append(i[0].is_contiguous(memory_format=torch.channels_last)
                                        and o.is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        model(torch.from_numpy(_images()))
    assert len(seen) == 16 and all(seen)


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("resnet50")
