"""The port's EfficientNet against the JAX package's
(``models/efficientnet.py``): the registry, parameter counts, the
flax <-> torch converter and the eval-mode logits.

The logits: ``efficientnet_b0``, 10 classes, f32, from the same
weights (random BN statistics and γ, so every branch counts), at 32 px
(the stride-2 depthwise layers pad SAME asymmetrically: ``(0, 1)``,
``(1, 2)``, ``(0, 1)``, ``(1, 2)``) and 33 px (odd sizes, symmetric
pads). Held to 1e-4 of max |logit|: the same f32 functions summed in
other orders (a padding put on the wrong side moves them by far more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from distributeddeeplearning_tpu_torch.models import available_models, convert, get_model
from distributeddeeplearning_tpu_torch.models.efficientnet import EfficientNet, same_pads

CLASSES = 10


def _shapes(variant, classes=CLASSES, size=32):
    model = JaxEfficientNet(variant=variant, num_classes=classes, dtype=jnp.float32)
    return jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, size, size, 3), jnp.float32), train=False),
        jax.random.PRNGKey(0))


def flax_variables(variant="b0", classes=CLASSES, seed=0):
    """Random flax ``(params, batch_stats)`` of ``variant``: He-scaled
    kernels, BN γ 1 ± 0.3, small β, biases and means, variances 1 + U(0, 0.5)."""
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = fill(val, path + (key,))
                continue
            shape = val.shape
            if key == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                arr = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
            elif key == "scale":
                arr = 1.0 + 0.3 * rng.randn(*shape)
            elif key == "var":
                arr = 1.0 + 0.5 * rng.rand(*shape)
            else:  # bias, mean
                arr = 0.1 * rng.randn(*shape)
            out[key] = arr.astype(np.float32)
        return out

    v = _shapes(variant, classes)
    return fill(v["params"]), fill(v["batch_stats"])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_registry_has_efficientnet_family():
    names = available_models()
    for b in range(8):
        assert f"efficientnet_b{b}" in names
    model = get_model("efficientnet_b4", num_classes=10, device="meta")
    assert isinstance(model, EfficientNet) and model.variant == "b4"
    assert model.default_image_size == 380


@pytest.mark.parametrize("variant,classes", [("b0", 1000), ("b4", 1000), ("b0", CLASSES)])
def test_param_count_matches_flax(variant, classes):
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(_shapes(variant, classes)["params"]))
    model = get_model(f"efficientnet_{variant}", num_classes=classes, device="meta")
    assert sum(p.numel() for p in model.parameters()) == want
    if variant == "b0" and classes == 1000:
        assert 5.0e6 < want < 5.6e6, want  # the canonical ~5.29M


def test_converter_round_trip_is_exact():
    params, stats = flax_variables("b0")
    sd = convert.efficientnet_params_from_flax(params, stats)
    model = get_model("efficientnet_b0", num_classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(sd)  # every name and shape matches
    assert model.stage2_block1.dw_conv.weight.shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(
        model.stage2_block1.dw_conv.weight.detach().numpy()[:, 0].transpose(1, 2, 0),
        params["stage2_block1"]["dw_conv"]["kernel"][:, :, 0])
    back_p, back_s = convert.efficientnet_params_to_flax(model.state_dict())
    for want, got in ((params, back_p), (stats, back_s)):
        w, g = dict(_leaves(want)), dict(_leaves(got))
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].shape == g[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_kernel_parameters_are_flax_kernel_leaves():
    params, stats = flax_variables("b0")
    model = get_model("efficientnet_b0", num_classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.efficientnet_params_from_flax(params, stats))
    want = sorted(float(np.sum(v.astype(np.float64) ** 2))
                  for k, v in _leaves(params) if k.endswith("/kernel"))
    got = sorted(float((p.detach().double() ** 2).sum()) for p in model.kernel_parameters())
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_init_has_flax_distributions():
    sd = convert.init_efficientnet_params("b0", CLASSES, torch.Generator().manual_seed(0))
    dw = sd["stage6_block2.dw_conv.weight"]  # [1152, 1, 5, 5]: fan_out = 1152·25
    assert abs(dw.std().item() / np.sqrt(2.0 / (1152 * 25)) - 1) < 0.05
    assert dw.abs().max() <= 2 * np.sqrt(2.0 / (1152 * 25)) / 0.8796256610342398 + 1e-7
    head = sd["head.weight"]  # lecun normal over fan_in 1280
    assert abs(head.std().item() / np.sqrt(1.0 / 1280) - 1) < 0.1
    for name in ("stage2_block1.se.reduce.bias", "head.bias", "stem_bn.bias",
                 "stem_bn.running_mean"):
        assert (sd[name] == 0).all(), name
    for name in ("stem_bn.weight", "head_bn.running_var"):
        assert (sd[name] == 1).all(), name


@pytest.mark.parametrize("n,k,s,want", [(16, 3, 2, (0, 1)), (8, 5, 2, (1, 2)), (4, 3, 2, (0, 1)),
                                        (2, 5, 2, (1, 2)), (17, 3, 2, (1, 1)), (24, 5, 1, (2, 2))])
def test_same_pads_match_xla(n, k, s, want):
    from jax import lax

    assert same_pads(n, k, s) == want
    assert tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == want


@pytest.mark.parametrize("size", [32, 33])
def test_eval_logits_match_flax(size):
    params, stats = flax_variables("b0", seed=size)
    x = np.random.RandomState(size + 1).randn(2, size, size, 3).astype(np.float32)
    jmodel = JaxEfficientNet(variant="b0", num_classes=CLASSES, dtype=jnp.float32)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = get_model("efficientnet_b0", num_classes=CLASSES, dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.efficientnet_params_from_flax(params, stats))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and out.shape == (2, CLASSES)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("efficientnet_b0", num_classes=CLASSES)
    with pytest.raises(RuntimeError, match="CUDA"):
        EfficientNet("b0", num_classes=CLASSES)
