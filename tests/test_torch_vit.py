"""The port's ViT (``models/vit.py``) against the JAX package's, on the
same numpy inputs and converted weights.

* the parameter count of ``vit_b16`` (224 px, 1000 classes) equals
  JAX's, and the port's state dict has the flax tree's leaves;
* ``vit_params_from_flax`` / ``vit_params_to_flax`` round-trip a flax
  tree bitwise, and ``init_vit_params`` fills every leaf with JAX's
  initialisers' shapes and constants;
* f32 logits of ``ViT(variant="s", patch_size=8)`` at 32 px (17 tokens)
  equal JAX's for ``attn_impl`` ``xla``, ``pallas`` and ``fused`` (the
  JAX kernels in interpret mode), rtol/atol 1e-4 as
  ``test_torch_transformer_lm.py`` holds the LM (the same f32 ops in
  another order through 12 layers), also with ``FUSED_DENSE_GRAD=1``
  (the same forward);
* ``auto`` resolves to ``xla`` off the card, bitwise;
* the L2 penalty covers exactly the flax ``kernel`` leaves;
* ``get_model`` and ``TrainConfig`` plumbing: ``ATTN_IMPL`` ``fused``
  and ``auto`` parse as in JAX and reach ViT and the LM,
  ``FUSED_DENSE_GRAD=1`` turns every Dense of ``lm_tiny`` and of ViT
  into a ``FusedGradDense``, and ``dropout``/``remat`` raise.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import convert, get_model
from distributeddeeplearning_tpu_torch.models.vit import Dense, FusedGradDense, ViT
from distributeddeeplearning_tpu_torch.training import l2_kernel_penalty

SIZE, PATCH, CLASSES = 32, 8, 10


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _jax_vit(attn_impl, variant="s", patch=PATCH, classes=CLASSES):
    from distributeddeeplearning_tpu.models.vit import ViT as JaxViT

    return JaxViT(variant=variant, patch_size=patch, num_classes=classes, dtype=jnp.float32,
                  attn_impl=attn_impl)


@pytest.fixture(scope="module")
def jax_params():
    model = _jax_vit("xla")
    return fnn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                train=False)["params"])


def _port(attn_impl, params, **kw):
    model = ViT(variant="s", patch_size=PATCH, num_classes=CLASSES, dtype=torch.float32,
                device="cpu", attn_impl=attn_impl, image_size=SIZE, **kw)
    model.load_state_dict(convert.vit_params_from_flax(params))
    return model


def _images(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, SIZE, SIZE, 3).astype(np.float32)


def test_vit_b16_parameter_count_equals_jax():
    from distributeddeeplearning_tpu.models import get_model as jax_get_model

    model = jax_get_model("vit_b16")
    shapes = jax.eval_shape(
        lambda r: model.init(r, jnp.zeros((1, 224, 224, 3), jnp.float32), train=False),
        jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    port = get_model("vit_b16", device="meta")
    assert sum(p.numel() for p in port.parameters()) == want
    assert 85e6 < want < 88e6


def test_converters_round_trip_and_init_matches_the_tree(jax_params):
    state = convert.vit_params_from_flax(jax_params)
    model = ViT(variant="s", patch_size=PATCH, num_classes=CLASSES, device="meta",
                image_size=SIZE)
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    back = dict(_leaves(convert.vit_params_to_flax(state)))
    want = dict(_leaves(jax_params))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    init = convert.init_vit_params("s", PATCH, CLASSES, torch.Generator().manual_seed(0), SIZE)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in state.items()}
    for k, v in init.items():
        if k.endswith("bias") or k == "cls_token":
            assert not v.any(), k
        elif k.endswith(".weight") and v.dim() == 1:
            assert (v == 1).all(), k  # LayerNorm scale
    # xavier-uniform bounds: sqrt(6 / (fan_in + fan_out)), fans over the field
    assert init["patch_embed.weight"].abs().max() <= (6 / (3 * 64 + 384 * 64)) ** 0.5
    assert init["head.weight"].abs().max() <= (6 / (384 + CLASSES)) ** 0.5
    assert abs(float(init["pos_embed"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
def test_f32_logits_match_jax(jax_params, impl, monkeypatch):
    images = _images()
    ref = np.asarray(_jax_vit(impl).apply({"params": jax_params}, jnp.asarray(images),
                                          train=False))
    for flag in ("", "1"):
        monkeypatch.setenv("FUSED_DENSE_GRAD", flag)
        with torch.no_grad():
            out = _port(impl, jax_params)(torch.from_numpy(images)).numpy()
        assert out.dtype == np.float32 and out.shape == (2, CLASSES)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_auto_is_xla_on_the_cpu_bitwise(jax_params):
    images = torch.from_numpy(_images(seed=1))
    with torch.no_grad():
        auto = _port("auto", jax_params)(images)
        xla = _port("xla", jax_params)(images)
    torch.testing.assert_close(auto, xla, rtol=0, atol=0)


def test_l2_covers_the_flax_kernel_leaves(jax_params):
    from distributeddeeplearning_tpu.training.train_step import l2_kernel_penalty as jl2

    model = _port("xla", jax_params)
    kernels = [k for k, _ in _leaves(jax_params) if k.endswith("/kernel")]
    assert len(model.kernel_parameters()) == len(kernels) == 1 + 4 * model.depth + 1
    with torch.no_grad():
        want = float(jl2(jax_params, 5e-5))
        assert abs(float(l2_kernel_penalty(model, 5e-5)) - want) <= 1e-6 * want


@pytest.mark.parametrize("impl", ["fused", "auto"])
def test_attn_impl_env_reaches_vit_and_the_lm_like_jax(impl):
    from distributeddeeplearning_tpu.config import TrainConfig as JaxConfig

    env = {"ATTN_IMPL": impl, "MODEL": "vit_b16", "IMAGE_SIZE": "32"}
    mine, ref = TrainConfig.from_env(env), JaxConfig.from_env(env)
    assert mine.attn_impl == ref.attn_impl == impl
    assert mine.model_kwargs()["attn_impl"] == ref.model_kwargs()["attn_impl"]
    vit = get_model(mine.model, **mine.model_kwargs(), device="meta")
    assert vit.attn_impl == impl and vit.image_size == 32
    assert all(b.attn.attn_impl == impl and not b.attn.causal for b in vit.blocks)
    lm = get_model("lm_tiny", **dict(mine.model_kwargs(), num_classes=64), device="meta")
    assert all(b.attn.attn_impl == impl and b.attn.causal for b in lm.blocks)
    get_model("resnet18", **mine.model_kwargs(), device="meta")  # both ignored


def test_get_model_defaults_and_registry():
    vit = get_model("vit_s16", device="meta")
    assert (vit.variant, vit.patch_size, vit.image_size, vit.attn_impl) == ("s", 16, 224, "auto")
    for v in ("ti", "s", "b", "l", "h"):
        get_model(f"vit_{v}16", num_classes=10, image_size=32, device="meta")
    with pytest.raises(ValueError, match="divisible"):
        get_model("vit_b16", image_size=30, device="meta")


@pytest.mark.parametrize("name", ["lm_tiny", "vit_ti16"])
def test_fused_dense_grad_env_builds_fused_dense_layers(name, monkeypatch):
    """``FUSED_DENSE_GRAD=1`` at construction makes every Dense (the
    blocks' four, ViT's head) a ``FusedGradDense``, as JAX's ``_dense``
    routes every biased Dense; unset, none is."""
    for flag, want in (("1", True), ("", False)):
        monkeypatch.setenv("FUSED_DENSE_GRAD", flag)
        model = get_model(name, num_classes=64, image_size=32, device="meta")
        dense = [m for m in model.modules() if isinstance(m, Dense)]
        assert len(dense) == 4 * model.depth + (name == "vit_ti16")
        assert all(isinstance(m, FusedGradDense) == want for m in dense)


def test_dropout_and_remat_raise():
    with pytest.raises(NotImplementedError, match="dropout"):
        ViT("ti", dropout=0.1, device="meta")
    with pytest.raises(NotImplementedError, match="remat"):
        ViT("ti", remat=True, device="meta")
