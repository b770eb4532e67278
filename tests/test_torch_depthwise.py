"""The port's depthwise convolution (``ops/depthwise.py``) against the
JAX package's Pallas kernel (``ops/pallas/depthwise.py``, interpreted).

* The plain version (``stencil_plain``, ``wgrad_plain``) against
  ``depthwise_conv2d(..., interpret=True)``: the forward and both
  gradients through ``jax.grad``, on numpy-seeded f32 inputs, at the
  three shapes of ``tests/test_depthwise.py`` plus k = 7 with H != W.
  Held to 1e-4 of max |ref|: both sum the same f32 products in other
  orders.
* The entry point on the CPU: ``depthwise_conv2d`` through its
  ``torch.autograd.Function`` gives the plain forward's values and the
  gradients autograd takes through the plain forward (dx from the
  flipped stencil, dw from the wgrad).
* ``supports`` agrees with JAX's wherever JAX's VMEM term holds, and
  every shape it refuses raises ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas import depthwise as jdw
from distributeddeeplearning_tpu_torch.ops import depthwise as dw

SHAPES = [
    (2, 13, 11, 8, 3),  # ragged spatial dims, both edges masked
    (2, 9, 9, 8, 5),
    (1, 16, 16, 130, 3),  # C straddles a lane-tile boundary
    (2, 10, 14, 6, 7),  # k = 7, H != W
]


def _inputs(b, h, w, c, k, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(k, k, 1, c).astype(np.float32))


def _torch(x, kern):
    """NHWC -> a channels_last [N, C, H, W] view; [k, k, 1, C] -> [C, 1, k, k]."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(np.ascontiguousarray(kern.transpose(3, 2, 0, 1))))


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("b,h,w,c,k", SHAPES)
def test_plain_matches_interpreted_pallas(b, h, w, c, k):
    x, kern = _inputs(b, h, w, c, k, seed=h * w + k)

    def loss(xx, kk):
        return jnp.sum(jnp.sin(jdw.depthwise_conv2d(xx, kk, interpret=True)))

    ref_y = np.asarray(jdw.depthwise_conv2d(jnp.asarray(x), jnp.asarray(kern), interpret=True))
    ref_dx, ref_dk = (np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(kern)))

    xt, wt = _torch(x, kern)
    taps = torch.from_numpy(kern.reshape(k * k, c))  # JAX's [k², C] table
    y = dw.stencil_plain(xt, taps)
    _close(y.permute(0, 2, 3, 1).numpy(), ref_y)
    dy = torch.cos(y)  # d sum(sin(y)) / dy
    dx = dw.stencil_plain(dy, taps, flip=True)
    _close(dx.permute(0, 2, 3, 1).numpy(), ref_dx)
    dk = dw.wgrad_plain(xt, dy, k)
    _close(dk.numpy().reshape(k, k, 1, c), ref_dk)
    # the entry point's own weight layout gives the same table
    _close(dw.depthwise_conv2d_plain(xt, wt).permute(0, 2, 3, 1).numpy(), ref_y)


@pytest.mark.parametrize("b,h,w,c,k", SHAPES)
def test_entry_point_autograd_matches_plain(b, h, w, c, k):
    x, kern = _inputs(b, h, w, c, k, seed=7 * k + c)
    xt, wt = _torch(x, kern)
    g = torch.from_numpy(np.random.RandomState(k).randn(b, c, h, w).astype(np.float32))

    xa, wa = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    y = dw.depthwise_conv2d(xa, wa)
    (y * g).sum().backward()
    xp, wp = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    y_plain = dw.depthwise_conv2d_plain(xp, wp)
    (y_plain * g).sum().backward()
    assert y.dtype == torch.float32 and y.shape == (b, c, h, w)
    np.testing.assert_array_equal(y.detach().numpy(), y_plain.detach().numpy())
    _close(xa.grad.numpy(), xp.grad.numpy())
    _close(wa.grad.numpy(), wp.grad.numpy())
    assert wa.grad.dtype == wt.dtype and wa.grad.shape == wt.shape


def test_entry_point_keeps_bf16():
    x, kern = _inputs(2, 9, 9, 8, 3, seed=5)
    xt, wt = _torch(x, kern)
    xb = xt.to(torch.bfloat16).requires_grad_()
    y = dw.depthwise_conv2d(xb, wt)
    assert y.dtype == torch.bfloat16
    # the f32 sum of the bf16 inputs, rounded once
    ref = dw.stencil_plain(xb.detach().float(), dw.weight_taps(wt)).to(torch.bfloat16)
    assert torch.equal(y, ref)
    y.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_supports_agrees_with_jax_where_vmem_fits():
    checked = 0
    for h in (1, 2, 3, 5, 7, 13, 28, 56):
        for w in (1, 3, 8, 13, 28):
            for c in (1, 8, 130, 336):
                for k in (1, 2, 3, 4, 5, 7):
                    for stride in (1, 2):
                        if jdw._vmem_bytes(1, h, w, c, k) > jdw._VMEM_LIMIT:
                            continue
                        assert dw.supports(h, w, c, k, stride) == jdw.supports(
                            h, w, c, k, stride), (h, w, c, k, stride)
                        checked += 1
    assert checked > 1500
    # beyond the TPU's VMEM: the port tiles any image
    assert not jdw.supports(380, 380, 2688, 3, 1) and dw.supports(380, 380, 2688, 3, 1)


@pytest.mark.parametrize("xshape,wshape", [
    ((1, 4, 8, 8), (4, 1, 4, 4)),  # even k
    ((1, 4, 8, 8), (4, 1, 1, 1)),  # k = 1
    ((1, 4, 2, 8), (4, 1, 3, 3)),  # h < k
    ((1, 4, 8, 4), (4, 1, 5, 5)),  # w < k
    ((1, 4, 8, 8), (5, 1, 3, 3)),  # C mismatch
    ((1, 4, 8, 8), (4, 2, 3, 3)),  # not depthwise
    ((4, 8, 8), (4, 1, 3, 3)),  # not 4-D
])
def test_unsupported_shapes_raise(xshape, wshape):
    with pytest.raises(ValueError):
        dw.depthwise_conv2d(torch.zeros(xshape), torch.zeros(wshape))


def test_other_devices_raise():
    x = torch.zeros(1, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dw.stencil(x, torch.zeros(9, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dw.wgrad(x, x, 3)


def test_stencil_path_sends_b4_layers_to_the_tma_ring():
    """All ten of EfficientNet-B4's stride-1 layer shapes (chip_smoke's
    ``B4_DW_LAYERS``, batch 64, bf16) take the TMA row ring; a C whose
    rows are not a multiple of 16 bytes (130 bf16, 130 f32) or an
    unaligned x takes the tile kernel; k = 9 the direct one."""
    import chip_smoke

    assert len(chip_smoke.B4_DW_LAYERS) == 10
    for c, h, k, _ in chip_smoke.B4_DW_LAYERS:
        assert dw.stencil_path(64, h, h, c, k, torch.bfloat16) == "tma", (c, h, k)
    assert dw.stencil_path(8, 24, 24, 672, 5, torch.float32) == "tma"
    assert dw.stencil_path(4, 13, 11, 130, 7, torch.bfloat16) == "tile"
    assert dw.stencil_path(4, 13, 11, 130, 3, torch.float32) == "tile"
    assert dw.stencil_path(64, 190, 190, 48, 3, torch.bfloat16, aligned=False) == "tile"
    assert dw.stencil_path(2, 13, 11, 130, 9, torch.bfloat16) == "direct"
    assert dw.stencil_path(2, 13, 11, 48, 9, torch.bfloat16) == "direct"
    # the whole DW_CASES table: the B4 rows and the ragged C = 40 row on
    # the ring, the C = 130 rows on the tile kernel, k = 9 direct
    paths = {name: dw.stencil_path(b, h, w, c, k, dtype)
             for name, b, h, w, c, k, dtype in chip_smoke.DW_CASES}
    assert paths["ragged_17x9_c40_k7"] == "tma"
    assert paths["ragged_13x11_c130_k7"] == paths["ragged_13x11_c130_k3_f32"] == "tile"
    assert paths["direct_13x11_c130_k9"] == "direct"
