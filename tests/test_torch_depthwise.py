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
* ``wgrad_plan`` (the wgrad's items and partial rows, as
  ``csrc/depthwise_plan.h`` computes them, built for the host): every
  (image, row, column, channel) in exactly one item of the kernel's item
  order, at B4's ten layers and ``chip_smoke``'s other ``DW_CASES``;
  B4's layers on the TMA path with channel slices that divide C (f32
  rows of at most 24 columns on the staged tile, ``wgrad_path``); where
  two blocks would not fit an SM, narrower channel slices before
  narrower column tiles; ``chip_smoke.dw_wgrad_depth`` the longest chain
  the plan's items give; the dropped-partial control refused on the
  CPU.
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


def _wgrad_cases():
    import chip_smoke

    return [(name, b, h, w, c, k, dtype) for name, b, h, w, c, k, dtype in chip_smoke.DW_CASES]


def _tma_items(plan, b, h, w, c):
    """The TMA wgrad's items in the kernel's order (channel slice fastest,
    then column tile, strip, image), as (image, rows, columns, channels)
    ranges clipped to the tensor."""
    items = []
    for item in range(plan["items"]):
        cslice, rest = item % plan["cslices"], item // plan["cslices"]
        ctile, rest = rest % plan["ctiles"], rest // plan["ctiles"]
        strip, image = rest % plan["strips"], rest // plan["strips"]
        h0, w0, c0 = strip * plan["rows"], ctile * plan["tw"], cslice * plan["cs"]
        items.append((image, range(h0, min(h, h0 + plan["rows"])),
                      range(w0, min(w, w0 + plan["tw"])), range(c0, min(c, c0 + plan["cs"]))))
    return items


@pytest.mark.parametrize("name,b,h,w,c,k,dtype", _wgrad_cases(), ids=[c[0] for c in _wgrad_cases()])
def test_wgrad_plan_covers_every_element_once(name, b, h, w, c, k, dtype):
    plan = dw.wgrad_plan(b, h, w, c, k, dtype)
    assert plan["path"] == dw.wgrad_path(b, h, w, c, k, dtype)
    if plan["path"] == "tile":
        assert plan["partials"] == b * -(-w // 12)
        return
    if plan["path"] == "direct":
        assert plan["partials"] == 0
        return
    items = _tma_items(plan, b, h, w, c)
    # the items are a product of per-axis ranges: each axis covered once,
    # and each combination once, is every element once
    for axis, size in ((1, h), (2, w), (3, c)):
        seen = np.zeros(size, dtype=np.int64)
        for r in {(it[axis].start, it[axis].stop) for it in items}:
            assert r[0] < r[1], (name, axis, plan)  # no empty item
            seen[r[0]:r[1]] += 1
        assert (seen == 1).all(), (name, axis, plan)
    keys = {(it[0], it[1].start, it[2].start, it[3].start) for it in items}
    assert len(keys) == len(items) == b * plan["strips"] * plan["ctiles"] * plan["cslices"]
    assert {it[0] for it in items} == set(range(b))
    assert plan["partials"] == b * plan["strips"] * plan["ctiles"]
    assert plan["box_w"] == plan["tw"] + k - 1 <= 256 and plan["cs"] <= 256
    assert plan["tw"] % plan["run"] == 0 and plan["cs"] % plan["vec"] == 0
    assert (plan["tw"] // plan["run"]) * (plan["cs"] // plan["vec"]) <= plan["consumers"] <= 256
    assert plan["ring"] >= k + 1 and plan["smem"] <= 232_448


def test_wgrad_plan_sends_b4_layers_to_the_tma_path():
    """B4's ten layers take the TMA wgrad, their channel slices divide C
    (C = 24 and 48 included: no padded channel, no idle lane but in a
    warp's tail), and two blocks fit an SM's shared memory."""
    import chip_smoke

    for c, h, k, _ in chip_smoke.B4_DW_LAYERS:
        plan = dw.wgrad_plan(64, h, h, c, k, torch.bfloat16)
        assert plan["path"] == "tma", (c, h, k, plan)
        assert plan["cs"] * plan["cslices"] == c, (c, h, k, plan)
        assert 2 * (plan["smem"] + 1024) <= 233_472, (c, h, k, plan)
        assert plan["vec"] == {3: 4, 5: 2, 7: 1}[k]


def test_wgrad_plan_halves_channel_slices_before_narrowing_tiles():
    """f32 48² x 336 at k = 5: an 84-channel slice of the whole row would
    not fit two blocks an SM; the plan halves the slice (44 channels, no
    byte added) and keeps the whole row as one column tile, where
    narrower tiles would each re-read a 4-column halo."""
    plan = dw.wgrad_plan(8, 48, 48, 336, 5, torch.float32)
    assert plan["path"] == "tma"
    assert (plan["cs"], plan["cslices"], plan["tw"], plan["ctiles"]) == (44, 8, 48, 1), plan
    assert 2 * (plan["smem"] + 1024) <= 233_472, plan
    wide = dw.wgrad_plan(64, 48, 48, 336, 5, torch.bfloat16)  # the same layer in bf16 fits
    assert (wide["cs"], wide["tw"], wide["ctiles"]) == (56, 48, 1), wide


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wgrad_path_takes_the_tile_for_narrow_f32_rows(dtype):
    """The wgrad follows ``stencil_path`` but for f32 rows of at most 24
    columns, which take the staged tile; B4's ten layers in bf16 all take
    the TMA ring."""
    import chip_smoke

    for c, h, k, _ in chip_smoke.B4_DW_LAYERS:
        want = "tile" if dtype == torch.float32 and h <= 24 else "tma"
        assert dw.wgrad_path(8, h, h, c, k, dtype) == want, (c, h, k, dtype)
        assert dw.stencil_path(8, h, h, c, k, dtype) == "tma"
    assert dw.wgrad_path(4, 13, 11, 130, 7, dtype) == "tile"  # ragged C, as the stencil
    assert dw.wgrad_path(2, 13, 11, 128, 9, dtype) == "direct"


@pytest.mark.parametrize("name,b,h,w,c,k,dtype", _wgrad_cases(), ids=[c[0] for c in _wgrad_cases()])
def test_dw_wgrad_depth_agrees_with_the_plan_chain(name, b, h, w, c, k, dtype):
    """``chip_smoke.dw_wgrad_depth`` against the chain the plan's items
    give: on the TMA path the most output rows an item holds times a
    thread's columns (one fma each), its runs, then the partial rows'
    sum (a strided share of 32, then the 32 shares)."""
    import chip_smoke

    plan = dw.wgrad_plan(b, h, w, c, k, dtype)
    depth = chip_smoke.dw_wgrad_depth(plan, b, h, w)
    if plan["path"] != "tma":
        assert depth == (chip_smoke.DW_TILE_W * -(-h // 8) + 8 + -(-plan["partials"] // 32) + 32
                         if plan["path"] == "tile" else -(-b * h * w // 8) + 8)
        return
    chain = max(len(rows) for _, rows, _, _ in _tma_items(plan, b, h, w, c)) * plan["run"]
    assert depth == chain + plan["tw"] // plan["run"] + -(-plan["partials"] // 32) + 32


def test_dropped_partial_control_is_refused_on_the_cpu():
    x = torch.zeros(2, 48, 19, 19)
    with pytest.raises(ValueError, match="drop_last_partial"):
        dw.wgrad(x, x, 3, drop_last_partial=True)
