"""The fused bottleneck ops (``ops/fused_block.py``) against the JAX
package's Pallas ops (``ops/pallas/fused_block.py``, run interpreted on
the CPU as ``tests/test_fused_block.py`` runs them).

On the CPU the port's wrappers run their plain versions; the values and
every gradient (through the custom backward, JAX's VJP line for line)
are held to the JAX ops on the same numpy inputs, in f32 and in bf16,
at a ragged M (70 rows, not a multiple of any tile). Tolerances:

* f32: the same math in another summation order, so 1e-5 of the
  largest |value| of each output (f32 round-off over K <= 64 terms and
  M = 70 rows is below 1e-6 of it).
* bf16: ``y`` within one bf16 step (2**-8 of |y|, plus 2**-8 of max|y|
  for an f32 sum that lands on the other side of a rounding boundary);
  the column sums, sums of those ``y``, within 2**-7 of Σ|y| (resp.
  Σy²); gradients (bf16 products of bf16 operands) within 2**-6 of the
  largest |grad| of each input.

The hand-written kernel is held to the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``. Here, besides: the
twelve shapes ``chip_smoke.FB_MODEL_SHAPES`` times are the ones the
port's fused ResNet-50 calls, and the kernel's plan
(``csrc/fused_block_plan.h``, built for the host) covers every item of
them once, fits shared memory and transforms each element of ``a`` as
often as it says.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas import fused_block as jfb
from distributeddeeplearning_tpu_torch.ops import fused_block as fb

NAMES = ("a", "mean", "var", "scale", "bias", "w")


def _inputs(m=70, k=32, n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (
        rng.randn(m, k).astype(np.float32) * 1.5 + 0.3,
        rng.randn(k).astype(np.float32) * 0.1 + 0.3,
        np.abs(rng.randn(k)).astype(np.float32) + 0.5,
        rng.randn(k).astype(np.float32),
        rng.randn(k).astype(np.float32) * 0.1,
        rng.randn(k, n).astype(np.float32) / np.sqrt(k),
    )


def _jax_loss(fn):
    def f(*args):
        y, s, ss = fn(*args)
        y = y.astype(jnp.float32)
        return jnp.sum(y * y) + jnp.sum(jnp.sin(s)) + jnp.sum(jnp.cos(ss * 1e-2))
    return f


def _torch_loss(y, s, ss):
    y = y.float()
    return (y * y).sum() + torch.sin(s).sum() + torch.cos(ss * 1e-2).sum()


def _run_both(op, dtype, args):
    """Values and gradients of ``op`` in JAX and in the port, as numpy
    f32; the port takes ``w`` as ``[N, K]`` (its 1x1 conv layout)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    a, mean, var, scale, bias, w = args
    if op == "matmul_stats":
        jargs = (jnp.asarray(a, jdt), jnp.asarray(w, jdt))
        jfn = jfb.matmul_stats
        argnums = (0, 1)
    else:
        jargs = (jnp.asarray(a, jdt), *map(jnp.asarray, (mean, var, scale, bias)),
                 jnp.asarray(w, jdt))
        jfn = jfb.bn_relu_matmul_stats
        argnums = tuple(range(6))
    jout = [np.asarray(x, np.float32) for x in jfn(*jargs)]
    jgrads = [np.asarray(g, np.float32)
              for g in jax.grad(_jax_loss(jfn), argnums=argnums)(*jargs)]

    ta = torch.tensor(a).to(dtype).requires_grad_()
    tw = torch.tensor(np.ascontiguousarray(w.T)).to(dtype).requires_grad_()
    if op == "matmul_stats":
        leaves = [ta, tw]
        out = fb.matmul_stats(ta, tw)
    else:
        bn = [torch.tensor(x).requires_grad_() for x in (mean, var, scale, bias)]
        leaves = [ta, *bn, tw]
        out = fb.bn_relu_matmul_stats(ta, *bn, tw)
    tgrads = torch.autograd.grad(_torch_loss(*out), leaves)
    tout = [x.detach().float().numpy() for x in out]
    tgrads = [g.float().numpy() for g in tgrads]
    tgrads[-1] = tgrads[-1].T  # dw back to [K, N]
    return jout, tout, jgrads, tgrads


@pytest.mark.parametrize("op", ["matmul_stats", "bn_relu_matmul_stats"])
def test_f32_values_and_grads_match_jax(op):
    jout, tout, jgrads, tgrads = _run_both(op, torch.float32, _inputs())
    for name, j, t in zip(("y", "sum", "sumsq"), jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max(), err_msg=name)
    for name, j, t in zip(NAMES if len(jgrads) == 6 else ("a", "w"), jgrads, tgrads):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("op", ["matmul_stats", "bn_relu_matmul_stats"])
def test_bf16_values_and_grads_match_jax(op):
    jout, tout, jgrads, tgrads = _run_both(op, torch.bfloat16, _inputs(seed=1))
    y_j, y_t = jout[0], tout[0]
    np.testing.assert_array_less(
        np.abs(y_t - y_j), 2 ** -8 * np.abs(y_j) + 2 ** -8 * np.abs(y_j).max() + 1e-30)
    np.testing.assert_allclose(tout[1], jout[1], rtol=0, atol=2 ** -7 * np.abs(y_j).sum(0).max())
    np.testing.assert_allclose(tout[2], jout[2], rtol=0, atol=2 ** -7 * (y_j * y_j).sum(0).max())
    for name, j, t in zip(NAMES if len(jgrads) == 6 else ("a", "w"), jgrads, tgrads):
        np.testing.assert_allclose(t, j, rtol=0, atol=2 ** -6 * np.abs(j).max(), err_msg=name)


def test_stats_exclude_nothing_and_count_each_row_once():
    """Σy and Σy² are the column sums of the returned (rounded) y."""
    a, *_, w = _inputs(m=70)
    for dtype in (torch.float32, torch.bfloat16):
        y, s, ss = fb.matmul_stats(torch.tensor(a).to(dtype), torch.tensor(w.T.copy()).to(dtype))
        yf = y.float()
        torch.testing.assert_close(s, yf.sum(0), rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(ss, (yf * yf).sum(0), rtol=1e-6, atol=1e-5)


def test_affine_rows_folds_bn_like_jax():
    _, mean, var, scale, bias, _ = _inputs()
    j = np.asarray(jfb._affine_rows(len(mean), *map(jnp.asarray, (mean, var, scale, bias)), 1e-5))
    inv, shift = fb._affine_rows(*map(torch.tensor, (mean, var, scale, bias)), 1e-5)
    np.testing.assert_allclose(inv.numpy(), j[0], rtol=1e-6)
    np.testing.assert_allclose(shift.numpy(), j[1], rtol=1e-6, atol=1e-6)
    assert not j[2:].any()


def test_cpu_runs_plain_and_counts_no_launch():
    a, *_, w = _inputs()
    before = fb.launches
    fb.matmul_stats(torch.tensor(a), torch.tensor(w.T.copy()))
    assert fb.launches == before


def test_unsupported_device_raises():
    a = torch.zeros(8, 32, device="meta")
    w = torch.zeros(64, 32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fb.matmul_stats(a, w)
    v = torch.zeros(32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fb.bn_relu_matmul_stats(a, v, v, v, v, w)


def test_model_shapes_are_the_fused_resnet50_calls():
    """``FB_MODEL_SHAPES`` is what a fused ResNet-50 forward calls: the
    ops recorded from a CPU forward at batch 1 and 32 px, whose rows scale
    to batch 64 at 224 px by 64 · 7²."""
    import chip_smoke
    from distributeddeeplearning_tpu_torch.models import get_model

    calls = []
    forward = fb._forward

    def record(a, w, affine, op, *rest):
        calls.append((op, a.shape[0] * 64 * 7 ** 2, a.shape[1], w.shape[0]))
        return forward(a, w, affine, op, *rest)

    model = get_model("resnet50", num_classes=10, dtype=torch.float32, fused=True, device="cpu")
    fb._forward = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 3))
    finally:
        fb._forward = forward
    counted = {}
    for c in calls:
        counted[c] = counted.get(c, 0) + 1
    assert counted == {s[:4]: s[4] for s in chip_smoke.FB_MODEL_SHAPES}
    assert len(calls) == 32 == sum(s[4] for s in chip_smoke.FB_MODEL_SHAPES)


def _plan_cases():
    import chip_smoke

    cases = [(op == "bn_relu_matmul_stats", m, k, n) for op, m, k, n, _ in chip_smoke.FB_MODEL_SHAPES]
    cases += [(bn, m, k, n) for bn in (False, True) for m in (1, 127, 129, 3213)
              for k, n in ((32, 64), (96, 192), (2048, 2048))]
    return cases


@pytest.mark.parametrize("bn_relu,m,k,n", _plan_cases())
def test_plan_covers_every_item_once(bn_relu, m, k, n):
    """The blocks' walk takes each (row tile, panel) of the call exactly
    once, each block one panel; the plan fits a block's shared memory;
    the prologue runs ``transforms_per_element`` times on each element
    of a (once a panel, 0 without it); ``stat_depth`` is the plan's own
    reckoning of the statistics' order."""
    p = fb.plan(m, k, n, bn_relu)
    assert p["panel"] in (64, 128, 256) and n % p["panel"] == 0 and p["panels"] == n // p["panel"]
    assert p["row_tiles"] == -(-m // 128) and p["kblocks"] == -(-k // p["box_k"])
    assert 2 <= p["stages"] <= 6 and p["smem"] <= 232_448
    walk = fb.walk(m, k, n, bn_relu)
    assert len(walk) == p["grid"] == p["blocks_per_panel"] * p["panels"] <= 132
    seen = {}
    for b, items in enumerate(walk):
        assert 1 <= len(items) <= p["items_per_block"]
        assert {pn for _, pn in items} == {b % p["panels"]}
        for item in items:
            seen[item] = seen.get(item, 0) + 1
    assert seen == {(t, pn): 1 for t in range(p["row_tiles"]) for pn in range(p["panels"])}
    per_tile = {}
    for t, _ in seen:
        per_tile[t] = per_tile.get(t, 0) + 1
    assert set(per_tile.values()) == {p["panels"]}
    assert p["transforms_per_element"] == (p["panels"] if bn_relu else 0)
    # a thread's 16 rows an item, the block's 8 warps, the merge group, the groups
    assert p["stat_depth"] == p["items_per_block"] * 16 + 8 + p["group"] + p["groups"]
    assert p["group"] * p["groups"] >= p["blocks_per_panel"] > p["group"] * (p["groups"] - 1)


def test_plan_fills_the_card_at_stage_one():
    """At the stage-1 shapes every SM holds a block, and a 256-column
    panel serves bn_relu's conv3 (N 256): a's elements are read and
    transformed once."""
    p = fb.plan(200_704, 64, 256, True)
    assert (p["panel"], p["panels"], p["grid"], p["transforms_per_element"]) == (256, 1, 132, 1)
    assert fb.plan(200_704, 256, 64, False)["grid"] == 132


def test_dropped_partial_control_is_refused_on_cpu():
    """``drop_last_partial`` is a control of the kernel's merge; the plain
    version on a CPU tensor has no partials, so the call raises."""
    a, mean, var, scale, bias, w = map(torch.tensor, _inputs())
    wt = w.t().contiguous()
    with pytest.raises(ValueError, match="drop_last_partial"):
        fb.matmul_stats(a, wt, drop_last_partial=True)
    with pytest.raises(ValueError, match="drop_last_partial"):
        fb.bn_relu_matmul_stats(a, mean, var, scale, bias, wt, drop_last_partial=True)
