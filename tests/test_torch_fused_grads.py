"""The port's fused dW+db backward (``ops/fused_grads.py``) against the
JAX package's Pallas kernel (``ops/pallas/fused_grads.py``, in interpret
mode on the CPU, as its own tests run it) on the same numpy inputs.

* ``matmul_dw_db_plain`` against JAX's ``matmul_dw_db(interpret=True)``
  (whose ``[K, M]`` dW the test transposes to the port's ``[M, K]``) at
  the JAX package's own test shapes (one tile, a ragged N = 600, several
  M tiles, N below the row block) in bf16 and at an f32 head-like shape
  with M = 100: rtol 1e-5, atol 1e-4, the JAX package's tolerance (f32
  sums of the same exact products in another order);
* ``bias_dense`` against JAX's ``bias_dense`` and its VJP (dx, dW, db):
  in f32 compute within rtol 1e-4, atol 1e-3 (the JAX package's own
  test of its VJP against plain autodiff), the forward within 1e-5; in
  bf16 compute the forward bitwise, dW and db (f32 sums of bf16
  products on both sides) within rtol 1e-5, atol 1e-4, and dx (a bf16
  product rounded once on both sides) within one bf16 step of the
  largest |dx| of its row;
* ``FusedGradDense`` is ``Dense`` with another backward: the same
  forward bitwise, and in f32 the gradients of a plain ``Dense`` within
  1e-5 relative (both take the same f32 products);
* on the CPU the wrapper runs the plain version and launches nothing;
  the card path's dtype checks raise instead of running it;
* ``dw_db_plan`` (the wgmma kernel's tile and row splits): every row of
  N in exactly one split, every split non-empty, at every
  ``chip_smoke.FG_CASES`` shape and at N in {1, 63, 64, 1000}; ViT-B/16's
  proj takes one wave of at least 80 % of an H100's 132 SMs; at
  ``chip_smoke.FG_CONTROL`` the splits, each summed in f32 and merged in
  split order, agree with the plain version within
  ``chip_smoke.fg_limit``, while dropping the last split misses it more
  than tenfold (what the card's negative control relies on); that
  control, ``drop_last_split``, is refused on the CPU;
* ``chip_smoke.FG_CASES`` reach all three kernels by ``kernel_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas import fused_grads as jfg
from distributeddeeplearning_tpu_torch.models.vit import Dense, FusedGradDense
from distributeddeeplearning_tpu_torch.ops import fused_grads as fg

CASES = [(64, 128, 128, "bf16"), (600, 128, 256, "bf16"), (1024, 256, 768, "bf16"),
         (96, 384, 512, "bf16"), (64, 768, 100, "f32")]
JDT = {"bf16": jnp.bfloat16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a tensor of ``dtype``."""
    a = jnp.asarray(rng.randn(*shape).astype(np.float32), JDT[dtype])
    return a, torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


@pytest.mark.parametrize("n,k,m,dtype", CASES, ids=[f"n{n}-k{k}-m{m}-{d}" for n, k, m, d in CASES])
def test_plain_matches_jax_interpret(n, k, m, dtype):
    rng = np.random.RandomState(0)
    jx, x = _pair(rng, (n, k), dtype)
    jg, g = _pair(rng, (n, m), dtype)
    jdw, jdb = jfg.matmul_dw_db(jx, jg, interpret=True)
    before = fg.launches
    dw, db = fg.matmul_dw_db(x, g)
    assert fg.launches == before
    assert dw.dtype == db.dtype == torch.float32 and dw.shape == (m, k) and db.shape == (m,)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw).T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-5, atol=1e-4)


def _bias_dense_case(compute, seed=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(6, 37, 128).astype(np.float32)
    w = rng.randn(128, 384).astype(np.float32)  # flax [in, out]
    b = rng.randn(384).astype(np.float32)
    gy = rng.randn(6, 37, 384).astype(np.float32)
    cd = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    y, vjp = jax.vjp(lambda x_, w_, b_: jfg.bias_dense(x_, w_, b_, cd[0], True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = (y,) + vjp(jnp.asarray(gy, y.dtype))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w.T.copy(), b))
    out = fg.bias_dense(tx, tw, tb, cd[1])
    got = (out,) + torch.autograd.grad(out, (tx, tw, tb), torch.from_numpy(gy).to(out.dtype))
    return [np.asarray(a, np.float32) for a in want], [t.detach().float().numpy() for t in got]


def test_bias_dense_f32_matches_jax_vjp():
    (y, dx, dw, db), (ty, tdx, tdw, tdb) = _bias_dense_case("f32")
    np.testing.assert_allclose(ty, y, rtol=1e-5, atol=1e-5)
    for got, want, name in ((tdx, dx, "dx"), (tdw, dw.T, "dw"), (tdb, db, "db")):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3, err_msg=name)


def test_bias_dense_bf16_matches_jax_vjp():
    (y, dx, dw, db), (ty, tdx, tdw, tdb) = _bias_dense_case("bf16")
    np.testing.assert_array_equal(ty, y)
    np.testing.assert_allclose(tdw, dw.T, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tdb, db, rtol=1e-5, atol=1e-4)
    row_max = np.abs(dx).max(axis=-1, keepdims=True)
    assert (np.abs(tdx - dx) <= 2 ** -8 * row_max).all()


def test_fused_grad_dense_is_dense_with_another_backward():
    rng = np.random.RandomState(4)
    weight = torch.from_numpy(rng.randn(40, 48).astype(np.float32))
    bias = torch.from_numpy(rng.randn(40).astype(np.float32))
    x = torch.from_numpy(rng.randn(3, 7, 48).astype(np.float32))
    gy = torch.from_numpy(rng.randn(3, 7, 40).astype(np.float32))
    outs, grads = [], []
    for cls in (Dense, FusedGradDense):
        mod = cls(48, 40, torch.float32)
        mod.load_state_dict({"weight": weight, "bias": bias})
        xi = x.clone().requires_grad_()
        outs.append(mod(xi))
        grads.append(torch.autograd.grad(outs[-1], (xi, mod.weight, mod.bias), gy))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    for got, want in zip(grads[1], grads[0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_validation_and_card_path_checks():
    with pytest.raises(ValueError, match=r"x \[N, K\]"):
        fg.matmul_dw_db(torch.zeros(4, 3), torch.zeros(5, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        fg.matmul_dw_db(torch.zeros(4, 3, device="meta"), torch.zeros(4, 2, device="meta"))
    # dtype checks run before any pointer reaches the card
    with pytest.raises(NotImplementedError):
        fg.matmul_dw_db_cuda(torch.zeros(4, 8, dtype=torch.float16),
                             torch.zeros(4, 8, dtype=torch.float16))
    with pytest.raises(NotImplementedError):
        fg.matmul_dw_db_cuda(torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(4, 8))


def _fg_plan_cases():
    import chip_smoke

    cases = [(name, n, k, m) for name, n, k, m, _ in chip_smoke.FG_CASES]
    return cases + [(f"qkv_n{n}", n, 768, 2304) for n in (1, 63, 64, 1000)]


@pytest.mark.parametrize("name,n,k,m", _fg_plan_cases(), ids=[c[0] for c in _fg_plan_cases()])
def test_dw_db_plan_covers_every_row_once(name, n, k, m):
    plan = fg.dw_db_plan(n, k, m, 132)
    chunks, cps, splits = -(-n // 64), plan["chunks_per_split"], plan["splits"]
    seen = np.zeros(n, dtype=np.int64)
    for split in range(splits):
        lo = split * cps * 64
        hi = min(n, (split + 1) * cps * 64)
        assert lo < hi, (name, plan)  # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all(), (name, plan)
    assert cps * splits >= chunks > cps * (splits - 1)
    assert plan["tile_k"] in (128, 256) and plan["tile_m"] == 128
    assert plan["tiles"] == -(-m // 128) * -(-k // plan["tile_k"])
    assert plan["blocks"] == plan["tiles"] * splits
    assert plan["merge"] == ("last_block" if splits > 1 else "none")


def test_dw_db_plan_fills_the_card_at_proj():
    """ViT-B/16's proj (N 12,608, K = M = 768) has 18 dW tiles of 128 x
    256 or 36 of 128 x 128: the row splits make one wave of at least 80 %
    of an H100's 132 SMs, and no tail wave (one split would leave 96 or
    114 SMs idle; 128 x 256 in 7 splits, 126 blocks, merges more bytes
    than 128 x 128 in 3, 108 blocks, and measured slower: PERF.md)."""
    plan = fg.dw_db_plan(12_608, 768, 768, 132)
    assert plan["waves"] == 1 and 0.8 * 132 <= plan["blocks"] <= 132, plan
    assert plan["splits"] > 1


def test_split_merge_order_and_the_dropped_split_control():
    """The kernel's arithmetic under its plan at chip_smoke's control
    shape: each split's rows summed in f32, the partials merged in split
    order, is within ``fg_limit`` of the plain version; without the last
    split it misses the limit more than tenfold."""
    import chip_smoke

    _, n, k, m, _ = chip_smoke.FG_CONTROL
    plan = fg.dw_db_plan(n, k, m, 132)
    assert plan["splits"] > 1, plan
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(n, k).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.randn(n, m).astype(np.float32)).bfloat16()
    ref_dw, ref_db = fg.matmul_dw_db_plain(x, g)
    lim_dw = chip_smoke.fg_limit(g.float().abs().t() @ x.float().abs(), n)
    lim_db = chip_smoke.fg_limit(g.float().abs().sum(0), n)
    rows = plan["chunks_per_split"] * 64
    parts = [fg.matmul_dw_db_plain(x[i:i + rows], g[i:i + rows]) for i in range(0, n, rows)]
    assert len(parts) == plan["splits"]

    def merged(live):
        dw, db = torch.zeros(m, k), torch.zeros(m)
        for pdw, pdb in parts[:live]:
            dw, db = dw + pdw, db + pdb
        return max(chip_smoke._ratio(dw, ref_dw, lim_dw)[1], chip_smoke._ratio(db, ref_db, lim_db)[1])

    assert merged(len(parts)) <= 1.0
    assert merged(len(parts) - 1) > 10


def test_fg_cases_take_every_kernel():
    """``chip_smoke.FG_CASES`` reach all three kernels of
    ``csrc/fused_grads.cu`` by ``kernel_path``'s rule: wgmma (ViT-B/16's
    bf16 Dense layers, ragged N), mma.sync (K and M not multiples of 8)
    and the f32 kernel (the head)."""
    import chip_smoke

    paths = {}
    for name, n, k, m, dtype in chip_smoke.FG_CASES:
        x, g = torch.zeros(n, k, dtype=dtype), torch.zeros(n, m, dtype=dtype)
        paths.setdefault(fg.kernel_path(x, g), []).append(name)
    assert set(paths) == {"wgmma", "mma_sync", "f32"}, paths
    assert paths["mma_sync"] == ["ragged_km"] and paths["f32"] == ["vit_b16_head_f32"]


def test_drop_last_split_is_refused_on_the_cpu():
    with pytest.raises(ValueError, match="drop_last_split"):
        fg.matmul_dw_db(torch.zeros(1000, 256), torch.zeros(1000, 384), drop_last_split=True)
