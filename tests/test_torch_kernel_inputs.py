"""The kernel inputs JAX's Pallas kernels take and the port's fast CUDA
kernels do not (f32, and head dims outside their instances), held to the
JAX package on the CPU: the JAX kernels run in interpret mode, as the
JAX package's own tests run them, and the port its plain versions (the
functions the generic CUDA kernels are held to on the card), on the
same numpy-seeded inputs.

* Flash attention (``ops/flash.py``) at d ∈ {80, 96, 256} (ViT-H/16's
  80, lm_large's 96; the generic route pads d to 128 or 256), causal
  and not, B·H = 2, T = 70 (two ragged 64-blocks): the forward (out,
  LSE) against ``_flash``, the backward against ``_flash_bwd_rule``
  (f32) and ``_flash_bwd_scan`` (the all-f32 math the plain backward
  is). f32: atol 1e-5 forward and 2e-4 backward (``test_torch_flash.py``'s,
  the JAX package's own kernel-against-scan limit); bf16: one bf16 step
  of the element plus two of the tensor's largest |value| (both round
  the output once, and the forward p before p·v, where f32 values that
  differ in their last bits can straddle a rounding boundary).
* Packed attention (``ops/flash_packed.py``) at f32 d 64 and bf16 d 16
  (8 heads a 128-lane group) against ``fused_qkv_attention`` and its
  VJP, with ``test_torch_flash_packed.py``'s limits.
* The fused block in f32 at K = 40 and N = 24, which the bf16 kernel
  refuses (K a multiple of 32, N of 64) and JAX takes (it pads only M),
  both ops, values and gradients, with ``test_torch_fused_block.py``'s
  f32 limit (1e-5 of each output's largest |value|).
* Paged decode at d = 96 on bf16, f32, int8 and fp8 stores against
  ``fused_decode_attention`` (``test_torch_paged_decode_quant.py``'s
  limits: f32 queries rtol 1e-5, atol 1e-6; bf16 2**-6 of the largest
  |output|).
* Each wrapper's ``route`` over a grid of dtypes and head dims (and T,
  K, N where they decide): the fast route for what the wgmma/TMA
  kernels take, the generic (f32) route for the rest JAX takes, and an
  error naming what is taken for what still raises.

The model-level checks (models served and trained at these head dims
and dtypes) are in ``test_torch_kernel_inputs_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_block import NAMES, _inputs as fb_inputs, _run_both
from test_torch_paged_decode_quant import _paged, _quantized, _to_torch

from distributeddeeplearning_tpu.ops.pallas import flash_packed as jfp
from distributeddeeplearning_tpu.ops.pallas.flash import _flash, _flash_bwd_rule, _flash_bwd_scan
from distributeddeeplearning_tpu.ops.pallas.paged_decode import (
    fused_decode_attention as jax_decode,
)
from distributeddeeplearning_tpu_torch.ops import flash, flash_packed, fused_block, paged_decode

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs six test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    lim = 2 ** -8 * np.abs(want) + 2 ** -7 * np.abs(want).max()
    assert (np.abs(got - want) <= lim).all(), (name, np.abs(got - want).max())


def _flash_inputs(t, d, dtype, seed):
    """BHTD arrays [2, t, d] (q, k, v, dO) exactly representable in
    ``dtype``, as JAX arrays and as BTHD [1, t, 2, d] tensors."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    xs = [np.array(jnp.asarray(rng.randn(2, t, d).astype(np.float32), jdt), np.float32)
          for _ in range(4)]
    return ([jnp.asarray(x, jdt) for x in xs],
            [torch.from_numpy(x.transpose(1, 0, 2)[None].copy()).to(tdt) for x in xs])


def _bhtd(x: torch.Tensor) -> np.ndarray:
    return x[0].float().numpy().transpose(1, 0, 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [80, 96, 256])
def test_flash_plain_matches_jax_at_other_head_dims(d, causal, dtype):
    t, scale = 70, d ** -0.5
    (jq, jk, jv, jdo), (q, k, v, do) = _flash_inputs(t, d, dtype, seed=d)
    ref_out, ref_lse = _flash(jq, jk, jv, causal, scale, 64, 64, True)
    out, lse = flash.flash_forward_plain(q, k, v, causal, scale)
    assert out.dtype == q.dtype and lse.shape == (2, t)
    if dtype == "f32":
        np.testing.assert_allclose(_bhtd(out), np.asarray(ref_out), atol=1e-5, rtol=0)
    else:
        _bf16_close(_bhtd(out), ref_out, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)

    res = (jq, jk, jv, ref_out, ref_lse)
    scan = _flash_bwd_scan(causal, scale, 64, 64, True, res, jdo)
    refs = [scan] if dtype == "bf16" else [scan, _flash_bwd_rule(causal, scale, 64, 64, True,
                                                                  res, jdo)]
    t_out = torch.from_numpy(np.array(ref_out, np.float32).transpose(1, 0, 2)[None].copy())
    got = flash.flash_backward_plain(q, k, v, t_out.to(q.dtype),
                                     torch.from_numpy(np.array(ref_lse)), do, causal, scale)
    for ref in refs:
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == q.dtype
            if dtype == "f32":
                np.testing.assert_allclose(_bhtd(g), np.asarray(r), atol=2e-4, rtol=0,
                                           err_msg=name)
            else:
                _bf16_close(_bhtd(g), r, name)


PACKED = [("f32", 2, 33, 2, 64), ("bf16", 2, 33, 8, 16)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype,b,t,h,d", PACKED, ids=[f"{p[0]}-d{p[4]}" for p in PACKED])
def test_packed_plain_matches_jax_in_f32_and_at_head_dim_16(dtype, b, t, h, d, causal):
    assert jfp.supports(t, h, d) and flash_packed.supports(t, h, d)
    rng = np.random.RandomState(d)
    jdt, tdt = DTYPES[dtype]
    qkv = np.array(jnp.asarray(rng.randn(b, t, 3 * h * d).astype(np.float32), jdt), np.float32)
    do = np.array(jnp.asarray(rng.randn(b, t, h * d).astype(np.float32), jdt), np.float32)
    out, vjp = jax.vjp(lambda x: jfp.fused_qkv_attention(x, h, causal=causal, interpret=True),
                       jnp.asarray(qkv, jdt))
    (dqkv,) = vjp(jnp.asarray(do, jdt))
    scale = d ** -0.5
    got = flash_packed.fused_qkv_attention_plain(torch.from_numpy(qkv).to(tdt), h, causal, scale)
    jout = torch.from_numpy(np.array(out, np.float32)).to(tdt)
    got_d = flash_packed.fused_qkv_attention_backward_plain(
        torch.from_numpy(qkv).to(tdt), jout, torch.from_numpy(do).to(tdt), h, causal, scale)
    for name, g, r, atol in (("out", got, out, 2e-5), ("dqkv", got_d, dqkv, 1e-4)):
        assert g.dtype == tdt
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=atol, rtol=0, err_msg=name)
        else:
            _bf16_close(g.float().numpy(), r, name)


@pytest.mark.parametrize("op", ["matmul_stats", "bn_relu_matmul_stats"])
def test_fused_block_f32_at_k_and_n_the_bf16_kernel_refuses(op):
    k, n = 40, 24
    with pytest.raises(ValueError, match="K % 32"):
        fused_block.route(torch.bfloat16, k, n)
    assert fused_block.route(torch.float32, k, n) == "f32"
    jout, tout, jgrads, tgrads = _run_both(op, torch.float32, fb_inputs(m=70, k=k, n=n, seed=4))
    for name, j, t in zip(("y", "sum", "sumsq"), jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max(), err_msg=name)
    for name, j, t in zip(NAMES if len(jgrads) == 6 else ("a", "w"), jgrads, tgrads):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("store", ["bf16", "f32", "int8", "fp8"])
def test_paged_decode_at_head_dim_96(store):
    b, h, d, length, bs, t = 2, 2, 96, 16, 4, 3
    rng = np.random.RandomState(96)
    q = rng.randn(b, t, h, d).astype(np.float32)
    pos = (np.asarray([2, length - t], np.int32)[:, None] + np.arange(t)).astype(np.int32)
    if store in ("int8", "fp8"):
        k, ks = _quantized(rng, store, b, length, h, d)
        v, vs = _quantized(rng, store, b, length, h, d)
    else:
        k, v = (rng.randn(b, length, h, d).astype(np.float32) for _ in range(2))
        ks = vs = np.ones((b, length, h, 1), np.float32)
    trash = {"int8": 127, "fp8": 448}.get(store, 1e4)
    k, ks, table = _paged(k, ks, store, trash)
    v, vs, _ = _paged(v, vs, store, trash)
    table[0, 2:] = 0  # row 0 lives in its first 2 blocks: the rest is trash
    kw = dict(block_table=table, block_size=bs)
    jdt, tdt = DTYPES["bf16" if store == "bf16" else "f32"]
    jkw = {key: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for key, x in kw.items()}
    tkw = {key: (_to_torch(x) if isinstance(x, np.ndarray) else x) for key, x in kw.items()}
    if store in ("int8", "fp8"):
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw.update(k_scale=_to_torch(ks), v_scale=_to_torch(vs))
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _to_torch(k), _to_torch(v)
    else:
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
    ref = np.asarray(jax_decode(jnp.asarray(q, jdt), jk, jv, jnp.asarray(pos), **jkw)
                     .astype(jnp.float32))
    out = paged_decode.fused_decode_attention(torch.from_numpy(q).to(tdt), tk, tv,
                                              torch.from_numpy(pos), **tkw).float().numpy()
    if store == "bf16":
        np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -6 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    plan = paged_decode.split_plan(8, 1, 16, 96, 512, store, 132,
                                   compute="bf16" if store != "f32" else "f32")
    assert plan["smem_bytes"] <= 232_448 and plan["group_heads"] * plan["groups"] >= 16


def test_flash_route_over_dtypes_and_head_dims():
    for d in (1, 16, 32, 48, 64, 80, 96, 128, 200, 256):
        want = "wgmma" if d in (32, 64, 96, 128) else "generic"
        assert flash.route(torch.bfloat16, d) == want, d
        assert flash.route(torch.float32, d) == "generic", d
        with pytest.raises(NotImplementedError, match="bf16 or f32"):
            flash.route(torch.float16, d)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (0, 257, 512):
            with pytest.raises(NotImplementedError, match="head dims 1..256"):
                flash.route(dtype, d)


def test_packed_route_and_supports_over_dtypes_head_dims_and_lengths():
    for d in (16, 32, 64, 128, 256):
        want = "wgmma" if d in (32, 64, 128) else "generic"
        assert flash_packed.route(torch.bfloat16, 197, d) == want, d
        assert flash_packed.route(torch.float32, 197, d) == "generic", d
        with pytest.raises(NotImplementedError, match="bf16 or f32"):
            flash_packed.route(torch.float16, 197, d)
    with pytest.raises(NotImplementedError, match="T <= 512"):
        flash_packed.route(torch.bfloat16, 513, 64)
    with pytest.raises(NotImplementedError, match="head dims 1..256"):
        flash_packed.route(torch.float32, 17, 384)
    for t in (17, 197, 512, 513):
        for h in (1, 2, 3, 6, 8, 12, 16):
            for d in (16, 32, 64, 80, 128, 256, 384, 512):
                assert flash_packed.supports(t, h, d) == jfp.supports(t, h, d), (t, h, d)


def test_fused_block_route_over_dtypes_and_shapes():
    assert fused_block.route(torch.bfloat16, 64, 256) == "tma"
    for k, n in ((64, 256), (1, 1), (3, 5), (40, 24), (2048, 2048)):
        assert fused_block.route(torch.float32, k, n) == "f32"
    for k, n in ((40, 256), (64, 24), (16, 64)):
        with pytest.raises(ValueError, match="bf16 kernel takes"):
            fused_block.route(torch.bfloat16, k, n)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fused_block.route(torch.float16, 64, 256)
    plan = fused_block.f32_plan(200_704, 256, 132)
    assert (plan["panels"], plan["groups"]) == (4, 132)
    assert fused_block.f32_plan(1, 1, 132)["groups"] == 1


def test_decode_head_dims_the_kernel_is_built_for():
    for d in (32, 64, 96, 128):
        for store in ("bf16", "int8", "fp8"):
            assert paged_decode.split_plan(8, 1, 768 // d, d, 2048, store, 132)["blocks"] > 0
        assert paged_decode.split_plan(8, 1, 768 // d, d, 2048, "f32", 132,
                                       compute="f32")["blocks"] > 0
    for d in (16, 48, 80, 256):
        with pytest.raises(ValueError, match="head_dim"):
            paged_decode.split_plan(8, 1, 4, d, 2048, "bf16", 132)
