"""The quantized variant of the port's decode attention against the JAX
package's Pallas kernel with ``k_scale``/``v_scale`` (interpret mode on
the CPU, as its own tests run it).

The K/V codes and scales come from ``quantize_kv`` of seeded f32 K/V
(bitwise the same in both packages, ``test_torch_quant.py``) and both
sides read the same codes: int8 and fp8 e4m3, a dense row cache, a paged
pool with a shuffled table whose unowned entries point at a trash block
of large finite codes, and the ``t = 5`` speculative verify window.

Tolerances: with f32 queries both sides dequantize to f32 exactly
(``f32(code) * scale``) and run an exact masked softmax, the Pallas
kernel online and the plain version in two passes, so they differ by
reassociation only: rtol 1e-5, atol 1e-6 (``test_torch_paged_decode.py``'s).
With bf16 queries both round the dequantized K/V, q·scale and p to bf16
and the output once; the f32 sums run in other orders, so a rounding
can land one bf16 ulp apart: 2**-6 (two ulps) of the largest |output|.
The CUDA kernel is held to the plain version on the card by the
``cuda``-marked case and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import quant as jq
from distributeddeeplearning_tpu.ops.pallas.paged_decode import (
    fused_decode_attention as jax_fused,
)
from distributeddeeplearning_tpu_torch.ops import paged_decode, quant

B, H, D, L, BS = 2, 4, 32, 16, 4
RTOL, ATOL = 1e-5, 1e-6


def _to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (int8, ml_dtypes float8_e4m3fn, f32, int32) -> torch."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _quantized(rng, kind, *shape):
    """Codes and scales of seeded unit-normal f32 values, as numpy."""
    x = rng.randn(*shape).astype(np.float32)
    q, s = jq.quantize_kv(jnp.asarray(x), kind, axis=-1)
    return np.asarray(q), np.asarray(s)


def _paged(codes, scales, kind, trash_code):
    """Dense [B, L, H, D] codes/scales -> a pool [B*mb + 1, BS, H, D]
    with a shuffled table; block 0 (trash) holds large finite codes."""
    b, length = codes.shape[:2]
    mb = length // BS
    nb = b * mb + 1
    pool = np.empty((nb, BS) + codes.shape[2:], codes.dtype)
    pool[0] = np.asarray(trash_code, np.float32).astype(codes.dtype)
    spool = np.empty((nb, BS) + scales.shape[2:], np.float32)
    spool[0] = 1e2
    perm = np.random.RandomState(5).permutation(np.arange(1, nb))
    table = np.zeros((b, mb), np.int32)
    for row in range(b):
        for j in range(mb):
            blk = perm[row * mb + j]
            pool[blk] = codes[row, j * BS:(j + 1) * BS]
            spool[blk] = scales[row, j * BS:(j + 1) * BS]
            table[row, j] = blk
    return pool, spool, table


def _both(q, k, v, ks, vs, pos, q_dtype=np.float32, **kw):
    jq_dt = jnp.bfloat16 if q_dtype == "bf16" else jnp.float32
    tq_dt = torch.bfloat16 if q_dtype == "bf16" else torch.float32
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    ref = np.asarray(jax_fused(
        jnp.asarray(q).astype(jq_dt), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), **jkw,
    ).astype(jnp.float32))
    tkw = {key: (_to_torch(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    out = paged_decode.fused_decode_attention(
        torch.from_numpy(q).to(tq_dt), _to_torch(k), _to_torch(v), _to_torch(pos),
        k_scale=_to_torch(ks), v_scale=_to_torch(vs), **tkw,
    ).float().numpy()
    return ref, out


def _case(kind, layout, t, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, t, H, D).astype(np.float32)
    k, ks = _quantized(rng, kind, B, L, H, D)
    v, vs = _quantized(rng, kind, B, L, H, D)
    starts = np.asarray([3, L - t], np.int32)
    pos = (starts[:, None] + np.arange(t)).astype(np.int32)
    kw = {}
    if layout == "paged":
        trash = 127 if kind == "int8" else 448
        k, ks, table = _paged(k, ks, kind, trash)
        v, vs, _ = _paged(v, vs, kind, trash)
        table[0, 2:] = 0  # row 0 lives in its first 2 blocks: the rest is trash
        kw = dict(block_table=table, block_size=BS)
    return q, k, v, ks, vs, pos, kw


@pytest.mark.parametrize("t", [1, 5], ids=["decode", "verify_t5"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_plain_matches_pallas_f32(kind, layout, t):
    q, k, v, ks, vs, pos, kw = _case(kind, layout, t, seed=7)
    ref, out = _both(q, k, v, ks, vs, pos, **kw)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert np.all(np.abs(out) < 50)  # nothing of the trash block leaked


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_plain_matches_pallas_bf16(kind, layout):
    q, k, v, ks, vs, pos, kw = _case(kind, layout, 5, seed=17)
    ref, out = _both(q, k, v, ks, vs, pos, q_dtype="bf16", **kw)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -6 * np.abs(ref).max())


def test_dequantization_is_read_and_rounded_to_the_compute_dtype():
    """The plain version dequantizes ``(code.float() * scale).to(q.dtype)``:
    its output equals attention over K/V dequantized that way by hand,
    and the scales matter (scales of 1 change the output)."""
    q, k, v, ks, vs, pos, _ = _case("int8", "dense", 1, seed=3)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv, tks, tvs, tpos = map(_to_torch, (k, v, ks, vs, pos))
    out = paged_decode.fused_decode_attention(tq, tk, tv, tpos, k_scale=tks, v_scale=tvs)
    hand = paged_decode.fused_decode_attention(
        tq, quant.dequantize_store(tk, tks, torch.bfloat16),
        quant.dequantize_store(tv, tvs, torch.bfloat16), tpos)
    assert torch.equal(out, hand)
    ones = torch.ones_like(tks)
    wrong = paged_decode.fused_decode_attention(tq, tk, tv, tpos, k_scale=ones, v_scale=ones)
    assert not torch.allclose(wrong.float(), out.float(), atol=1e-2)


def test_scale_contract_errors():
    q, k, v, ks, vs, pos, _ = _case("int8", "dense", 1, seed=4)
    tq, tk, tv, tks, tpos = (torch.from_numpy(q), _to_torch(k), _to_torch(v),
                             _to_torch(ks), _to_torch(pos))
    with pytest.raises(ValueError, match="together"):
        paged_decode.fused_decode_attention(tq, tk, tv, tpos, k_scale=tks)
    with pytest.raises(ValueError, match="scales must be"):
        paged_decode.fused_decode_attention(tq, tk, tv, tpos, k_scale=tks[:, :, :1],
                                            v_scale=tks[:, :, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_cuda_quantized_kernel_matches_plain(kind):
    """On the card: the kernel on int8 / fp8 pools against its plain
    version in f32 on the same codes and scales (a 3-wide window, ragged
    positions, trash block 0 of large finite codes), within
    ``chip_smoke.bf16_tolerance``, and counted under its storage dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    import chip_smoke

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"
    q = torch.randn(4, 3, 8, 64, device=dev, generator=g).bfloat16()
    kv = torch.randn(2, 4 * 6 + 1, 16, 8, 64, device=dev, generator=g).bfloat16()
    (k, ks), (v, vs) = (quant.quantize_kv(x, kind) for x in kv)
    for c, s in ((k, ks), (v, vs)):
        c[0] = 127 if kind == "int8" else 448
        s[0] = 1e2
    table = torch.arange(1, 25, device=dev, dtype=torch.int32).view(4, 6)
    table[0, 2:] = 0
    pos = (torch.tensor([20, 40, 60, 93], device=dev)[:, None]
           + torch.arange(3, device=dev)).clamp(max=95).int()
    kw = dict(k_scale=ks, v_scale=vs, block_table=table, block_size=16)
    before = paged_decode.launches_by_store[kind]
    out = paged_decode.fused_decode_attention(q, k, v, pos, **kw)
    ref = paged_decode.fused_decode_attention_plain(q.float(), k, v, pos, **kw)
    torch.cuda.synchronize()
    assert paged_decode.launches_by_store[kind] == before + 1
    assert ((out.float() - ref).abs() <= chip_smoke.bf16_tolerance(ref)).all()
