"""The port's packed-QKV attention (``ops/flash_packed.py``) against the
JAX package's Pallas kernels (``ops/pallas/flash_packed.py``, run in
interpret mode on the CPU, as its own tests run them) on the same numpy
inputs.

* ``fused_qkv_attention_plain`` against JAX's ``fused_qkv_attention``,
  and ``fused_qkv_attention_backward_plain`` against its VJP (given
  JAX's own forward output, the residual its backward reads), at (B, T,
  H, d) = (2, 17, 6, 64), (2, 197, 2, 64), (1, 40, 1, 128) and (2, 33,
  4, 32), causal and not:
  - f32: atol 2e-5 forward and 1e-4 backward, the JAX package's own
    kernel-against-reference tolerances (``tests/test_attention_ops.py``;
    f32 sums in another order);
  - bf16: both sides round p (and ds) to bf16 at the same points and
    each result once, so they differ where f32 values that differ in
    their last bits straddle a bf16 rounding boundary: one bf16 step
    (2**-8) of the element, or of one rounded p or ds term of its sum.
    The limit is 2**-8·|ref| + 2**-7·(the largest |ref| of the tensor).
  Measured: f32 9.5e-7 (forward) and 2.4e-6 (backward); bf16 0.26 and
  0.11 of the limit.
* ``backward_row_stats_plain`` (each row's m, 1/l and Δ: what the dq
  kernel writes to its scratch and the dk/dv kernel reads) against the
  row statistics of JAX's ``_masked_softmax`` on JAX's own f32 scores, at
  the same shapes, causal and not: exp(s − m) on the kept keys against
  its p (atol 1e-5: p ≤ 1, and the two sides' scores are f32 sums of d
  products in another order, off by d·2**-24·Σ|q·k| ≈ 1e-6 here), 1/l
  against 1/l (rtol 1e-5: l sums at most T terms ≤ 1, T·2**-24 relative,
  plus the scores' 1e-6), Δ against rowsum(dO·o) in f64 (atol 1e-5 on
  sums of magnitude ≤ 13). Measured: 1.7e-6, 1.3e-6 and 1.3e-6; and
  ``stats_rows`` (T rounded up to 128);
* ``supports`` equals JAX's over d ∈ {32, 64, 80, 128}, H ∈ {1, 2, 3, 6,
  12}, T ∈ {17, 197, 512, 513} (wider grids, with JAX's VMEM term:
  ``test_torch_kernel_inputs.py``);
* autograd through ``fused_qkv_attention`` on the CPU runs the plain
  versions and launches nothing; the wrapper's checks, and what no card
  route takes (f16, head dims past 256, T past 512), which raises
  ``NotImplementedError`` instead of running the plain version.

The CUDA kernels are held to their plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas import flash_packed as jfp
from distributeddeeplearning_tpu_torch.ops import flash_packed as fp

SHAPES = [(2, 17, 6, 64), (2, 197, 2, 64), (1, 40, 1, 128), (2, 33, 4, 32)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, t, h, d, dtype, seed=0):
    """qkv [B, T, 3·H·d] and dO [B, T, H·d] as numpy f32 values exactly
    representable in ``dtype``, and as JAX arrays and tensors of it."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    qkv = np.array(jnp.asarray(rng.randn(b, t, 3 * h * d).astype(np.float32), jdt), np.float32)
    do = np.array(jnp.asarray(rng.randn(b, t, h * d).astype(np.float32), jdt), np.float32)
    return ((jnp.asarray(qkv, jdt), jnp.asarray(do, jdt)),
            (torch.from_numpy(qkv).to(tdt), torch.from_numpy(do).to(tdt)))


def _close(got: torch.Tensor, want, dtype, atol, name):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)
    else:
        lim = 2 ** -8 * np.abs(want) + 2 ** -7 * np.abs(want).max()
        assert (np.abs(got - want) <= lim).all(), (name, np.abs(got - want).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("b,t,h,d", SHAPES, ids=[f"b{b}-t{t}-h{h}-d{d}" for b, t, h, d in SHAPES])
def test_plain_forward_and_backward_match_jax_interpret(b, t, h, d, causal, dtype):
    (jqkv, jdo), (qkv, do) = _inputs(b, t, h, d, dtype)
    out, vjp = jax.vjp(lambda x: jfp.fused_qkv_attention(x, h, causal=causal, interpret=True),
                       jqkv)
    (dqkv,) = vjp(jdo)
    scale = d ** -0.5
    got = fp.fused_qkv_attention_plain(qkv, h, causal, scale)
    assert got.dtype == qkv.dtype
    _close(got, out, dtype, 2e-5, "out")
    jout = torch.from_numpy(np.array(out, np.float32)).to(qkv.dtype)
    got_d = fp.fused_qkv_attention_backward_plain(qkv, jout, do, h, causal, scale)
    assert got_d.dtype == qkv.dtype
    for part, name in enumerate(("dq", "dk", "dv")):
        cols = slice(part * h * d, (part + 1) * h * d)
        _close(got_d[..., cols], np.asarray(dqkv, np.float32)[..., cols], dtype, 1e-4, name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("b,t,h,d", SHAPES, ids=[f"b{b}-t{t}-h{h}-d{d}" for b, t, h, d in SHAPES])
def test_backward_row_stats_match_jax_masked_softmax(b, t, h, d, causal):
    (jqkv, jdo), (qkv, do) = _inputs(b, t, h, d, "f32", seed=2)
    scale = d ** -0.5
    out = jfp.fused_qkv_attention(jqkv, h, causal=causal, interpret=True)
    q, k = (jqkv.reshape(b, t, 3, h, d)[:, :, i].transpose(0, 2, 1, 3) for i in (0, 1))
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=jax.lax.Precision.HIGHEST) * scale
    p, l = jax.vmap(jax.vmap(lambda x: jfp._masked_softmax(x, t, causal)))(s)
    stats = fp.backward_row_stats_plain(
        qkv, torch.from_numpy(np.array(out, np.float32)), do, h, causal, scale).numpy()
    assert stats.shape == (3, b * h, t) and stats.dtype == np.float32
    m, inv, delta = (x.reshape(b, h, t) for x in stats)
    keep = np.tril(np.ones((t, t), bool)) if causal else np.ones((t, t), bool)
    got_p = np.where(keep, np.exp(np.asarray(s, np.float64) - m[..., None]), 0.0)
    np.testing.assert_allclose(got_p, np.asarray(p, np.float64), atol=1e-5, rtol=0)
    np.testing.assert_allclose(inv, 1.0 / np.asarray(l, np.float64)[..., 0], rtol=1e-5)
    want = (np.asarray(jdo, np.float64) * np.asarray(out, np.float64)).reshape(b, t, h, d)
    np.testing.assert_allclose(delta, want.sum(-1).transpose(0, 2, 1), atol=1e-5, rtol=0)


def test_stats_rows_pad_to_whole_blocks():
    assert [fp.stats_rows(t) for t in (1, 128, 129, 197, 512)] == [128, 128, 256, 256, 512]


def test_supports_equals_jax():
    grid = itertools.product((17, 197, 512, 513), (1, 2, 3, 6, 12), (32, 64, 80, 128))
    for t, h, d in grid:
        assert fp.supports(t, h, d) == jfp.supports(t, h, d), (t, h, d)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_runs_the_plain_versions_on_the_cpu(causal):
    """``fused_qkv_attention`` through autograd equals the plain forward
    and backward, bitwise, and launches no kernel."""
    (_, _), (qkv, do) = _inputs(2, 33, 4, 32, "f32", seed=1)
    before = (fp.launches, dict(fp.launches_by_op))
    x = qkv.clone().requires_grad_()
    out = fp.fused_qkv_attention(x, 4, causal=causal)
    (grad,) = torch.autograd.grad(out, x, do)
    scale = 32 ** -0.5
    want = fp.fused_qkv_attention_plain(qkv, 4, causal, scale)
    torch.testing.assert_close(out.detach(), want, rtol=0, atol=0)
    torch.testing.assert_close(
        grad, fp.fused_qkv_attention_backward_plain(qkv, want, do, 4, causal, scale),
        rtol=0, atol=0)
    assert (fp.launches, fp.launches_by_op) == before


def test_validation():
    x = torch.zeros(2, 8, 3 * 2 * 64)
    with pytest.raises(ValueError, match="packed"):
        fp.fused_qkv_attention(x[0], 2)
    with pytest.raises(ValueError, match="divisible"):
        fp.fused_qkv_attention(torch.zeros(2, 8, 100), 2)
    with pytest.raises(ValueError, match="unsupported shape"):
        fp.fused_qkv_attention(torch.zeros(1, 513, 3 * 2 * 64), 2)  # T > 512
    with pytest.raises(ValueError, match="unsupported shape"):
        fp.fused_qkv_attention(torch.zeros(1, 8, 3 * 3 * 64), 3)  # 3 heads of 64: half a group
    with pytest.raises(ValueError, match="unsupported device"):
        fp.fused_qkv_attention(x.to("meta"), 2)


@pytest.mark.parametrize("dtype,d,t", [(torch.float32, 64, 600), (torch.float16, 64, 8),
                                       (torch.bfloat16, 384, 8), (torch.bfloat16, 64, 600)])
def test_card_path_raises_on_what_the_kernels_do_not_take(dtype, d, t):
    """The launchers route by dtype, head dim and T before touching the
    card (``flash_packed.route``: bf16 at 32/64/128 to the wgmma kernels,
    f32 and other bf16 head dims up to 256 to the generic ones, T <= 512);
    what no kernel takes, f16, head dims past 256 and T past 512, raises
    instead of running the plain version."""
    qkv = torch.zeros(1, t, 3 * 2 * d, dtype=dtype)
    rows = torch.zeros(1, t, 2 * d, dtype=dtype)
    with pytest.raises(NotImplementedError):
        fp.fused_qkv_forward(qkv, 2, False, 1.0)
    with pytest.raises(NotImplementedError):
        fp.fused_qkv_backward(qkv, rows, rows, 2, False, 1.0)
