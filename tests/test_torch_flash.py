"""The port's flash attention (``ops/flash.py``) against the JAX package's
Pallas kernels (``ops/pallas/flash.py``, run in interpret mode on the
CPU, as its own tests run them) on the same numpy inputs.

* ``flash_forward_plain`` (out and LSE) against ``_flash`` on ragged
  shapes (BH = 2, T = 70: two ragged 64-blocks; d 8 and 32; causal and
  not; and Tq = 40 against Tk = 70), f32, atol 1e-5: the same function
  summed in another order (one softmax over all keys against the
  blockwise online recurrence), f32 round-off of O(1) values;
* ``flash_backward_plain`` against both ``_flash_bwd_rule`` (the Mosaic
  dq and dk/dv kernels) and ``_flash_bwd_scan``, atol 2e-4, the
  tolerance of the JAX package's own kernel-against-scan test;
* ``torch.autograd.grad`` through ``flash_attention`` against the
  port's ``xla`` attention, f32, atol 1e-4;
* the wrapper's checks: BTHD only, causal needs equal lengths, and what
  no card route takes (f16, head dims past 256), which raises
  ``NotImplementedError`` instead of running the plain version.

The CUDA kernels are held to their plain versions on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas.flash import _flash, _flash_bwd_rule, _flash_bwd_scan
from distributeddeeplearning_tpu_torch.ops import flash
from distributeddeeplearning_tpu_torch.ops.attention import _xla_attention, dot_product_attention

H = 2  # BH = 2 as B = 1, H = 2


def _inputs(tq, tk, d, seed=3):
    """BHTD numpy arrays [2, t, d] for JAX, and the same values as BTHD
    [1, t, 2, d] tensors for the port."""
    rng = np.random.RandomState(seed)
    q = rng.randn(H, tq, d).astype(np.float32)
    k, v = (rng.randn(H, tk, d).astype(np.float32) for _ in range(2))
    do = rng.randn(H, tq, d).astype(np.float32)
    return (q, k, v, do), tuple(torch.from_numpy(x.transpose(1, 0, 2)[None].copy())
                                for x in (q, k, v, do))


def _bhtd(x: torch.Tensor) -> np.ndarray:
    return x[0].numpy().transpose(1, 0, 2)


SHAPES = [(70, 70, 8, False), (70, 70, 8, True), (70, 70, 32, False), (70, 70, 32, True),
          (40, 70, 32, False)]
IDS = ["t70-d8", "t70-d8-causal", "t70-d32", "t70-d32-causal", "tq40-tk70-d32"]


@pytest.mark.parametrize("tq,tk,d,causal", SHAPES, ids=IDS)
def test_forward_plain_matches_jax_interpret(tq, tk, d, causal):
    (q, k, v, _), (tq_, tk_, tv_, _) = _inputs(tq, tk, d)
    scale = d ** -0.5
    ref_out, ref_lse = _flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
                              64, 64, True)
    out, lse = flash.flash_forward_plain(tq_, tk_, tv_, causal, scale)
    assert out.shape == (1, tq, H, d) and lse.shape == (H, tq)
    np.testing.assert_allclose(_bhtd(out), np.asarray(ref_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tq,tk,d,causal", SHAPES, ids=IDS)
def test_backward_plain_matches_jax_kernels_and_scan(tq, tk, d, causal):
    (q, k, v, do), (tq_, tk_, tv_, tdo) = _inputs(tq, tk, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    out, lse = _flash(jq, jk, jv, causal, scale, 64, 64, True)
    res = (jq, jk, jv, out, lse)
    kernels = _flash_bwd_rule(causal, scale, 64, 64, True, res, jdo)
    scan = _flash_bwd_scan(causal, scale, 64, 64, True, res, jdo)
    t_out = torch.from_numpy(np.asarray(out).transpose(1, 0, 2)[None].copy())
    got = flash.flash_backward_plain(tq_, tk_, tv_, t_out, torch.from_numpy(np.array(lse)),
                                     tdo, causal, scale)
    for name, g, a, b in zip(("dq", "dk", "dv"), got, kernels, scan):
        np.testing.assert_allclose(_bhtd(g), np.asarray(a), atol=2e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(_bhtd(g), np.asarray(b), atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("via", ["flash_attention", "dot_product_attention"])
def test_autograd_matches_xla_attention(causal, via):
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 33, 3, 16).astype(np.float32))
                   for _ in range(4))
    a = [x.clone().requires_grad_() for x in (q, k, v)]
    b = [x.clone().requires_grad_() for x in (q, k, v)]
    if via == "flash_attention":
        out = flash.flash_attention(*a, causal=causal)
    else:
        out = dot_product_attention(*a, causal=causal, impl="pallas")
    ref = _xla_attention(*b, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5, rtol=0)
    got = torch.autograd.grad(out, a, do)
    want = torch.autograd.grad(ref, b, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0, err_msg=name)


def test_strided_views_of_packed_qkv_and_no_launch_on_cpu():
    """q, k, v as the LM's views of its packed qkv projection give the
    result of contiguous copies, and the CPU path launches nothing."""
    rng = np.random.RandomState(6)
    qkv = torch.from_numpy(rng.randn(2, 20, 3, 4, 8).astype(np.float32))
    before = (flash.launches, dict(flash.launches_by_op))
    q, k, v = qkv.unbind(2)
    out = flash.flash_attention(q, k, v, causal=True)
    ref = flash.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (flash.launches, flash.launches_by_op) == before


def test_validation():
    x = torch.zeros(2, 8, 4, 16)
    with pytest.raises(ValueError, match="BTHD"):
        flash.flash_attention(x[0], x[0], x[0])
    with pytest.raises(ValueError, match="equal q/k lengths"):
        flash.flash_attention(x, torch.zeros(2, 9, 4, 16), torch.zeros(2, 9, 4, 16),
                              causal=True)
    with pytest.raises(ValueError, match="k and v"):
        flash.flash_attention(x, x, torch.zeros(2, 8, 4, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="'ring'"):  # no sequence-parallel ring active
        dot_product_attention(x, x, x, impl="ring")
    # the launchers check the per-row vectors before any pointer is passed
    xb = torch.zeros(2, 8, 4, 32, dtype=torch.bfloat16)
    rows = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="LSE and delta"):
        flash.flash_bwd_dq(xb, xb, xb, xb, rows[:, :7], rows, False, 1.0)
    with pytest.raises(ValueError, match="dO"):
        flash.flash_bwd_dkv(xb, xb, xb, xb[:, :4], rows, rows, False, 1.0)


def test_launchers_reject_misaligned_rows():
    """dk/dv reads LSE and Δ by TMA, which needs 16-byte aligned starts: a
    contiguous view that starts 4 bytes in is refused before any launch."""
    xb = torch.zeros(2, 8, 4, 32, dtype=torch.bfloat16)
    good = torch.zeros(8, 8)
    shifted = torch.zeros(8 * 8 + 1)[1:].view(8, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    for lse, delta in ((shifted, good), (good, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash.flash_bwd_dkv(xb, xb, xb, xb, lse, delta, False, 1.0)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash.flash_bwd_dq(xb, xb, xb, xb, lse, delta, False, 1.0)


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64), (torch.float16, 80),
                                     (torch.bfloat16, 320), (torch.float32, 384)])
def test_card_path_raises_on_unsupported_dtype_or_head_dim(dtype, d):
    """The launchers route by dtype and head dim before touching the
    card (``flash.route``: bf16 at 32/64/96/128 to the wgmma kernels, f32
    and other bf16 head dims up to 256 to the generic ones); what no
    kernel takes, f16 and head dims past 256, raises instead of running
    the plain version."""
    x = torch.zeros(1, 8, 2, d, dtype=dtype)
    with pytest.raises(NotImplementedError):
        flash.flash_forward(x, x, x, False, 1.0)
    lse = torch.zeros(2, 8)
    with pytest.raises(NotImplementedError):
        flash.flash_bwd_dq(x, x, x, x, lse, lse, False, 1.0)
    with pytest.raises(NotImplementedError):
        flash.flash_bwd_dkv(x, x, x, x, lse, lse, False, 1.0)
