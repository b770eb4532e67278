"""The port's decode-attention kernel wrapper against the JAX package's
Pallas kernel (``ops/pallas/paged_decode.py``, run in interpret mode on
the CPU as its own tests run it).

On the CPU the port's wrapper takes its plain PyTorch version, so these
tests hold the kernel's *math* to the Pallas kernel's, case for case
with ``tests/test_paged_decode_kernel.py`` (the quantized stores wait
for the port of ``ops/quant.py``). The CUDA kernel itself is held
against the same plain version on the card, by the ``cuda``-marked test
below and by ``chip_smoke.py``.

Tolerance: f32 end to end; both sides run an exact masked softmax, the
Pallas kernel online (block-wise rescaling) and the plain version in two
passes, so they differ by reassociation only — rtol 1e-5, atol 1e-6 (the
tolerance the JAX tests hold the Pallas kernel to against its XLA
reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops.pallas.paged_decode import (
    fused_decode_attention as jax_fused,
)
from distributeddeeplearning_tpu_torch.ops import paged_decode

B, H, D, L = 2, 4, 32, 16
RTOL, ATOL = 1e-5, 1e-6


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _paged_from_dense(dense, block_size, trash=1e4):
    """Dense [B, L, H, D] -> pool [B*mb + 1, bs, H, D] + tables; block 0
    (trash) holds garbage."""
    b, length, h, d = dense.shape
    mb = length // block_size
    pool = np.full((b * mb + 1, block_size, h, d), trash, np.float32)
    table = np.zeros((b, mb), np.int32)
    for row in range(b):
        for j in range(mb):
            blk = 1 + row * mb + j
            pool[blk] = dense[row, j * block_size:(j + 1) * block_size]
            table[row, j] = blk
    return pool, table


def _both(q, k, v, pos, **kw):
    """Run the Pallas kernel (interpret mode) and the port's wrapper on
    the same numpy inputs; returns (jax_out, torch_out) as numpy."""
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    ref = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), **jkw))
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    out = paged_decode.fused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), **tkw,
    ).numpy()
    return ref, out


def test_dense_row_matches_pallas():
    rng = np.random.RandomState(0)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    pos = np.asarray([[5], [L - 1]], np.int32)
    ref, out = _both(q, k, v, pos)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_paged_pool_from_dense_matches_pallas():
    rng = np.random.RandomState(2)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    pos = np.asarray([[L - 1], [7]], np.int32)
    k_pool, table = _paged_from_dense(k, block_size=4)
    v_pool, _ = _paged_from_dense(v, block_size=4)
    ref, out = _both(q, k_pool, v_pool, pos, block_table=table, block_size=4)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    # and both equal attention over the dense rows the pool came from
    _, dense = _both(q, k, v, pos)
    np.testing.assert_allclose(out, dense, rtol=RTOL, atol=ATOL)


def test_trash_and_unowned_blocks_never_attended():
    rng = np.random.RandomState(3)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    live = 6
    pos = np.full((B, 1), live - 1, np.int32)
    k_pool, table = _paged_from_dense(k, block_size=4, trash=1e4)
    v_pool, _ = _paged_from_dense(v, block_size=4, trash=1e4)
    table[:, 2:] = 0  # unowned tail -> trash block
    ref, out = _both(q, k_pool, v_pool, pos, block_table=table, block_size=4)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert np.all(np.abs(out) < 10)  # nothing of the 1e4 garbage leaked


def test_kv_len_caps_dense_tail():
    rng = np.random.RandomState(4)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    kv_len = 10
    k[:, kv_len:] = 1e4
    v[:, kv_len:] = 1e4
    pos = np.full((B, 1), L - 1, np.int32)  # rows reach past kv_len
    ref, out = _both(q, k, v, pos, kv_len=kv_len)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    assert np.all(np.abs(out) < 10)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_verify_window_matches_pallas(paged):
    """The [B, K+1] window: per-row ascending positions, causal within
    the window."""
    rng = np.random.RandomState(6)
    kk = 3
    q = _rand(rng, B, kk + 1, H, D)
    k, v = _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    pos = (np.asarray([4, 9], np.int32)[:, None] + np.arange(kk + 1)).astype(np.int32)
    kw = {}
    if paged:
        k, table = _paged_from_dense(k, block_size=4)
        v, _ = _paged_from_dense(v, block_size=4)
        kw = dict(block_table=table, block_size=4)
    ref, out = _both(q, k, v, pos, **kw)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_bf16_plain_matches_pallas_within_bf16():
    """bf16 inputs: both sides round q·scale and p to bf16 and the output
    once; the order of the f32 sums differs, so a rounding can land one
    bf16 ulp apart. bf16 keeps 8 significant bits, so an ulp is at most
    2**-7 of the value: hold them to two ulps of the largest output."""
    rng = np.random.RandomState(8)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    pos = np.asarray([[5], [L - 1]], np.int32)
    ref = np.asarray(jax_fused(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos),
    ).astype(jnp.float32))
    out = paged_decode.fused_decode_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.from_numpy(pos),
    ).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2 ** -6 * np.abs(ref).max())


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    rng = np.random.RandomState(9)
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, L, H, D), _rand(rng, B, L, H, D)
    pos = torch.full((B, 1), L - 1, dtype=torch.int32)
    before = paged_decode.launches
    out = paged_decode.fused_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos
    )
    plain = paged_decode.fused_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos
    )
    assert paged_decode.launches == before
    assert torch.equal(out, plain)


def test_vector_position_contract():
    q = torch.zeros(B, 1, H, D)
    k = torch.zeros(B, L, H, D)
    with pytest.raises(ValueError, match="q_pos"):
        paged_decode.fused_decode_attention(q, k, k, torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="block_size"):
        paged_decode.fused_decode_attention(
            q, k, k, torch.zeros(B, 1, dtype=torch.int32),
            block_table=torch.zeros(B, 4, dtype=torch.int32),
        )


def _covers(plan, t, h, length):
    """How often the kernel's blocks under ``plan`` cover each query row,
    head and key position: blocks are the product of tiles of query rows,
    groups of heads and splits of 16-key chunks (as the source cuts
    them), so each axis is counted alone."""
    rows, heads, keys = np.zeros(t, int), np.zeros(h, int), np.zeros(length, int)
    for tile in range(plan["tiles"]):
        rows[tile * plan["tile_q"]:(tile + 1) * plan["tile_q"]] += 1
    for group in range(plan["groups"]):
        heads[group * plan["group_heads"]:(group + 1) * plan["group_heads"]] += 1
    for split in range(plan["splits"]):
        c0 = split * plan["chunks_per_split"] * 16
        keys[c0:c0 + plan["chunks_per_split"] * 16] += 1
    return rows, heads, keys


@pytest.mark.parametrize("t", [1, 5, 16, 17, 512])
@pytest.mark.parametrize("length", [16, 48, 2048, 4096])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_split_plan_covers_every_key_once(t, length, layout):
    """The split plan (shapes only) covers each (query row, head, key
    position) exactly once, in every storage and compute dtype and head
    dim, on 132 SMs and on 8; no group is empty and each block fits the
    card's shared memory. Dense caches give the plan L, paged ones
    mb * block_size: the same length, so the same cover."""
    b = 2 if t == 512 else 8
    if layout == "paged":
        length = (length // 16) * 16  # mb blocks of 16 positions
    for d in (32, 64, 128):
        h = 768 // d
        for store, compute in (("bf16", "bf16"), ("f32", "f32"), ("int8", "bf16"),
                               ("fp8", "bf16"), ("int8", "f32")):
            for sms in (132, 8):
                plan = paged_decode.split_plan(b, t, h, d, length, store, sms, compute=compute)
                assert plan["smem_bytes"] <= 232_448
                assert (plan["groups"] - 1) * plan["group_heads"] < h
                assert plan["chunks_per_split"] <= 8
                assert plan["combine"] == ("last_block" if plan["splits"] > 1 else "none")
                for cover in _covers(plan, t, h, length):
                    assert (cover == 1).all(), (d, store, sms)
                assert plan["blocks"] == b * plan["tiles"] * plan["groups"] * plan["splits"]


def test_split_plan_fills_the_card_at_lm_base_decode():
    """lm_base's decode call (B 8, t 1, H 12, d 64, L 2048) takes 16
    splits of 128 keys: 128 blocks on 132 SMs, all heads in one group."""
    plan = paged_decode.split_plan(8, 1, 12, 64, 2048, "bf16", 132)
    assert (plan["splits"], plan["groups"], plan["blocks"]) == (16, 1, 128)
    quant = paged_decode.split_plan(8, 1, 12, 64, 2048, "int8", 132)
    assert (quant["splits"], quant["groups"]) == (16, 1)


def test_merge_counters_are_kept_per_device_and_stream():
    """The in-launch merge's counter buffer is one per (device, stream):
    a second stream never shares the first's counters, a later call on
    the same stream reuses its buffer, zeroed, and a larger plan grows
    it. The buffer is allocated on the device it is asked for, so the
    CPU stands in for a card here."""
    cpu = torch.device("cpu")
    first = paged_decode._counters(cpu, 1001, 64)
    assert first.dtype == torch.int32 and not first.any()
    assert paged_decode._counters(cpu, 1001, 64) is first
    other = paged_decode._counters(cpu, 1002, 64)
    assert other is not first
    grown = paged_decode._counters(cpu, 1001, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert paged_decode._counters(cpu, 1002, 64) is other


def test_drop_last_split_is_refused_on_the_cpu():
    q = torch.zeros(B, 1, H, D)
    k = torch.zeros(B, L, H, D)
    with pytest.raises(ValueError, match="drop_last_split"):
        paged_decode.fused_decode_attention(q, k, k, torch.zeros(B, 1, dtype=torch.int32),
                                            drop_last_split=True)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cuda_kernel_matches_plain(paged):
    """On the card: the hand-written kernel against its plain version in
    f32 on the same bf16 inputs (a 3-wide window, ragged positions).
    Tolerance: the output, p and q·scale are each rounded to bf16 (unit
    roundoff 2**-8) by the kernel and not by the f32 reference — 2**-8
    of |ref| for the output's rounding, plus 2**-6 (4 × 2**-8) of the
    row's max |ref| over the head dim for the roundings of p and
    q·scale, whose signs cancel across keys (chip_smoke.bf16_tolerance
    says more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(4, 3, 8, 64, device=dev, generator=g).to(bf)
    k = torch.randn(4, 96, 8, 64, device=dev, generator=g).to(bf)
    v = torch.randn(4, 96, 8, 64, device=dev, generator=g).to(bf)
    pos = (torch.tensor([0, 17, 50, 93], device=dev)[:, None]
           + torch.arange(3, device=dev)).clamp(max=95).int()
    kw = {}
    if paged:
        pool_k, table = _paged_from_dense(k.float().cpu().numpy(), block_size=16)
        pool_v, _ = _paged_from_dense(v.float().cpu().numpy(), block_size=16)
        k = torch.from_numpy(pool_k).to(dev, bf)
        v = torch.from_numpy(pool_v).to(dev, bf)
        kw = dict(block_table=torch.from_numpy(table).to(dev), block_size=16)
    before = paged_decode.launches
    out = paged_decode.fused_decode_attention(q, k, v, pos, **kw)
    ref = paged_decode.fused_decode_attention_plain(
        q.float(), k.float(), v.float(), pos, **kw)
    torch.cuda.synchronize()
    assert paged_decode.launches == before + 1
    tol = 2 ** -8 * ref.abs() + 2 ** -6 * ref.abs().amax(dim=-1, keepdim=True)
    assert ((out.float() - ref).abs() <= tol).all()
