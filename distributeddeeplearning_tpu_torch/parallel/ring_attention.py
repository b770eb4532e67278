"""Ring attention over a ``seq`` group: the port of the JAX package's
``parallel/ring_attention.py``.

Each rank holds a ``T/n`` shard of Q, K and V (rank ``i`` of the group
holds tokens ``[i·T/n, (i+1)·T/n)``). The K/V shards travel round the
ring (``collectives.exchange``: send to the next rank, receive from the
previous one); at every step each rank folds the visiting shard into
its online softmax (running row max ``m``, normaliser ``l``, an f32
accumulator), with the causal mask in global token coordinates. After
``n`` steps every query row has seen the whole sequence and no rank held
more than one ``[T/n, T/n]`` block of scores. The block products are
plain ``torch.matmul`` in f32, as JAX's einsums are (no Pallas kernel
there either); a block wholly above the causal diagonal contributes
exact zeros, so it is skipped.

Autograd does not run through point-to-point transfers, so the backward
is written out (:class:`_RingAttention`, the counterpart of JAX's
transpose of ``ppermute``): the ring turns again, each visiting K/V
shard carrying the dK/dV accumulated for it so far; each rank adds its
queries' contribution (from the saved row statistics ``m + log l``) and
passes both on, and after ``n`` steps every shard's dK/dV is home.

:func:`ring_axis` sets the group the model's ``impl="ring"`` attention
and its positions read (the sp engine enters it around each forward);
:func:`axis_index` is this rank's index on it (``lax.axis_index``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.parallel import collectives

_NEG_INF = -1e30

# (group, size, index, next rank, previous rank) of the active ring.
_RING: contextvars.ContextVar = contextvars.ContextVar("ring_axis", default=None)


@contextlib.contextmanager
def ring_axis(group):
    """Run ``impl="ring"`` attention over ``group`` inside (``None``:
    a ring of one rank)."""
    if group is None:
        ring = (None, 1, 0, None, None)
    else:
        ranks = dist.get_process_group_ranks(group)
        i = ranks.index(dist.get_rank())
        ring = (group, len(ranks), i, ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)])
    token = _RING.set(ring)
    try:
        yield
    finally:
        _RING.reset(token)


def _active():
    ring = _RING.get()
    if ring is None:
        raise ValueError("attention impl 'ring' runs inside a sequence-parallel step "
                         "(parallel/ring_attention.ring_axis): no ring axis is active")
    return ring


def axis_index() -> int:
    """This rank's index on the active ring (its sequence shard)."""
    return _active()[2]


def _rotate(tensors, nxt, prv):
    """Send each tensor to the next rank and receive its replacement
    from the previous one."""
    if nxt is None:
        return tensors
    bufs = [torch.empty_like(t) for t in tensors]
    collectives.exchange([(t, nxt) for t in tensors], [(b, prv) for b in bufs])
    return bufs


def _scores(q32, kc, scale, causal, my, src, t):
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kc.float()) * scale
    if causal and src == my:
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
    return s


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, ring):
        _, n, my, nxt, prv = ring
        b, t, h, d = q.shape
        q32 = q.float()
        m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for step in range(n):
            src = (my - step) % n  # the visiting shard came from rank src
            if not (causal and src > my):
                s = _scores(q32, kc, scale, causal, my, src, t)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
                m = m_new
            if step < n - 1:
                kc, vc = _rotate([kc, vc], nxt, prv)
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        out32 = acc / l_safe[..., None]  # [b, h, t, d]
        lse = m + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal, ctx.scale, ctx.ring = causal, scale, ring
        return out32.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out32, lse = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        _, n, my, nxt, prv = ctx.ring
        t = q.shape[1]
        q32 = q.float()
        do = dout.float().transpose(1, 2)  # [b, h, t, d]
        delta = (do * out32).sum(-1)  # [b, h, t]
        dq = torch.zeros_like(q32)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            src = (my - step) % n
            if not (causal and src > my):
                s = _scores(q32, kc, scale, causal, my, src, t)
                p = torch.exp(s - lse[..., None])  # [b, h, q, k]
                dv = dv + torch.einsum("bhqk,bhqd->bkhd", p, do)
                dp = torch.einsum("bhqd,bkhd->bhqk", do, vc.float())
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kc.float())
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            # the shard, with what it has gathered, moves on; after n
            # moves it is home
            kc, vc, dk, dv = _rotate([kc, vc, dk, dv], nxt, prv)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over local BTHD shards on the active
    ring (:func:`ring_axis`); the local output shard ``[b, T/n, h, d]``
    in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"expected BTHD [b, t, h, d], got shape {tuple(q.shape)}")
    ring = _active()
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, causal, float(scale), ring)

