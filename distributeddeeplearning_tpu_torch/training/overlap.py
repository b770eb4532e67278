"""Collective/compute overlap of the mesh engines' gradient reductions
(``ASYNC_COLLECTIVES``): the port of the JAX package's
``training/overlap.py``.

JAX tags its gradient reductions so that XLA can split each all-reduce
into a start/done pair and hide it under the rest of the backward. The
port does it by hand: :class:`GradReducer` packs the parameters into
buckets in reverse order (the order the backward produces their
gradients), and with ``enabled`` a gradient hook on each parameter
copies its gradient into its bucket's flat f32 buffer and, when the
bucket is full, issues the bucket's all-reduce with ``async_op=True``
while the backward goes on; :meth:`GradReducer.finish` waits for them
before the update. With ``enabled`` off one synchronous pass reduces the
same buckets after the backward. Both reduce the same buffers in the
same order, so they give the same bits.

Each parameter has its own rule: ``"mean"`` (summed over the group and
divided by its size: replicated parameters, and shards of tensor
parallelism, over the data axis) or ``"scale"`` (divided by the data
size only: FSDP shards, whose reduce-scatter already summed them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from distributeddeeplearning_tpu_torch.parallel import collectives

BUCKET_BYTES = 25 * 2**20


class GradReducer:
    """Bucketed mean of gradients over ``group`` (see module docstring)."""

    def __init__(self, params: Sequence[torch.Tensor], group, *, rules: Sequence[str],
                 divisor: int, enabled: bool = True, bucket_bytes: int = BUCKET_BYTES):
        self.params = list(params)
        self.group = group
        self.divisor = float(divisor)
        self.enabled = enabled and collectives.group_size(group) > 1
        self.rules = list(rules)
        self.buckets: List[List[int]] = []
        cur, size = [], 0
        for i in reversed(range(len(self.params))):
            if self.rules[i] != "mean":
                continue
            cur.append(i)
            size += self.params[i].numel() * 4
            if size >= bucket_bytes:
                self.buckets.append(cur)
                cur, size = [], 0
        if cur:
            self.buckets.append(cur)
        # each parameter's (bucket, offset), and the buckets' flat f32
        # buffers, fixed once and reused every step
        self._at = {}
        for b, idx in enumerate(self.buckets):
            off = 0
            for i in idx:
                self._at[i] = (b, off)
                off += self.params[i].numel()
        device = self.params[0].device if self.params else None
        self._flat = [torch.empty(sum(self.params[i].numel() for i in idx),
                                  dtype=torch.float32, device=device)
                      for idx in self.buckets] if collectives.group_size(group) > 1 else []
        self._handles = []
        self._reset()

    def _reset(self) -> None:
        self._seen = [0] * len(self.buckets)
        self._work: List[Optional[object]] = [None] * len(self.buckets)

    def _put(self, i: int, grad: torch.Tensor) -> None:
        b, off = self._at[i]
        self._flat[b][off:off + grad.numel()].copy_(grad.reshape(-1))
        self._seen[b] += 1
        if self.enabled and self._seen[b] == len(self.buckets[b]):
            self._work[b] = dist.all_reduce(self._flat[b], group=self.group, async_op=True)

    def arm(self) -> None:
        """Hook the parameters for one backward (``enabled`` only)."""
        self._reset()
        if not self.enabled:
            return
        for i in self._at:
            self._handles.append(self.params[i].register_hook(
                lambda g, i=i: self._put(i, g)))

    def finish(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The reduced gradients: ``"mean"`` ones from the buckets (the
        ones still unreduced are reduced now, synchronously, in bucket
        order; views of the buckets, valid until the next step's
        reduction), ``"scale"`` ones divided by the divisor."""
        for h in self._handles:
            h.remove()
        self._handles = []
        out = list(grads)
        for i, rule in enumerate(self.rules):
            if rule == "scale" and self.divisor != 1.0:
                out[i] = grads[i] / self.divisor
        if collectives.group_size(self.group) == 1:
            return out
        for b, idx in enumerate(self.buckets):
            if self._work[b] is None:
                if self._seen[b] != len(idx):  # sync mode: fill now
                    for i in idx:
                        self._put(i, grads[i])
                collectives.all_reduce(self._flat[b], self.group)
            else:
                self._work[b].wait()
            flat = self._flat[b]
            flat /= self.divisor
            for i in idx:
                off = self._at[i][1]
                out[i] = flat[off:off + grads[i].numel()].view_as(grads[i]).to(grads[i].dtype)
        self._reset()
        return out
