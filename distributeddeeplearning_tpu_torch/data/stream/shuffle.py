"""Deterministic, checkpointable global shuffle — the O(1) cursor.

The stream's epoch-``e`` order is a seeded **block permutation** of the
record ids ``[0, N)``: records are grouped into blocks of
``block_size`` (``STREAM_SHUFFLE_BLOCK``), the block ORDER is permuted
by ``(seed, epoch)`` and each block's contents by ``(seed, epoch,
block)``. Two properties fall out:

* **The stream position IS the cursor.** ``position -> record id`` is a
  pure function of ``(seed, epoch, position)``, so resume state is the
  compact triple ``(seed, epoch, offset)`` saved in the checkpoint
  manifest (``data_cursor``) — seeking re-derives the mapping instead
  of replaying the epoch prefix. Seek cost is O(N/block) once per epoch
  (the block-order table) plus O(block) per block touched — **zero
  record reads, zero per-skipped-batch work**; contrast the legacy
  datasets' O(step) prefix replay (docs/DATA.md).
* **Process-count independence by construction.** The permutation is a
  single GLOBAL sequence; a process slices its contiguous share of each
  global batch (``tokens.py``/``records.py``), so any world size
  delivers bit-identical global batches — elastic shrink/grow continues
  the same stream (the ``DATA_TOPOLOGY=global`` contract, extended to
  real data).

Shuffle quality is the standard two-level trade (tf.data/Grain use the
same scheme): records mix globally at block granularity and perfectly
within blocks; ``block_size >= N`` degenerates to one exact global
permutation (what the tests pin), small blocks bound the working set a
sequential reader touches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

_M31 = 2**31 - 1


def _rng(*parts: int) -> np.random.RandomState:
    """Seeded generator from mixed integer coordinates (repo idiom:
    arithmetic-mixed ``RandomState`` seeds, e.g. synthetic.py's
    ``idx_seed + 7919 * epoch``)."""
    h = 0
    for p in parts:
        h = (h * 1_000_003 + int(p) + 0x9E3779B1) % _M31
    return np.random.RandomState(h)


@dataclasses.dataclass(frozen=True)
class StreamCursor:
    """The checkpointable stream position: ``offset`` batches of the
    ``(seed, epoch)`` stream have been consumed. Serialized into the
    checkpoint manifest's ``data_cursor`` (host ints only)."""

    seed: int
    epoch: int
    offset: int

    def to_dict(self) -> Dict[str, int]:
        return {
            "seed": int(self.seed),
            "epoch": int(self.epoch),
            "offset": int(self.offset),
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["StreamCursor"]:
        if not d:
            return None
        try:
            return cls(int(d["seed"]), int(d["epoch"]), int(d["offset"]))
        except (KeyError, TypeError, ValueError):
            return None


class BlockShuffle:
    """``(seed, epoch, position) -> record id`` over ``[0, n_records)``."""

    def __init__(self, n_records: int, *, seed: int, block_size: int):
        if n_records < 1:
            raise ValueError(f"n_records must be >= 1, got {n_records}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n = int(n_records)
        self.seed = int(seed)
        self.block = min(int(block_size), self.n)
        self.n_blocks = -(-self.n // self.block)

    def epoch_order(self, epoch: int) -> "_EpochOrder":
        return _EpochOrder(self, int(epoch))


class _EpochOrder:
    """One epoch's materialized block-order table + a small cache of
    within-block permutations (consecutive positions share blocks, so
    the cache makes sequential iteration O(1) amortized per record)."""

    def __init__(self, shuffle: BlockShuffle, epoch: int):
        self._s = shuffle
        self.epoch = epoch
        # Block order + cumulative output sizes: O(n_blocks) once per
        # epoch — independent of the seek offset.
        self._order = _rng(shuffle.seed, epoch).permutation(shuffle.n_blocks)
        sizes = np.full(shuffle.n_blocks, shuffle.block, np.int64)
        sizes[-1] = shuffle.n - (shuffle.n_blocks - 1) * shuffle.block
        self._cum = np.cumsum(sizes[self._order])
        self._sizes = sizes
        self._perms: Dict[int, np.ndarray] = {}

    def _block_perm(self, block: int) -> np.ndarray:
        perm = self._perms.get(block)
        if perm is None:
            perm = _rng(self._s.seed, self.epoch, 7919 * block + 1).permutation(
                int(self._sizes[block])
            )
            if len(self._perms) >= 8:  # bound: sequential reads need ~1-2
                self._perms.pop(next(iter(self._perms)))
            self._perms[block] = perm
        return perm

    def positions(self, start: int, stop: int) -> np.ndarray:
        """Record ids for stream positions ``[start, stop)`` — the O(1)
        seek: cost scales with ``stop - start`` and the blocks it spans,
        never with ``start``."""
        if not 0 <= start <= stop <= self._s.n:
            raise IndexError(
                f"stream positions [{start}, {stop}) out of range "
                f"[0, {self._s.n}]"
            )
        out = np.empty(stop - start, np.int64)
        pos = start
        while pos < stop:
            j = int(np.searchsorted(self._cum, pos, side="right"))
            base = int(self._cum[j - 1]) if j else 0
            block = int(self._order[j])
            take = min(int(self._cum[j]) - pos, stop - pos)
            off = pos - base
            out[pos - start:pos - start + take] = (
                block * self._s.block + self._block_perm(block)[off:off + take]
            )
            pos += take
        return out
