"""Shared streaming-dataset machinery: cursor contract + batch slicing.

Both streamed datasets (tokens.py, records.py) are thin subclasses:
this base owns the ``(seed, epoch, offset)`` cursor contract the
training loop and checkpoint manifest consume, the global-batch
geometry, and the process-contiguous slicing that makes the delivered
global batch process-count-independent (shuffle.py). A subclass only
assembles records into its batch tuple.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

from distributeddeeplearning_tpu_torch.data.stream.index import ShardIndex
from distributeddeeplearning_tpu_torch.data.stream.shuffle import (
    BlockShuffle,
    StreamCursor,
)


def _check_divisible(global_batch_size: int, process_count: int) -> None:
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{process_count} processes"
        )


class StreamDatasetBase:
    """Seekable streamed dataset over a :class:`ShardIndex`.

    Contract consumed by ``training/loop.fit`` (duck-typed; legacy
    datasets carry none of it and keep the replay path):

    * ``epoch(e)`` / ``epoch_at(e, start_step)`` — the epoch stream,
      optionally entered at batch ``start_step`` in O(1) (no record
      reads for the skipped prefix);
    * ``cursor(e, step)`` — the manifest's ``data_cursor`` dict;
    * ``host_prefetch`` — marker: wrap iteration in the background host
      reader (``prefetch.host_prefetch``), real IO overlaps compute.
    """

    host_prefetch = True

    def __init__(
        self,
        index: ShardIndex,
        *,
        global_batch_size: int,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        shuffle_block: int = 256,
    ):
        _check_divisible(global_batch_size, process_count)
        self.index = index
        self.global_batch_size = int(global_batch_size)
        self.local_batch_size = self.global_batch_size // int(process_count)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.seed = int(seed)
        if index.total_records < self.global_batch_size:
            raise ValueError(
                f"stream at {index.root} has {index.total_records} records "
                f"< global batch {self.global_batch_size}"
            )
        # Full batches only (the train contract shared by every reader);
        # the epoch tail shorter than one global batch is dropped.
        self.steps_per_epoch = index.total_records // self.global_batch_size
        self._shuffle = BlockShuffle(
            index.total_records, seed=self.seed, block_size=shuffle_block
        )
        self.shuffle_block = self._shuffle.block

    def __len__(self) -> int:
        return self.index.total_records

    def cursor(self, epoch: int, step_in_epoch: int) -> Dict[str, Any]:
        """The checkpoint manifest's ``data_cursor``: enough to re-enter
        the stream bitwise on ANY process count, plus the identity
        fields a restore cross-checks (seed / record count / block) so a
        cursor from a *different* stream is detected, not silently
        decoded."""
        c = StreamCursor(self.seed, int(epoch), int(step_in_epoch)).to_dict()
        c.update(
            kind=self.index.kind,
            records=self.index.total_records,
            shuffle_block=self.shuffle_block,
            global_batch=self.global_batch_size,
        )
        return c

    def epoch(self, epoch_index: int = 0) -> Iterator[Tuple]:
        return self.epoch_at(epoch_index, 0)

    def epoch_at(self, epoch_index: int, start_step: int) -> Iterator[Tuple]:
        """The epoch-``epoch_index`` stream entered at batch
        ``start_step`` — the O(1) resume entry point: position
        ``start_step * global_batch`` is computed, not replayed, and no
        skipped record is ever read (shuffle.py)."""
        if not 0 <= start_step <= self.steps_per_epoch:
            raise IndexError(
                f"start_step {start_step} out of range "
                f"[0, {self.steps_per_epoch}]"
            )
        order = self._shuffle.epoch_order(epoch_index)
        b = self.local_batch_size
        for step in range(start_step, self.steps_per_epoch):
            # This process's contiguous slice of the GLOBAL batch —
            # concatenated over processes, every world size delivers the
            # same global batch (elastic contract, docs/DATA.md).
            start = step * self.global_batch_size + self.process_index * b
            yield self._assemble(order.positions(start, start + b))

    def __iter__(self):
        return self.epoch(0)

    def _assemble(self, record_ids) -> Tuple:
        raise NotImplementedError
