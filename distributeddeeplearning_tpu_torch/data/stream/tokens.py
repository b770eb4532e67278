"""Streamed token shards — the LM-pretraining input tier.

``TokenStreamDataset`` reads ``[seq_len+1]`` int32 rows from the shard
set (index.py), shuffled by the checkpointable block permutation
(shuffle.py), and yields the repo's token batch contract
``(tokens[:, :-1], tokens[:, 1:])`` — drop-in for
``SyntheticTokenDataset`` everywhere (``loop._init_spec`` reads
``seq_len``, the engines' CE loss consumes the shifted pair), but
backed by real bytes on disk with an O(1)-seekable cursor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from distributeddeeplearning_tpu_torch.data.stream.index import (
    ShardIndex,
    StreamFormatError,
    load_index,
)
from distributeddeeplearning_tpu_torch.data.stream.reader import StreamDatasetBase


class TokenStreamDataset(StreamDatasetBase):
    def __init__(
        self,
        root_or_index,
        *,
        global_batch_size: int,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        shuffle_block: int = 256,
    ):
        index = (
            root_or_index
            if isinstance(root_or_index, ShardIndex)
            else load_index(root_or_index)
        )
        if index.kind != "tokens":
            raise StreamFormatError(
                f"{index.root}: kind {index.kind!r} is not a token stream"
            )
        super().__init__(
            index,
            global_batch_size=global_batch_size,
            seed=seed,
            process_index=process_index,
            process_count=process_count,
            shuffle_block=shuffle_block,
        )
        (row_len,), _ = index.fields["tokens"]
        self.seq_len = int(row_len) - 1
        self.vocab_size = int(index.meta.get("vocab_size", 0)) or None

    def _assemble(self, record_ids) -> Tuple[np.ndarray, np.ndarray]:
        rows = self.index.read("tokens", record_ids)
        return rows[:, :-1], rows[:, 1:]


def corpus_to_rows(
    data: bytes, *, seq_len: int, stride: Optional[int] = None
) -> np.ndarray:
    """Chop a byte corpus into overlapping ``[seq_len+1]`` next-token
    rows (byte-level vocab 256). ``stride`` defaults to ``seq_len`` so
    consecutive rows share exactly the one-token target overlap; the
    trailing partial window is dropped."""
    stride = int(stride or seq_len)
    if stride < 1 or seq_len < 1:
        raise ValueError(f"seq_len/stride must be >= 1 ({seq_len}/{stride})")
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    n = (len(arr) - (seq_len + 1)) // stride + 1
    if n < 1:
        raise ValueError(
            f"corpus of {len(arr)} bytes too short for one "
            f"[{seq_len + 1}]-token row"
        )
    starts = np.arange(n, dtype=np.int64) * stride
    return arr[starts[:, None] + np.arange(seq_len + 1)]


def synthetic_rows(
    n_records: int, *, seq_len: int, vocab_size: int, seed: int = 42
) -> np.ndarray:
    """Seeded random rows — the shard-backed analogue of
    ``SyntheticTokenDataset``'s pool (test fixtures, stream_bench)."""
    rng = np.random.RandomState(seed)
    return rng.randint(
        0, vocab_size, size=(n_records, seq_len + 1)
    ).astype(np.int32)
