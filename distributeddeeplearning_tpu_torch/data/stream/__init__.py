"""Streamed data plane: sharded shards + O(1) checkpointable shuffle;
the port of the JAX package's ``data/stream/``, with its shard format.

The production input tier (docs/DATA.md): token shards
for LM pretraining and record shards for vision, read through an
on-disk index (``index.py``) with a deterministic, checkpointable
global shuffle (``shuffle.py`` — the stream position is the compact
cursor ``(seed, epoch, offset)`` saved in the checkpoint manifest, so
mid-epoch resume seeks in O(1) instead of replaying the epoch prefix)
and host-overlapped prefetch (``prefetch.py``, ``data.*`` gauges).

Select with ``DATA_FORMAT=stream`` (auto-detected from a
``stream_index.json`` in ``DATA_DIR``); build shard sets with
``python -m distributeddeeplearning_tpu_torch.streamgen`` or the writer
functions here.
"""

from distributeddeeplearning_tpu_torch.data.stream.index import (
    INDEX_BASENAME,
    ShardIndex,
    StreamFormatError,
    is_stream_dir,
    load_index,
    write_record_shards,
    write_token_shards,
)
from distributeddeeplearning_tpu_torch.data.stream.prefetch import host_prefetch
from distributeddeeplearning_tpu_torch.data.stream.records import (
    RecordStreamDataset,
    synthetic_records,
)
from distributeddeeplearning_tpu_torch.data.stream.shuffle import (
    BlockShuffle,
    StreamCursor,
)
from distributeddeeplearning_tpu_torch.data.stream.tokens import (
    TokenStreamDataset,
    corpus_to_rows,
    synthetic_rows,
)


def open_stream_dataset(root: str, **kw):
    """Open the shard set at ``root`` as the right dataset for its
    ``kind`` (the factory ``data.make_dataset`` routes
    ``DATA_FORMAT=stream`` through). Token streams reject image-only
    kwargs and vice versa — filtered here so the factory can pass one
    uniform set."""
    index = load_index(root)
    if index.kind == "tokens":
        kw.pop("image_dtype", None)
        kw.pop("one_hot", None)
        return TokenStreamDataset(index, **kw)
    return RecordStreamDataset(index, **kw)


__all__ = [
    "BlockShuffle",
    "INDEX_BASENAME",
    "RecordStreamDataset",
    "ShardIndex",
    "StreamCursor",
    "StreamFormatError",
    "TokenStreamDataset",
    "corpus_to_rows",
    "host_prefetch",
    "is_stream_dir",
    "load_index",
    "open_stream_dataset",
    "synthetic_records",
    "synthetic_rows",
    "write_record_shards",
    "write_token_shards",
]
