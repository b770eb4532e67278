"""On-disk shard index + memory-mapped shard reading.

The streamed data plane's storage contract (docs/DATA.md "Streamed
shards"): a directory of fixed-record binary shard files described by
one ``stream_index.json``. Records are fixed-shape, fixed-dtype rows —
token rows ``[seq_len+1] int32`` for the LM tier, ``image``/``label``
field pairs for vision — so a record id maps to a byte offset by
arithmetic alone and reading is a ``np.memmap`` gather with **zero
decode work and zero copies beyond the batch assembly**. That is what
makes the shuffle cursor's O(1) seek real: seeking never touches the
skipped records' bytes.

Index schema (``stream_index.json``, one JSON object)::

    {"magic": "ddl-stream", "format": 1, "kind": "tokens" | "records",
     "fields": {"tokens": {"shape": [129], "dtype": "int32"}},
     "seq_len": 128, "vocab_size": 32000,          # kind == tokens
     "image_size": 224, "num_classes": 1000,       # kind == records
     "shards": [{"prefix": "shard-00000", "records": 8192}, ...],
     "total_records": 1048576}

Each shard contributes one raw little-endian C-order file per field,
``<prefix>.<field>.bin``, of exactly ``records * record_bytes`` bytes —
validated eagerly at open so a truncated or swapped file fails with the
file named, not as garbage batches mid-epoch.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

INDEX_BASENAME = "stream_index.json"
MAGIC = "ddl-stream"
INDEX_FORMAT = 1


class StreamFormatError(ValueError):
    """A shard set that cannot be trusted: missing/corrupt index,
    truncated shard file, field/shape mismatch. Always names the file
    and the expectation it violated."""


def _field_spec(name: str, spec: Dict[str, Any]) -> Tuple[Tuple[int, ...], np.dtype]:
    try:
        shape = tuple(int(d) for d in spec["shape"])
        dtype = np.dtype(spec["dtype"])
    except (KeyError, TypeError, ValueError) as e:
        raise StreamFormatError(
            f"stream index field {name!r} has a malformed spec {spec!r}: {e}"
        ) from e
    return shape, dtype


class ShardIndex:
    """A validated, readable shard set.

    Opening validates structure AND byte sizes up front (every
    ``<prefix>.<field>.bin`` must be exactly ``records x record_bytes``)
    so corruption is a clear error at open time; shard memmaps are
    created lazily and cached (an epoch touches shards as the shuffle
    reaches them).
    """

    def __init__(self, root: str, meta: Dict[str, Any]):
        self.root = root
        self.meta = meta
        if meta.get("magic") != MAGIC:
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: magic "
                f"{meta.get('magic')!r} != {MAGIC!r} — not a stream shard set"
            )
        if int(meta.get("format", 0)) != INDEX_FORMAT:
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: format "
                f"{meta.get('format')!r} unsupported (have {INDEX_FORMAT})"
            )
        self.kind = meta.get("kind")
        if self.kind not in ("tokens", "records"):
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: kind "
                f"{self.kind!r} (have 'tokens', 'records')"
            )
        fields = meta.get("fields") or {}
        if not fields:
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: no fields declared"
            )
        self.fields: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {
            name: _field_spec(name, spec) for name, spec in fields.items()
        }
        shards = meta.get("shards") or []
        if not shards:
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: empty shard list"
            )
        self.shards: List[Dict[str, Any]] = []
        counts = []
        for s in shards:
            try:
                prefix, n = str(s["prefix"]), int(s["records"])
            except (KeyError, TypeError, ValueError) as e:
                raise StreamFormatError(
                    f"{os.path.join(root, INDEX_BASENAME)}: malformed shard "
                    f"entry {s!r}: {e}"
                ) from e
            if n < 1:
                raise StreamFormatError(
                    f"{os.path.join(root, INDEX_BASENAME)}: shard "
                    f"{prefix!r} declares {n} records"
                )
            self.shards.append({"prefix": prefix, "records": n})
            counts.append(n)
        # record id -> shard via one searchsorted over this cumsum.
        self._cum = np.cumsum(np.asarray(counts, np.int64))
        self.total_records = int(self._cum[-1])
        declared = meta.get("total_records")
        if declared is not None and int(declared) != self.total_records:
            raise StreamFormatError(
                f"{os.path.join(root, INDEX_BASENAME)}: total_records "
                f"{declared} != shard sum {self.total_records}"
            )
        self._validate_sizes()
        # field -> shard index -> memmap (lazy; memmaps cost a fd, not RAM)
        self._maps: Dict[Tuple[str, int], np.memmap] = {}

    def _validate_sizes(self) -> None:
        for s_i, s in enumerate(self.shards):
            for field, (shape, dtype) in self.fields.items():
                path = self.shard_path(s_i, field)
                record_bytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                want = s["records"] * record_bytes
                try:
                    have = os.path.getsize(path)
                except OSError as e:
                    raise StreamFormatError(
                        f"stream shard file missing: {path} ({e})"
                    ) from e
                if have != want:
                    raise StreamFormatError(
                        f"stream shard file corrupt: {path} is {have} bytes, "
                        f"index says {s['records']} records x {record_bytes} "
                        f"B = {want} bytes"
                    )

    def shard_path(self, shard_i: int, field: str) -> str:
        return os.path.join(
            self.root, f"{self.shards[shard_i]['prefix']}.{field}.bin"
        )

    def _memmap(self, field: str, shard_i: int) -> np.memmap:
        key = (field, shard_i)
        mm = self._maps.get(key)
        if mm is None:
            shape, dtype = self.fields[field]
            mm = np.memmap(
                self.shard_path(shard_i, field),
                dtype=dtype,
                mode="r",
                shape=(self.shards[shard_i]["records"], *shape),
            )
            self._maps[key] = mm
        return mm

    def read(self, field: str, record_ids: np.ndarray) -> np.ndarray:
        """Gather ``record_ids`` (any order, duplicates fine) for one
        field, preserving order — the batch-assembly primitive. Rows are
        grouped per shard so each memmap is fancy-indexed once."""
        if field not in self.fields:
            raise KeyError(
                f"unknown stream field {field!r} (have {sorted(self.fields)})"
            )
        ids = np.asarray(record_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.total_records):
            raise IndexError(
                f"record id out of range [0, {self.total_records}): "
                f"[{ids.min()}, {ids.max()}]"
            )
        shape, dtype = self.fields[field]
        out = np.empty((ids.size, *shape), dtype)
        shard_of = np.searchsorted(self._cum, ids, side="right")
        starts = self._cum - np.asarray(
            [s["records"] for s in self.shards], np.int64
        )
        for s_i in np.unique(shard_of):
            sel = shard_of == s_i
            rows = ids[sel] - starts[s_i]
            out[sel] = self._memmap(field, int(s_i))[rows]
        return out

    @property
    def nbytes(self) -> int:
        """Total payload bytes across every shard file (index metadata
        excluded) — what the writer reports and the prepare docs quote."""
        per_record = sum(
            int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            for shape, dtype in self.fields.values()
        )
        return self.total_records * per_record


def load_index(root: str) -> ShardIndex:
    """Open + validate the shard set under ``root``. Raises
    :class:`StreamFormatError` with the offending file named for every
    corruption mode (missing index, bad JSON, bad magic/format,
    missing/truncated shard files, shape mismatches)."""
    path = os.path.join(root, INDEX_BASENAME)
    try:
        with open(path) as f:
            meta = json.load(f)
    except OSError as e:
        raise StreamFormatError(
            f"no stream index at {path} ({e}) — build one with "
            f"python -m distributeddeeplearning_tpu_torch.streamgen"
        ) from e
    except json.JSONDecodeError as e:
        raise StreamFormatError(f"stream index unreadable: {path}: {e}") from e
    if not isinstance(meta, dict):
        raise StreamFormatError(
            f"stream index {path} must be one JSON object, got "
            f"{type(meta).__name__}"
        )
    return ShardIndex(root, meta)


def is_stream_dir(root: str) -> bool:
    """Cheap layout sniff for the data-format auto-detector."""
    return os.path.isfile(os.path.join(root, INDEX_BASENAME))


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _write_shards(
    out_dir: str,
    kind: str,
    fields: Dict[str, Tuple[Tuple[int, ...], str]],
    chunks: Iterable[Dict[str, np.ndarray]],
    *,
    shard_records: int,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Stream record chunks into ``shard_records``-sized shard files +
    the index. ``chunks`` yields dicts of per-field arrays with a shared
    leading record dim; chunks never need to align with shard
    boundaries (a chunk is split/merged as needed), so writers can feed
    whatever unit their source produces."""
    if shard_records < 1:
        raise ValueError(f"shard_records must be >= 1, got {shard_records}")
    os.makedirs(out_dir, exist_ok=True)
    specs = {
        name: (tuple(int(d) for d in shape), np.dtype(dt))
        for name, (shape, dt) in fields.items()
    }
    shard_list: List[Dict[str, Any]] = []
    open_files: Dict[str, Any] = {}
    in_shard = 0
    total = 0

    def _open_next() -> None:
        nonlocal in_shard
        prefix = f"shard-{len(shard_list):05d}"
        shard_list.append({"prefix": prefix, "records": 0})
        for name in specs:
            open_files[name] = open(
                os.path.join(out_dir, f"{prefix}.{name}.bin"), "wb"
            )
        in_shard = 0

    def _close_current() -> None:
        for f in open_files.values():
            f.close()
        open_files.clear()
        shard_list[-1]["records"] = in_shard

    for chunk in chunks:
        arrays = {}
        n = None
        for name, (shape, dtype) in specs.items():
            a = np.ascontiguousarray(chunk[name], dtype=dtype)
            if a.shape[1:] != shape:
                raise ValueError(
                    f"field {name!r} chunk shape {a.shape[1:]} != declared "
                    f"{shape}"
                )
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"field {name!r} chunk has {a.shape[0]} records, "
                    f"others have {n}"
                )
            arrays[name] = a
        pos = 0
        while pos < n:
            if not open_files:
                _open_next()
            take = min(shard_records - in_shard, n - pos)
            for name, a in arrays.items():
                open_files[name].write(a[pos:pos + take].tobytes())
            in_shard += take
            total += take
            pos += take
            if in_shard == shard_records:
                _close_current()
    if open_files:
        _close_current()
    if total == 0:
        raise ValueError("no records written — empty source")
    meta: Dict[str, Any] = {
        "magic": MAGIC,
        "format": INDEX_FORMAT,
        "kind": kind,
        "fields": {
            name: {"shape": list(shape), "dtype": dtype.name}
            for name, (shape, dtype) in specs.items()
        },
        "shards": shard_list,
        "total_records": total,
    }
    meta.update(extra_meta or {})
    with open(os.path.join(out_dir, INDEX_BASENAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def write_token_shards(
    out_dir: str,
    rows: Iterable[np.ndarray],
    *,
    seq_len: int,
    vocab_size: int,
    shard_records: int = 8192,
) -> Dict[str, Any]:
    """Write LM token shards: each record is one ``[seq_len+1]`` int32
    row (the +1 carries the next-token target — the dataset yields
    ``(row[:-1], row[1:])``). ``rows`` is an iterable of ``[k,
    seq_len+1]`` chunks (a single array works too)."""
    if isinstance(rows, np.ndarray):
        rows = [rows]
    return _write_shards(
        out_dir,
        "tokens",
        {"tokens": ((seq_len + 1,), "int32")},
        ({"tokens": chunk} for chunk in rows),
        shard_records=shard_records,
        extra_meta={"seq_len": int(seq_len), "vocab_size": int(vocab_size)},
    )


def write_record_shards(
    out_dir: str,
    chunks: Iterable[Tuple[np.ndarray, np.ndarray]],
    *,
    image_size: int,
    num_classes: int,
    channels: int = 3,
    shard_records: int = 1024,
) -> Dict[str, Any]:
    """Write vision record shards: ``image`` ``[H, W, C]`` uint8 (raw,
    un-normalized RGB — staging decides normalization, docs/DATA.md) +
    ``label`` scalar int32. ``chunks`` yields ``(images, labels)``
    pairs (one pair works too)."""
    if (
        isinstance(chunks, tuple)
        and len(chunks) == 2
        and isinstance(chunks[0], np.ndarray)
    ):
        chunks = [chunks]
    return _write_shards(
        out_dir,
        "records",
        {
            "image": ((image_size, image_size, channels), "uint8"),
            "label": ((), "int32"),
        },
        ({"image": im, "label": lb} for im, lb in chunks),
        shard_records=shard_records,
        extra_meta={
            "image_size": int(image_size), "num_classes": int(num_classes),
        },
    )
