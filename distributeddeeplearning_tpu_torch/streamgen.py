"""Build stream shard sets (tokens or vision records) + their index: the
port's twin of ``scripts/streamgen.py``, writing the same bytes.

The shard-writer CLI of the streamed data plane (docs/DATA.md "Streamed
shards"): produces the ``stream_index.json`` + ``shard-*.{field}.bin``
layout that ``DATA_FORMAT=stream`` reads. Host tooling: numpy only.

Usage::

    # LM token shards from a byte-level corpus (vocab 256):
    python -m distributeddeeplearning_tpu_torch.streamgen tokens --out /data/stream/wiki \
        --corpus corpus1.txt corpus2.txt --seq-len 1024

    # ... or synthetically (seeded; test fixtures, benches):
    python -m distributeddeeplearning_tpu_torch.streamgen tokens --out /tmp/shards \
        --records 4096 --seq-len 128 --vocab 32000 --seed 42

    # Vision record shards (synthetic; real ImageNet rides
    # data/prepare.py's TFRecord path):
    python -m distributeddeeplearning_tpu_torch.streamgen records --out /tmp/imgshards \
        --records 4096 --image-size 64 --classes 100

Prints one JSON summary line (shards, records, bytes, out) — the same
one-line protocol every repo script speaks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _emit(meta: dict, out_dir: str) -> None:
    payload = sum(
        os.path.getsize(os.path.join(out_dir, f))
        for f in os.listdir(out_dir)
        if f.endswith(".bin")
    )
    print(
        json.dumps(
            {
                "out": out_dir,
                "kind": meta["kind"],
                "shards": len(meta["shards"]),
                "records": meta["total_records"],
                "bytes": payload,
            }
        )
    )


def gen_tokens(args) -> int:
    from distributeddeeplearning_tpu_torch.data.stream import (
        corpus_to_rows,
        synthetic_rows,
        write_token_shards,
    )

    if args.corpus:
        vocab = 256  # byte-level

        def chunks():
            for path in args.corpus:
                with open(path, "rb") as f:
                    yield corpus_to_rows(
                        f.read(), seq_len=args.seq_len, stride=args.stride
                    )

        rows = chunks()
    else:
        if not args.records:
            print(
                "ERROR: need --corpus FILE... or --records N",
                file=sys.stderr,
            )
            return 2
        vocab = args.vocab
        rows = [
            synthetic_rows(
                args.records,
                seq_len=args.seq_len,
                vocab_size=vocab,
                seed=args.seed,
            )
        ]
    meta = write_token_shards(
        args.out,
        rows,
        seq_len=args.seq_len,
        vocab_size=vocab,
        shard_records=args.shard_records,
    )
    _emit(meta, args.out)
    return 0


def gen_records(args) -> int:
    from distributeddeeplearning_tpu_torch.data.stream import (
        synthetic_records,
        write_record_shards,
    )

    images, labels = synthetic_records(
        args.records,
        image_size=args.image_size,
        num_classes=args.classes,
        seed=args.seed,
    )
    meta = write_record_shards(
        args.out,
        (images, labels),
        image_size=args.image_size,
        num_classes=args.classes,
        shard_records=args.shard_records,
    )
    _emit(meta, args.out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tokens", help="LM token shards ([seq_len+1] int32)")
    t.add_argument("--out", required=True)
    t.add_argument(
        "--corpus", nargs="+", default=None,
        help="byte-level corpus file(s) (vocab 256)",
    )
    t.add_argument("--records", type=int, default=0,
                   help="synthetic row count (no --corpus)")
    t.add_argument("--seq-len", type=int, default=128)
    t.add_argument("--stride", type=int, default=None,
                   help="corpus window stride (default: seq-len)")
    t.add_argument("--vocab", type=int, default=32_000,
                   help="synthetic vocab (corpus mode is byte-level 256)")
    t.add_argument("--shard-records", type=int, default=8192)
    t.add_argument("--seed", type=int, default=42)
    t.set_defaults(fn=gen_tokens)

    r = sub.add_parser(
        "records", help="vision record shards (uint8 image + int32 label)"
    )
    r.add_argument("--out", required=True)
    r.add_argument("--records", type=int, required=True)
    r.add_argument("--image-size", type=int, default=64)
    r.add_argument("--classes", type=int, default=100)
    r.add_argument("--shard-records", type=int, default=1024)
    r.add_argument("--seed", type=int, default=42)
    r.set_defaults(fn=gen_records)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
