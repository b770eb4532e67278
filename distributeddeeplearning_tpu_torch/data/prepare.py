"""Dataset preparation tools — the reference's data-prep layer, as a CLI:
the port of the JAX package's ``data/prepare.py``, byte for byte in
what it writes.

Replaces the reference's data-prep components (SURVEY.md §2 "Data prep
pipeline"), covering the FULL path from the raw ILSVRC2012 distribution
tars to training-ready shards:

* ``ingest`` — the whole ``00_DataProcessing.ipynb`` flow in one
  command: extracts the train tar's nested per-class tars (cells 3-5),
  extracts the flat validation tar (cell 7), derives the 50k-image →
  wnid mapping from the official devkit (:func:`devkit_val_mapping` —
  the reference instead embeds the mapping as 50k generated ``mv``
  commands, ``valprep.sh:2-10``), sorts the validation images, and
  TFRecord-shards both splits. Raw tars → training, zero manual steps.
* ``valprep`` — ``valprep.sh`` parity on its own: :func:`sort_val_images`
  driven by a mapping file (``<image> <wnid>`` per line).
* ``tfrecords`` — ImageFolder → sharded TFRecords
  (:func:`write_tfrecords`), which ``TFRecordImageNetDataset`` reads at
  accelerator rate; the notebook's equivalent staging step was a re-tar
  for NFS (cells 12-13).

CLI::

    python -m distributeddeeplearning_tpu_torch.data.prepare ingest \
        --train-tar ILSVRC2012_img_train.tar \
        --val-tar ILSVRC2012_img_val.tar \
        --devkit ILSVRC2012_devkit_t12.tar.gz --out /data/imagenet
    python -m distributeddeeplearning_tpu_torch.data.prepare valprep \
        --val-dir ILSVRC2012_val --mapping val_wnids.txt --out val
    python -m distributeddeeplearning_tpu_torch.data.prepare tfrecords \
        --src train --out tfrecords/train --num-shards 1024
"""

from __future__ import annotations

import argparse
import io
import os
import shutil
import sys
import tarfile
from typing import List, Optional, Tuple


def sort_val_images(val_dir: str, mapping_file: str, out_dir: str) -> int:
    """Sort flat validation images into per-wnid dirs (valprep.sh parity).

    ``mapping_file`` lines: ``ILSVRC2012_val_00000001.JPEG n01751748``.
    Returns the number of files moved. Missing images are skipped with a
    report rather than failing the whole run (the Bash version just
    errored mid-way).
    """
    moved = 0
    missing = 0
    os.makedirs(out_dir, exist_ok=True)
    with open(mapping_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            image, wnid = parts
            src = os.path.join(val_dir, image)
            if not os.path.exists(src):
                missing += 1
                continue
            dst_dir = os.path.join(out_dir, wnid)
            os.makedirs(dst_dir, exist_ok=True)
            shutil.move(src, os.path.join(dst_dir, image))
            moved += 1
    if missing:
        print(f"warning: {missing} images in mapping not found", file=sys.stderr)
    return moved


def write_tfrecords(
    src_dir: str,
    out_dir: str,
    num_shards: int = 128,
    prefix: str = "imagenet",
    limit: Optional[int] = None,
) -> Tuple[int, List[str]]:
    """Convert an ImageFolder layout into sharded TFRecords.

    Writes ``{prefix}-{shard:05d}-of-{num_shards:05d}`` files whose
    records carry ``image/encoded`` (the original JPEG bytes — no
    re-encode) and ``image/class/label``. Returns (num_images, classes).

    The write path is TF-free: records are serialized by the first-party
    Example codec (``native/example_proto.py``) and framed by the native
    TFRecord writer (``csrc/ddl_native.cpp`` — crc32c in C++, pure-Python
    fallback otherwise); output is byte-compatible with
    ``tf.io.TFRecordWriter`` and readable by ``tf.data``.
    """
    from distributeddeeplearning_tpu_torch.data.imagenet import _list_samples
    from distributeddeeplearning_tpu_torch.native import write_tfrecord
    from distributeddeeplearning_tpu_torch.native.example_proto import encode_example

    samples, classes = _list_samples(src_dir)
    if limit:
        samples = samples[:limit]
    os.makedirs(out_dir, exist_ok=True)
    # One shard (and one open fd) at a time — a 1024-writer fan-out would
    # blow the default ulimit. Samples are interleaved across shards so
    # each shard stays class-balanced.
    chunk = 256  # bounded memory: ~chunk×image_size held at once, not a shard
    for shard in range(num_shards):
        shard_path = os.path.join(
            out_dir, f"{prefix}-{shard:05d}-of-{num_shards:05d}"
        )
        shard_samples = samples[shard::num_shards]
        write_tfrecord(shard_path, [])  # create/truncate
        for start in range(0, len(shard_samples), chunk):
            payloads = []
            for path, label in shard_samples[start : start + chunk]:
                with open(path, "rb") as f:
                    encoded = f.read()
                payloads.append(
                    encode_example(
                        {"image/encoded": encoded, "image/class/label": [label]}
                    )
                )
            write_tfrecord(shard_path, payloads, append=True)
    with open(os.path.join(out_dir, "classes.txt"), "w") as f:
        f.write("\n".join(classes) + "\n")
    with open(os.path.join(out_dir, "count.txt"), "w") as f:
        f.write(f"{len(samples)}\n")
    return len(samples), classes


def extract_train_tar(train_tar: str, out_dir: str) -> int:
    """ILSVRC2012_img_train.tar → ``out_dir/<wnid>/*.JPEG``.

    The distribution tar nests one tar per class
    (``00_DataProcessing.ipynb`` cells 3-5 extract twice via the shell);
    here the inner class tars stream straight from the outer file —
    nothing intermediate touches disk. Returns the image count.
    """
    count = 0
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(train_tar) as outer:
        for member in outer:
            if not member.isfile() or not member.name.endswith(".tar"):
                continue
            wnid = os.path.splitext(os.path.basename(member.name))[0]
            class_dir = os.path.join(out_dir, wnid)
            os.makedirs(class_dir, exist_ok=True)
            inner_fileobj = outer.extractfile(member)
            with tarfile.open(fileobj=inner_fileobj) as inner:
                for img in inner:
                    if not img.isfile():
                        continue
                    data = inner.extractfile(img).read()
                    name = os.path.basename(img.name)
                    with open(os.path.join(class_dir, name), "wb") as f:
                        f.write(data)
                    count += 1
    return count


def extract_val_tar(val_tar: str, out_dir: str) -> int:
    """ILSVRC2012_img_val.tar → flat ``out_dir/*.JPEG`` (notebook cell 7)."""
    count = 0
    os.makedirs(out_dir, exist_ok=True)
    with tarfile.open(val_tar) as tar:
        for member in tar:
            if not member.isfile():
                continue
            data = tar.extractfile(member).read()
            with open(
                os.path.join(out_dir, os.path.basename(member.name)), "wb"
            ) as f:
                f.write(data)
            count += 1
    return count


def devkit_val_mapping(devkit_path: str) -> List[Tuple[str, str]]:
    """(validation image name, wnid) pairs from the official devkit.

    Reads ``meta.mat`` (synset table: ILSVRC2012_ID ↔ WNID; the 1,000
    challenge classes are the leaf synsets) and
    ``ILSVRC2012_validation_ground_truth.txt`` (one ILSVRC2012_ID per
    image, in image order) out of ``ILSVRC2012_devkit_t12.tar.gz``.
    This replaces the reference's embedded mapping — its ``valprep.sh``
    hardcodes the same 50k assignments as generated ``mv`` lines.
    """
    from scipy.io import loadmat

    meta_bytes = None
    truth_lines = None
    with tarfile.open(devkit_path) as tar:
        for member in tar:
            if member.name.endswith("data/meta.mat"):
                meta_bytes = tar.extractfile(member).read()
            elif member.name.endswith("validation_ground_truth.txt"):
                truth_lines = (
                    tar.extractfile(member).read().decode().splitlines()
                )
    if meta_bytes is None or truth_lines is None:
        raise FileNotFoundError(
            f"{devkit_path} does not contain data/meta.mat and "
            "data/ILSVRC2012_validation_ground_truth.txt"
        )

    synsets = loadmat(io.BytesIO(meta_bytes))["synsets"]
    id_to_wnid = {}
    flat = synsets.reshape(-1)
    for row in flat:
        ilsvrc_id = int(row["ILSVRC2012_ID"].reshape(-1)[0])
        wnid = str(row["WNID"].reshape(-1)[0])
        num_children = int(row["num_children"].reshape(-1)[0])
        if num_children == 0:  # leaf = one of the 1,000 classes
            id_to_wnid[ilsvrc_id] = wnid

    mapping = []
    for i, line in enumerate(l for l in truth_lines if l.strip()):
        ilsvrc_id = int(line.strip())
        if ilsvrc_id not in id_to_wnid:
            raise ValueError(
                f"ground-truth id {ilsvrc_id} (image {i + 1}) is not a "
                "leaf synset in meta.mat"
            )
        mapping.append(
            (f"ILSVRC2012_val_{i + 1:08d}.JPEG", id_to_wnid[ilsvrc_id])
        )
    return mapping


def ingest(
    train_tar: str,
    val_tar: str,
    devkit: str,
    out_dir: str,
    num_shards: int = 128,
    val_shards: int = 16,
    tfrecords: bool = True,
) -> dict:
    """Raw ILSVRC2012 distribution → training-ready layout, one call.

    Produces ``out_dir/train/<wnid>/``, ``out_dir/validation/<wnid>/``
    (both directly usable by ``ImageFolderDataset``) and — unless
    ``tfrecords=False`` — ``out_dir/tfrecords/{train,validation}/``
    shards for ``TFRecordImageNetDataset``. Also writes the derived
    mapping to ``out_dir/val_wnids.txt`` for inspection/reuse.
    """
    train_dir = os.path.join(out_dir, "train")
    val_flat = os.path.join(out_dir, "_val_flat")
    val_dir = os.path.join(out_dir, "validation")
    # Devkit first: it is the cheap step and the likeliest bad argument —
    # failing after the multi-hour 1.28M-image train extraction would be
    # hostile.
    mapping = devkit_val_mapping(devkit)
    n_train = extract_train_tar(train_tar, train_dir)
    n_val = extract_val_tar(val_tar, val_flat)
    os.makedirs(out_dir, exist_ok=True)
    mapping_file = os.path.join(out_dir, "val_wnids.txt")
    with open(mapping_file, "w") as f:
        f.writelines(f"{img} {wnid}\n" for img, wnid in mapping)
    moved = sort_val_images(val_flat, mapping_file, val_dir)
    shutil.rmtree(val_flat)
    result = {"train_images": n_train, "val_images": n_val, "val_sorted": moved}
    if tfrecords:
        tf_root = os.path.join(out_dir, "tfrecords")
        result["train_tfrecords"], _ = write_tfrecords(
            train_dir, os.path.join(tf_root, "train"), num_shards
        )
        result["val_tfrecords"], _ = write_tfrecords(
            val_dir, os.path.join(tf_root, "validation"), val_shards
        )
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="prepare", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    vp = sub.add_parser("valprep", help="sort validation images into wnid dirs")
    vp.add_argument("--val-dir", required=True)
    vp.add_argument("--mapping", required=True)
    vp.add_argument("--out", required=True)

    tr = sub.add_parser("tfrecords", help="ImageFolder layout -> TFRecord shards")
    tr.add_argument("--src", required=True)
    tr.add_argument("--out", required=True)
    tr.add_argument("--num-shards", type=int, default=128)
    tr.add_argument("--prefix", default="imagenet")
    tr.add_argument("--limit", type=int, default=None)

    ig = sub.add_parser(
        "ingest", help="raw ILSVRC2012 tars + devkit -> training-ready layout"
    )
    ig.add_argument("--train-tar", required=True)
    ig.add_argument("--val-tar", required=True)
    ig.add_argument("--devkit", required=True)
    ig.add_argument("--out", required=True)
    ig.add_argument("--num-shards", type=int, default=128)
    ig.add_argument("--val-shards", type=int, default=16)
    ig.add_argument(
        "--no-tfrecords", action="store_true",
        help="stop at the ImageFolder layout (skip shard writing)",
    )

    args = p.parse_args(argv)
    if args.cmd == "ingest":
        stats = ingest(
            args.train_tar, args.val_tar, args.devkit, args.out,
            num_shards=args.num_shards, val_shards=args.val_shards,
            tfrecords=not args.no_tfrecords,
        )
        print(" ".join(f"{k}={v}" for k, v in sorted(stats.items())))
    elif args.cmd == "valprep":
        n = sort_val_images(args.val_dir, args.mapping, args.out)
        print(f"moved {n} images")
    elif args.cmd == "tfrecords":
        n, classes = write_tfrecords(
            args.src, args.out, args.num_shards, args.prefix, args.limit
        )
        print(f"wrote {n} images, {len(classes)} classes -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
