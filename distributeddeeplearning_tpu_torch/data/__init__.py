"""Data of the port: seeded synthetic images and tokens, the real-data
readers (``imagenet``: ImageFolder, tf.data and native TFRecord;
``stream``: token and record shards with the checkpointable cursor and
host prefetch), host->device staging, and the JAX package's dataset
factory (:func:`make_dataset`, :func:`make_input_fn`)."""

from typing import Optional

from distributeddeeplearning_tpu_torch.data.pipeline import (
    normalize_staged_images,
    prefetch_to_device,
    shard_batch,
    staging_dtype,
    to_device,
)
from distributeddeeplearning_tpu_torch.data.synthetic import (
    SyntheticImageDataset,
    SyntheticTokenDataset,
)


def make_dataset(config, train: bool = True):
    """The JAX package's ``make_dataset`` (``data/__init__.py:44-114``),
    honouring the reference's FAKE switch: synthetic when
    ``config.fake`` or the split has no data directory (the train stream
    of ``config.fake_data_length`` images from ``config.seed``; the eval
    stream from ``seed + 10_000``, ``max(fake_data_length // 25,
    global_batch)`` long and exact: every sample once, the last batch
    padded and zero-weighted), else the reader that
    :func:`_resolve_data_format` picks for ``config.data_dir`` (train) or
    ``config.val_data_dir`` (eval). This process's share comes from the
    ``torch.distributed`` rank and world size."""
    from distributeddeeplearning_tpu_torch.parallel import collectives

    dtype = staging_dtype(config)
    process_index, process_count = collectives.rank(), collectives.size()
    if config.fake or not (config.data_dir if train else config.val_data_dir):
        return SyntheticImageDataset(
            length=(config.fake_data_length if train
                    else max(config.fake_data_length // 25, config.global_batch_size)),
            global_batch_size=config.global_batch_size,
            image_size=config.image_size,
            num_classes=config.num_classes,
            seed=config.seed if train else config.seed + 10_000,
            process_index=process_index,
            process_count=process_count,
            exact=not train,
            dtype=dtype,
            topology=config.data_topology,
        )
    root = config.data_dir if train else config.val_data_dir
    pattern = _tfrecord_pattern(root)  # one directory scan, reused below
    fmt = _resolve_data_format(config, root, pattern)
    if fmt == "stream":
        # Token or record shards (the index's kind decides): global,
        # process-count-independent batches and the O(1) cursor.
        from distributeddeeplearning_tpu_torch.data.stream import open_stream_dataset

        return open_stream_dataset(
            root,
            global_batch_size=config.global_batch_size,
            seed=config.seed if train else config.seed + 10_000,
            process_index=process_index,
            process_count=process_count,
            shuffle_block=config.stream_shuffle_block,
            image_dtype=dtype,
        )
    common = dict(
        global_batch_size=config.global_batch_size,
        image_size=config.image_size,
        train=train,
        seed=config.seed,
        num_workers=config.num_workers,
        worker_mode=config.worker_mode,
        process_index=process_index,
        process_count=process_count,
        image_dtype=dtype,
    )
    if fmt == "imagefolder":
        from distributeddeeplearning_tpu_torch.data.imagenet import ImageFolderDataset

        return ImageFolderDataset(root, **common)
    if fmt == "tfrecord-native":
        from distributeddeeplearning_tpu_torch.data.imagenet import (
            NativeTFRecordImageNetDataset,
        )

        return NativeTFRecordImageNetDataset(pattern, **common)
    from distributeddeeplearning_tpu_torch.data.imagenet import TFRecordImageNetDataset

    common.pop("num_workers")  # tf.data autotunes its own parallelism
    common.pop("worker_mode")
    return TFRecordImageNetDataset(pattern, **common)


_TFRECORD_SUFFIXES = (".tfrecord", ".tfrecords")


def _tfrecord_pattern(root: str) -> str:
    """A concrete path/glob for the TFRecord readers: globs pass
    through, directories expand to their shard files (``prepare``'s
    ``{prefix}-NNNNN-of-NNNNN`` naming or ``*.tfrecord``)."""
    import glob
    import os

    if any(ch in root for ch in "*?["):
        return root
    if os.path.isdir(root):
        for pat in ("*-of-*", "*.tfrecord", "*.tfrecords"):
            if glob.glob(os.path.join(root, pat)):
                return os.path.join(root, pat)
    return root


def _resolve_data_format(config, root: str, pattern: Optional[str] = None) -> str:
    """``config.data_format``, with ``"auto"`` sniffing the layout:
    stream shards (a ``stream_index.json`` in the directory), TFRecord
    shards (a glob, or a directory holding shard-named files) or an
    ImageFolder class tree. ``auto`` prefers the tf.data reader where
    TensorFlow imports, else the native TF-free one; ``"tfrecord"``
    without TensorFlow raises ``ImportError`` rather than substituting
    the native reader (its JPEG decode differs from TF's by a few counts
    a pixel). JAX's ``_resolve_data_format``, rule for rule.

    ``pattern``: ``_tfrecord_pattern(root)`` if already computed, so the
    directory is scanned once."""
    if pattern is None:
        pattern = _tfrecord_pattern(root)
    fmt = config.data_format
    if fmt not in ("auto", "stream", "imagefolder", "tfrecord", "tfrecord-native"):
        raise ValueError(
            f"unknown data_format {fmt!r}; use auto | stream | "
            "imagefolder | tfrecord | tfrecord-native"
        )
    if fmt in ("imagefolder", "stream"):
        return fmt
    if fmt == "auto":
        import os
        import re

        from distributeddeeplearning_tpu_torch.data.stream import is_stream_dir

        if os.path.isdir(root) and is_stream_dir(root):
            return "stream"
        looks_tfrecord = (
            pattern != root
            or any(ch in root for ch in "*?[")
            or (not os.path.isdir(root)
                and (root.endswith(_TFRECORD_SUFFIXES)
                     # prepare's shard naming, e.g. imagenet-00000-of-01024
                     or re.search(r"-\d+-of-\d+$", root) is not None))
        )
        if not looks_tfrecord:
            return "imagefolder"
        try:
            import tensorflow  # noqa: F401

            return "tfrecord"
        except ImportError:
            return "tfrecord-native"
    if fmt == "tfrecord":
        try:
            import tensorflow  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "data_format='tfrecord' forces the tf.data reader but "
                "TensorFlow is not importable; use "
                "data_format='tfrecord-native' (TF-free) or 'auto'"
            ) from e
    return fmt


def make_input_fn(train: bool = True):
    """Estimator-style input_fn factory (reference ``_create_data_fn``/
    ``_create_fake_data_fn``, ``imagenet_estimator_tf_horovod.py:235-345``)."""
    return lambda config: make_dataset(config, train=train)


__all__ = [
    "SyntheticImageDataset",
    "SyntheticTokenDataset",
    "make_dataset",
    "make_input_fn",
    "normalize_staged_images",
    "prefetch_to_device",
    "shard_batch",
    "staging_dtype",
    "to_device",
]
