"""Real ImageNet input pipelines, per-process sharded: the port of the
JAX package's ``data/imagenet.py``, batch for batch.

Three readers, each satisfying the loop's ``EpochDataset`` protocol and
yielding numpy NHWC batches (``(images, labels)`` for train,
``(images, labels, weights)`` for exact-coverage eval):

* :class:`ImageFolderDataset`: directory-of-class-dirs layout, PIL
  decode on a thread or spawned-process pool (``WORKER_MODE``),
  capability parity with the reference's Keras
  ``ImageDataGenerator.flow_from_directory`` (``imagenet_keras_horovod.
  py:119-148``) and PyTorch ``ImageFolder`` (``imagenet_pytorch_horovod.
  py:283-309``), including their augmentations and the per-rank sharding
  of ``DistributedSampler`` (``:258-264``).
* :class:`TFRecordImageNetDataset`: tf.data over TFRecord shards
  (TensorFlow imported when one is built), the reference TF script's
  pipeline (``_create_data_fn`` ``imagenet_estimator_tf_horovod.py:
  235-281``).
* :class:`NativeTFRecordImageNetDataset`: the same shards with no
  TensorFlow: the native tier's index (``native/``), the Example codec
  and the PIL transforms of :class:`ImageFolderDataset`.

Preprocessing constants match the reference exactly: torchvision
mean/sd (PyTorch ``:41-42``), 0.875 center fraction for eval (Keras
``:119-131``), random-resized-crop + horizontal flip for train. The
augmentation draws come from ``numpy.random.default_rng`` seeded by
``(seed, epoch, record, process)``, so thread and process workers, and
this package and the JAX one, give the same pixels.
"""

from __future__ import annotations

import concurrent.futures
import glob as globlib
import multiprocessing
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from distributeddeeplearning_tpu_torch.config import (
    IMAGENET_RGB_MEAN,
    IMAGENET_RGB_SD,
)

_MEAN = np.asarray(IMAGENET_RGB_MEAN, np.float32)
_SD = np.asarray(IMAGENET_RGB_SD, np.float32)
_EVAL_CENTER_FRACTION = 0.875  # Keras val zoom (imagenet_keras_horovod.py:126)

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _read_count_metadata(files: Sequence[str]) -> Optional[int]:
    """Read the record count written by ``prepare.py`` (count.txt next to
    the shards) to avoid a full scan at construction time."""
    for d in {os.path.dirname(f) for f in files}:
        path = os.path.join(d, "count.txt")
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    return int(fh.read().strip())
            except (OSError, ValueError):
                return None
    return None


def _list_samples(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """Scan ``root/<class>/<image>`` exactly like Keras/torch ImageFolder:
    classes are sorted directory names mapped to contiguous ids."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    samples: List[Tuple[str, int]] = []
    for idx, cls in enumerate(classes):
        for name in sorted(os.listdir(os.path.join(root, cls))):
            if name.lower().endswith(IMG_EXTENSIONS):
                samples.append((os.path.join(root, cls, name), idx))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")
    return samples, classes


def _random_resized_crop(img, size: int, rng: np.random.Generator):
    """Inception-style crop: area in [0.08, 1], aspect in [3/4, 4/3]
    (what torchvision's RandomResizedCrop — the reference PyTorch
    transform ``:302-308`` — does)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(0.08, 1.0)
        log_ratio = rng.uniform(np.log(3 / 4), np.log(4 / 3))
        aspect = np.exp(log_ratio)
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x = rng.integers(0, w - cw + 1)
            y = rng.integers(0, h - ch + 1)
            return img.resize(
                (size, size), Image.BILINEAR, box=(x, y, x + cw, y + ch)
            )
    # fallback: center crop
    return _center_crop_resize(img, size)


def _center_crop_resize(img, size: int):
    from PIL import Image

    w, h = img.size
    short = min(w, h)
    crop = int(short * _EVAL_CENTER_FRACTION)
    x = (w - crop) // 2
    y = (h - crop) // 2
    return img.resize((size, size), Image.BILINEAR, box=(x, y, x + crop, y + crop))


def _transform_pil(
    img, size: int, train: bool, rng: np.random.Generator,
    normalize: bool = True,
) -> np.ndarray:
    """Augment (and, unless staging raw uint8 bytes, normalize) an open
    PIL image — shared by the path-based and TFRecord-payload decoders.
    ``normalize=False`` returns the augmented uint8 pixels untouched;
    the engines then fold (x/255 − mean)/sd into the first device pass
    (``data/pipeline.normalize_staged_images``)."""
    from PIL import Image

    img = img.convert("RGB")
    if train:
        img = _random_resized_crop(img, size, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
    else:
        img = _center_crop_resize(img, size)
    if not normalize:
        return np.asarray(img, np.uint8)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - _MEAN) / _SD


def _load_image(
    path: str, size: int, train: bool, rng: np.random.Generator,
    normalize: bool = True,
) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return _transform_pil(img, size, train, rng, normalize=normalize)


def _check_batch_divisible(global_batch_size: int, process_count: int) -> None:
    """Config-error check, callable BEFORE any expensive dataset scan —
    a bad batch/process combination must fail in milliseconds, not after
    indexing a full ImageNet's worth of shards."""
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{process_count} processes"
        )


def _epoch_plan(
    length: int, global_batch_size: int, process_count: int, train: bool
) -> Tuple[int, int]:
    """(local_batch_size, steps_per_epoch) — the one place the sizing
    contract lives for every reader: global batch must divide across
    processes; train floors to full batches; eval ceils (exact coverage
    via pad+mask of the trailing batch)."""
    _check_batch_divisible(global_batch_size, process_count)
    if train:
        steps = max(length // global_batch_size, 1)
    else:
        steps = -(-length // global_batch_size)
    return global_batch_size // process_count, steps


# Worker-process decode target: the bound decode method is shipped ONCE
# per worker via the pool initializer (pickling it per task would pickle
# the whole dataset each time) — the Keras-reference MULTIPROCESSING
# workers pattern (imagenet_keras_horovod.py:44-46, :332-342).
_WORKER_DECODE = None


def _set_worker_decode(decode):
    global _WORKER_DECODE
    _WORKER_DECODE = decode


def _call_worker_decode(args):
    ridx, epoch_index = args
    return _WORKER_DECODE(ridx, epoch_index)


def make_decode_pool(num_workers: int, decode):
    """Spawned worker pool with ``decode`` shipped once via initializer
    (the Keras-reference MULTIPROCESSING workers pattern). Datasets cache
    one of these across epochs so the spawn cost is paid once."""
    return concurrent.futures.ProcessPoolExecutor(
        max(num_workers, 1),
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_set_worker_decode,
        initargs=(decode,),
    )


def _threaded_epoch_batches(
    *,
    n_records: int,
    train: bool,
    seed: int,
    epoch_index: int,
    process_index: int,
    process_count: int,
    local_batch_size: int,
    steps_per_epoch: int,
    num_workers: int,
    decode,
    worker_mode: str = "thread",
    pool=None,
):
    """Shared epoch loop for the PIL-decoding datasets (ImageFolder and
    native TFRecord): the same permutation on every process (seeded by
    epoch, like ``DistributedSampler.set_epoch``, reference ``:353-354``),
    a disjoint round-robin slice per process, modulo-wrap for train, and
    pad+mask (absolute record 0 as the dummy) for exact-coverage eval.

    ``decode(record_index, epoch_index) -> (image, label)`` supplies the
    storage-specific read+augment.

    ``worker_mode``: ``"thread"`` (default — PIL releases the GIL during
    libjpeg decompression, so threads scale across cores for the decode
    itself) or ``"process"`` (the reference Keras path's
    ``MULTIPROCESSING`` workers — sidesteps the GIL entirely for the
    Python-side transform/augment code at the cost of spawn startup per
    epoch; identical batches either way).
    """
    if worker_mode not in ("thread", "process"):
        raise ValueError(
            f"worker_mode must be 'thread' or 'process', got {worker_mode!r}"
        )
    order = np.arange(n_records)
    if train:
        np.random.RandomState((seed + epoch_index) % (2**31 - 1)).shuffle(order)
    local = order[process_index::process_count]
    if train and len(local) == 0:
        raise ValueError(
            f"process {process_index}/{process_count} owns none of the "
            f"{n_records} records — reduce process_count or add data"
        )
    b = local_batch_size

    owns_pool = pool is None
    if worker_mode == "process":
        if pool is None:
            pool = make_decode_pool(num_workers, decode)

        def submit(idxs):
            # chunk tasks per worker: one IPC round-trip per chunk, not
            # per image (256 messages/step otherwise)
            return pool.map(
                _call_worker_decode,
                [(int(i), epoch_index) for i in idxs],
                chunksize=max(1, len(idxs) // (max(num_workers, 1) * 4)),
            )

    else:
        if pool is None:
            pool = concurrent.futures.ThreadPoolExecutor(max(num_workers, 1))

        def submit(idxs):
            return pool.map(lambda i: decode(int(i), epoch_index), idxs)

    # try/finally, not a with-block: an abandoned generator (a prefetch
    # consumer stopping mid-epoch) must shut its workers down at close()
    # time deterministically — and only when the pool is epoch-local; a
    # caller-owned pool (dataset cache, reused across epochs to skip the
    # per-epoch spawn cost) outlives the generator.
    try:
        for step in range(steps_per_epoch):
            if train:
                idxs = [local[(step * b + j) % len(local)] for j in range(b)]
                results = list(submit(idxs))
                yield (
                    np.stack([r[0] for r in results]),
                    np.asarray([r[1] for r in results], np.int32),
                )
            else:
                # Eval: slots past this process's share are zero-weight
                # padding (decode absolute record 0 as a dummy).
                slots = np.arange(step * b, step * b + b)
                weights = (slots < len(local)).astype(np.float32)
                idxs = [
                    local[s] if s < len(local) else 0 for s in slots
                ]
                results = list(submit(idxs))
                yield (
                    np.stack([r[0] for r in results]),
                    np.asarray([r[1] for r in results], np.int32),
                    weights,
                )
    finally:
        if owns_pool:
            pool.shutdown(wait=True)


class ImageFolderDataset:
    """Directory-layout ImageNet with threaded PIL decode."""

    def __init__(
        self,
        root: str,
        *,
        global_batch_size: int,
        image_size: int = 224,
        train: bool = True,
        seed: int = 42,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        image_dtype=np.float32,
        worker_mode: str = "thread",
    ):
        _check_batch_divisible(global_batch_size, process_count)
        self.image_dtype = np.dtype(image_dtype)
        self.worker_mode = worker_mode
        self.samples, self.classes = _list_samples(root)
        self.num_classes = len(self.classes)
        self.global_batch_size = global_batch_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size, self.steps_per_epoch = _epoch_plan(
            len(self.samples), global_batch_size, process_count, train
        )

    def __len__(self) -> int:
        return len(self.samples)

    def _decode_sample(self, sample_idx: int, epoch_index: int):
        path, label = self.samples[sample_idx]
        rng = np.random.default_rng(
            (self.seed, epoch_index, int(sample_idx), self.process_index)
        )
        img = _load_image(
            path, self.image_size, self.train, rng,
            normalize=self.image_dtype != np.uint8,
        )
        # Cast per-image inside the pool: stack() in the epoch loop then
        # builds the batch directly at the staging dtype (bf16 = half the
        # allocation), instead of a serial full-batch astype.
        return img.astype(self.image_dtype, copy=False), label

    def _worker_pool(self):
        """process mode: ONE spawned pool cached across epochs (spawn
        startup is paid once, not per epoch); thread pools
        are cheap and stay epoch-local."""
        if self.worker_mode != "process":
            return None
        if getattr(self, "_pool", None) is None:
            self._pool = make_decode_pool(self.num_workers, self._decode_sample)
        return self._pool

    def __getstate__(self):
        # the initializer ships the bound decode method (= this object)
        # to spawned workers; the executor itself must not ride along
        state = self.__dict__.copy()
        state.pop("_pool", None)
        return state

    def close(self):
        """Shut the cached worker pool down. Not safe mid-epoch: a live
        epoch generator holds the pool and would fail on its next batch
        (it also holds ``self``, so GC/``__del__`` can't fire while one
        is alive — only an explicit mid-epoch ``close()`` can race)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            self._pool = None
            pool.shutdown(wait=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def epoch(self, epoch_index: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        yield from _threaded_epoch_batches(
            n_records=len(self.samples),
            train=self.train,
            seed=self.seed,
            epoch_index=epoch_index,
            process_index=self.process_index,
            process_count=self.process_count,
            local_batch_size=self.local_batch_size,
            steps_per_epoch=self.steps_per_epoch,
            num_workers=self.num_workers,
            decode=self._decode_sample,
            worker_mode=self.worker_mode,
            pool=self._worker_pool(),
        )

    def __iter__(self):
        return self.epoch(0)


class TFRecordImageNetDataset:
    """tf.data pipeline over TFRecord shards (performance path).

    Record format (written by ``data/prepare.py``): features
    ``image/encoded`` (JPEG bytes) and ``image/class/label`` (int64).
    Mirrors the reference TF pipeline's structure — interleaved shard
    reads, shuffle 1024, fused map+batch, prefetch (``imagenet_estimator_
    tf_horovod.py:249-259``) — with the per-host ``shard()`` the
    reference delegated to Horovod's sampler.
    """

    def __init__(
        self,
        file_pattern: str,
        *,
        global_batch_size: int,
        image_size: int = 224,
        train: bool = True,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        length: Optional[int] = None,
        shuffle_buffer: int = 1024,
        image_dtype=np.float32,
    ):
        _check_batch_divisible(global_batch_size, process_count)
        import tensorflow as tf

        tf.config.set_visible_devices([], "GPU")  # host-side pipeline only
        files = sorted(globlib.glob(file_pattern))
        if not files:
            raise FileNotFoundError(f"no TFRecord files match {file_pattern}")
        self._tf = tf
        self._tf_image_dtype = tf.dtypes.as_dtype(np.dtype(image_dtype))
        self.files = files
        self.global_batch_size = global_batch_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.shuffle_buffer = shuffle_buffer
        if length is None:
            length = _read_count_metadata(files)
        if length is None:
            # Last resort: a framing-only scan via the native TFRecord
            # indexer (csrc/ddl_native.cpp) — no proto parsing, no
            # tf.data graph. prepare.py writes count.txt precisely so
            # real runs rarely hit even this.
            from distributeddeeplearning_tpu_torch.native import count_records

            length = sum(count_records(f) for f in files)
        self.length = length
        self.local_batch_size, self.steps_per_epoch = _epoch_plan(
            length, global_batch_size, process_count, train
        )

    def _parse(self, record, training: bool):
        tf = self._tf
        feats = tf.io.parse_single_example(
            record,
            {
                "image/encoded": tf.io.FixedLenFeature([], tf.string),
                "image/class/label": tf.io.FixedLenFeature([], tf.int64),
            },
        )
        image = feats["image/encoded"]
        size = self.image_size
        if training:
            # Inception-style distorted bounding box crop.
            shape = tf.io.extract_jpeg_shape(image)
            bbox = tf.constant([0.0, 0.0, 1.0, 1.0], shape=[1, 1, 4])
            begin, extent, _ = tf.image.sample_distorted_bounding_box(
                shape,
                bounding_boxes=bbox,
                area_range=(0.08, 1.0),
                aspect_ratio_range=(3 / 4, 4 / 3),
                max_attempts=10,
                use_image_if_no_bounding_boxes=True,
            )
            y, x, _ = tf.unstack(begin)
            h, w, _ = tf.unstack(extent)
            image = tf.image.decode_and_crop_jpeg(
                image, tf.stack([y, x, h, w]), channels=3
            )
            image = tf.image.resize(image, (size, size))
            image = tf.image.random_flip_left_right(image)
        else:
            image = tf.image.decode_jpeg(image, channels=3)
            image = tf.image.central_crop(
                tf.cast(image, tf.float32), _EVAL_CENTER_FRACTION
            )
            image = tf.image.resize(image, (size, size))
        if self._tf_image_dtype == tf.uint8:
            # raw-byte staging: normalize happens on device
            # (data/pipeline.normalize_staged_images)
            image = tf.cast(
                tf.clip_by_value(tf.round(image), 0.0, 255.0), tf.uint8
            )
        else:
            image = tf.cast(image, tf.float32) / 255.0
            image = (image - _MEAN) / _SD
            # Stage at the model's compute dtype (bf16 halves host->device
            # bytes).
            image = tf.cast(image, self._tf_image_dtype)
        label = tf.cast(feats["image/class/label"], tf.int32)
        return image, label

    def epoch(self, epoch_index: int = 0):
        tf = self._tf
        if self.train:
            ds = tf.data.Dataset.from_tensor_slices(self.files)
            ds = ds.shard(self.process_count, self.process_index)
            ds = ds.shuffle(len(self.files), seed=self.seed + epoch_index)
            ds = ds.interleave(
                tf.data.TFRecordDataset,
                cycle_length=tf.data.AUTOTUNE,
                num_parallel_calls=tf.data.AUTOTUNE,
            )
            # Every process MUST yield exactly steps_per_epoch batches: a
            # host whose file shard is smaller would otherwise stop early
            # while others enter another compiled step, and the in-step
            # collective would hang the pod. repeat() wraps short shards;
            # take() truncates long ones.
            ds = ds.repeat()
            ds = ds.shuffle(self.shuffle_buffer, seed=self.seed + epoch_index)
            ds = ds.map(
                lambda r: self._parse(r, True),
                num_parallel_calls=tf.data.AUTOTUNE,
            )
            ds = ds.batch(self.local_batch_size, drop_remainder=True)
            ds = ds.take(self.steps_per_epoch)
            ds = ds.prefetch(tf.data.AUTOTUNE)
            for images, labels in ds.as_numpy_iterator():
                yield images, labels
            return

        # Eval: exact coverage. Shard by *record* (round-robin over the
        # sequential concatenation of shards — every record lands on
        # exactly one process regardless of uneven file sizes), then pad
        # each process's stream to the common padded length with
        # zero-weight dummies so all hosts step in lockstep.
        p, n = self.process_index, self.process_count
        size = self.image_size
        ds = tf.data.TFRecordDataset(self.files)
        ds = ds.shard(n, p)
        ds = ds.map(
            lambda r: self._parse(r, False),
            num_parallel_calls=tf.data.AUTOTUNE,
        )
        ds = ds.map(lambda im, lb: (im, lb, tf.ones((), tf.float32)))
        # Unbounded pad + take() below: every process yields exactly
        # steps_per_epoch batches even if self.length (count.txt / user
        # arg) disagrees with the shards — a short process would
        # otherwise hang the pod in the eval psum.
        pad = tf.data.Dataset.from_tensors(
            (
                tf.zeros((size, size, 3), self._tf_image_dtype),
                tf.zeros((), tf.int32),
                tf.zeros((), tf.float32),
            )
        ).repeat()
        ds = ds.concatenate(pad)
        ds = ds.batch(self.local_batch_size, drop_remainder=True)
        ds = ds.take(self.steps_per_epoch)
        ds = ds.prefetch(tf.data.AUTOTUNE)
        for images, labels, weights in ds.as_numpy_iterator():
            yield images, labels, weights

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        return self.epoch(0)


class NativeTFRecordImageNetDataset:
    """TFRecord pipeline with **no TensorFlow dependency**.

    Built on the first-party native tier: the C++ indexer
    (``csrc/ddl_native.cpp``) maps every shard once at construction
    (offset+length per record, optional CRC verify), records are read by
    seek, decoded by the hand-rolled Example codec
    (``native/example_proto.py``), and JPEGs decode/augment on a thread
    pool with the same transforms as :class:`ImageFolderDataset` (exact
    same normalization constants and Inception crop).

    Sharding is by *record* round-robin (like this module's tf.data eval
    path): every record lands on exactly one process regardless of
    uneven shard files. Train floors to ``steps_per_epoch`` full batches
    (wrapping the local slice); eval is exact-coverage with zero-weight
    padding. Yields the same numpy batch contract as the other datasets.
    """

    def __init__(
        self,
        file_pattern: str,
        *,
        global_batch_size: int,
        image_size: int = 224,
        train: bool = True,
        seed: int = 42,
        num_workers: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        image_dtype=np.float32,
        verify: bool = False,
        worker_mode: str = "thread",
    ):
        from distributeddeeplearning_tpu_torch.native import index_tfrecord

        _check_batch_divisible(global_batch_size, process_count)
        files = sorted(globlib.glob(file_pattern))
        if not files:
            raise FileNotFoundError(f"no TFRecord files match {file_pattern}")
        self.files = files
        self.image_dtype = np.dtype(image_dtype)
        self.global_batch_size = global_batch_size
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.num_workers = max(num_workers, 1)
        self.worker_mode = worker_mode
        self.process_index = process_index
        self.process_count = process_count

        file_ids, offsets, lengths = [], [], []
        for fi, f in enumerate(files):
            offs, lens = index_tfrecord(f, verify=verify)
            file_ids.append(np.full(len(offs), fi, np.int32))
            offsets.append(offs)
            lengths.append(lens)
        self._file_of = np.concatenate(file_ids)
        self._offset = np.concatenate(offsets)
        self._length = np.concatenate(lengths)
        self.length = int(self._file_of.shape[0])
        if self.length == 0:
            raise FileNotFoundError(f"no records in {file_pattern}")
        self.local_batch_size, self.steps_per_epoch = _epoch_plan(
            self.length, global_batch_size, process_count, train
        )

    def __len__(self) -> int:
        return self.length

    def _decode_record(self, ridx: int, epoch_index: int) -> Tuple[np.ndarray, int]:
        import io

        from PIL import Image

        from distributeddeeplearning_tpu_torch.native.example_proto import parse_example

        with open(self.files[self._file_of[ridx]], "rb") as f:
            f.seek(int(self._offset[ridx]))
            payload = f.read(int(self._length[ridx]))
        feats = parse_example(payload)
        encoded = feats["image/encoded"]
        label = int(feats["image/class/label"][0])
        rng = np.random.default_rng(
            (self.seed, epoch_index, int(ridx), self.process_index)
        )
        with Image.open(io.BytesIO(encoded)) as img:
            arr = _transform_pil(
                img, self.image_size, self.train, rng,
                normalize=self.image_dtype != np.uint8,
            )
        return arr.astype(self.image_dtype, copy=False), label

    def _worker_pool(self):
        """See ``ImageFolderDataset._worker_pool``."""
        if self.worker_mode != "process":
            return None
        if getattr(self, "_pool", None) is None:
            self._pool = make_decode_pool(self.num_workers, self._decode_record)
        return self._pool

    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_pool", None)
        return state

    def close(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            self._pool = None
            pool.shutdown(wait=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def epoch(self, epoch_index: int = 0):
        yield from _threaded_epoch_batches(
            n_records=self.length,
            train=self.train,
            seed=self.seed,
            epoch_index=epoch_index,
            process_index=self.process_index,
            process_count=self.process_count,
            local_batch_size=self.local_batch_size,
            steps_per_epoch=self.steps_per_epoch,
            num_workers=self.num_workers,
            decode=self._decode_record,
            worker_mode=self.worker_mode,
            pool=self._worker_pool(),
        )

    def __iter__(self):
        return self.epoch(0)
