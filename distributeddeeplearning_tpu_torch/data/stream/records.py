"""Streamed vision record shards — fixed-shape image/label records.

``RecordStreamDataset`` yields the vision batch contract
``(images, labels)`` from uint8 image + int32 label shard pairs. Images
are stored RAW (un-normalized RGB bytes); staging decides what crosses
the host→device link, exactly like the real readers (docs/DATA.md
``INPUT_STAGING``): a uint8 ``image_dtype`` passes bytes through for
on-device normalization, float dtypes get the torchvision
``(x/255 - mean)/sd`` on host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from distributeddeeplearning_tpu_torch.data.stream.index import (
    ShardIndex,
    StreamFormatError,
    load_index,
)
from distributeddeeplearning_tpu_torch.data.stream.reader import StreamDatasetBase


class RecordStreamDataset(StreamDatasetBase):
    def __init__(
        self,
        root_or_index,
        *,
        global_batch_size: int,
        seed: int = 42,
        process_index: int = 0,
        process_count: int = 1,
        shuffle_block: int = 256,
        image_dtype=np.float32,
        one_hot: bool = False,
    ):
        index = (
            root_or_index
            if isinstance(root_or_index, ShardIndex)
            else load_index(root_or_index)
        )
        if index.kind != "records":
            raise StreamFormatError(
                f"{index.root}: kind {index.kind!r} is not a record stream"
            )
        super().__init__(
            index,
            global_batch_size=global_batch_size,
            seed=seed,
            process_index=process_index,
            process_count=process_count,
            shuffle_block=shuffle_block,
        )
        self.image_size = int(index.meta.get("image_size", 0))
        self.num_classes = int(index.meta.get("num_classes", 0))
        self.image_dtype = np.dtype(image_dtype)
        self.one_hot = bool(one_hot)

    def _assemble(self, record_ids) -> Tuple[np.ndarray, np.ndarray]:
        images = self.index.read("image", record_ids)
        labels = self.index.read("label", record_ids)
        if self.image_dtype != np.uint8:
            from distributeddeeplearning_tpu_torch.config import (
                IMAGENET_RGB_MEAN,
                IMAGENET_RGB_SD,
            )

            mean = np.asarray(IMAGENET_RGB_MEAN, np.float32)
            sd = np.asarray(IMAGENET_RGB_SD, np.float32)
            images = (
                (images.astype(np.float32) / 255.0 - mean) / sd
            ).astype(self.image_dtype, copy=False)
        if self.one_hot:
            labels = np.eye(self.num_classes, dtype=np.float32)[labels]
        return images, labels


def synthetic_records(
    n_records: int,
    *,
    image_size: int,
    num_classes: int,
    channels: int = 3,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random (images, labels) in the raw-byte storage contract."""
    rng = np.random.RandomState(seed)
    images = rng.randint(
        0, 256, size=(n_records, image_size, image_size, channels)
    ).astype(np.uint8)
    labels = rng.randint(0, num_classes, size=(n_records,)).astype(np.int32)
    return images, labels
