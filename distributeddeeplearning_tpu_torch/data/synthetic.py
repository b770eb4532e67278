"""Seeded synthetic images with a virtual length: the port of the JAX
package's ``data/synthetic.SyntheticImageDataset``, batch for batch.

A small physical pool of seeded random images is indexed through a
seeded translation index of virtual length N, so an epoch has realistic
size without disk. The pool comes from the splitmix64 fill
(``native.fill_uniform``), the labels, the translation index and the
per-epoch permutation from ``numpy.random.RandomState``, exactly as in
the JAX package, so both yield the same numpy NHWC batches bit for bit.
``SyntheticTokenDataset`` comes with the LM-training slice.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from distributeddeeplearning_tpu_torch.native import fill_uniform


def _check_divisible(global_batch_size: int, process_count: int) -> None:
    if global_batch_size % process_count != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {process_count} processes"
        )


def _virtual_translation(seed: int, process_index: int, pool_n: int,
                         local_len: int) -> Tuple[int, np.ndarray]:
    """The virtual->physical translation index: a per-process seed offset
    so processes draw disjoint streams, sized to the local share."""
    idx_seed = (seed + 1 + process_index) % (2**31 - 1)
    translation = np.random.RandomState(idx_seed).randint(
        0, pool_n, size=(max(local_len, 1),))
    return idx_seed, translation


def _check_topology(topology: str) -> str:
    if topology not in ("process", "global"):
        raise ValueError(f"data topology must be 'process' or 'global', got {topology!r}")
    return topology


def _epoch_permutation(idx_seed: int, translation: np.ndarray, epoch_index: int) -> np.ndarray:
    """Deterministic per-epoch reshuffle of the translation index."""
    return np.random.RandomState(
        (idx_seed + 7919 * epoch_index) % (2**31 - 1)).permutation(translation)


class SyntheticImageDataset:
    """Seeded random images + labels with a virtual length.

    ``length`` is the virtual dataset size (``FAKE_DATA_LENGTH``),
    ``num_physical_batches`` the real pool size. ``topology="process"``
    gives each process its own disjoint stream; ``"global"`` one stream
    of global batches, each process taking its contiguous slice.
    ``exact=True`` serves every virtual sample once, the last batch
    padded and zero-weighted (then batches are ``(images, labels,
    weights)``). Images are float32 in [-1, 1] or, with
    ``dtype=np.uint8``, raw bytes in [0, 255]; the layout is NHWC.
    """

    def __init__(self, *, length: int = 1_281_167, global_batch_size: int,
                 image_size: int = 224, num_classes: int = 1000, channels: int = 3,
                 num_physical_batches: int = 20, seed: int = 42, process_index: int = 0,
                 process_count: int = 1, one_hot: bool = False, exact: bool = False,
                 dtype=np.float32, topology: str = "process"):
        _check_divisible(global_batch_size, process_count)
        dtype = np.dtype(dtype)
        if dtype not in (np.dtype(np.float32), np.dtype(np.uint8)):
            raise NotImplementedError(
                f"image dtype {dtype}: the port stages float32 or uint8 images "
                f"(bf16 staging casts on the device, data/pipeline.to_device)")
        self.length = length
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.image_size = image_size
        self.num_classes = num_classes
        self.one_hot = one_hot
        self.process_index = process_index
        self.process_count = process_count
        self.topology = _check_topology(topology)

        rng = np.random.RandomState(seed)
        pool_batch = global_batch_size if self.topology == "global" else self.local_batch_size
        pool_n = num_physical_batches * pool_batch
        u = fill_uniform((pool_n, image_size, image_size, channels), seed=seed)
        if dtype == np.uint8:
            self._images = (u * np.float32(255.0)).astype(np.uint8)
        else:
            self._images = u * np.float32(2.0) - np.float32(1.0)
        del u
        self._labels = rng.randint(0, num_classes, size=(pool_n,)).astype(np.int32)
        self.exact = exact
        if self.topology == "global":
            self.steps_per_epoch = (-(-length // global_batch_size) if exact
                                    else max(length // global_batch_size, 1))
            self._idx_seed, self._translation_index = _virtual_translation(
                seed, 0, pool_n, length)
            self._local_len = length
        elif exact:
            local_len = (length - process_index + process_count - 1) // process_count
            self.steps_per_epoch = -(-length // global_batch_size)
            self._idx_seed, self._translation_index = _virtual_translation(
                seed, process_index, pool_n, local_len)
            self._local_len = local_len
        else:
            local_len = length // process_count
            self.steps_per_epoch = max(length // global_batch_size, 1)
            self._idx_seed, self._translation_index = _virtual_translation(
                seed, process_index, pool_n, local_len)
            self._local_len = local_len

    def __len__(self) -> int:
        return self.length

    def epoch(self, epoch_index: int = 0) -> Iterator[tuple]:
        """Yield ``steps_per_epoch`` local batches ``(images, labels)``
        (``+ weights`` when exact), deterministic in ``(seed,
        epoch_index, process_index)``."""
        b = self.local_batch_size
        index = _epoch_permutation(self._idx_seed, self._translation_index, epoch_index)
        for step in range(self.steps_per_epoch):
            if self.topology == "global":
                start = step * self.global_batch_size + self.process_index * b
            else:
                start = step * b
            slots = np.arange(start, start + b)
            sel = index[slots % len(index)]
            images = self._images[sel]
            labels = self._labels[sel]
            if self.one_hot:
                labels = np.eye(self.num_classes, dtype=np.float32)[labels]
            if self.exact:
                yield images, labels, (slots < self._local_len).astype(np.float32)
            else:
                yield images, labels

    def __iter__(self):
        return self.epoch(0)
