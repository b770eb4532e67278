"""Host->device staging of the port's training batches.

The JAX package assembles global ``jax.Array``s from per-process numpy
shards. Here each process (one per GPU) owns its slice of the global
batch: :func:`shard_batch` cuts it, :func:`to_device` stages it through
pinned host memory with a non-blocking copy (:func:`prefetch_to_device`
does the host part ahead, in a thread), and the train step normalises
raw-byte batches on the device (:func:`normalize_staged_images`).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Tuple

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.config import IMAGENET_RGB_MEAN, IMAGENET_RGB_SD


def staging_dtype(config) -> np.dtype:
    """Numpy dtype the synthetic images are staged in: uint8 for
    ``input_staging="uint8"`` (normalised on the device), else float32.
    A bf16 compute dtype casts on the device (the model's first op), so
    the values equal the JAX package's bf16 staging; the copy moves
    twice its bytes."""
    if config.input_staging not in ("auto", "uint8", "float32", "bfloat16"):
        raise ValueError(f"unknown input_staging {config.input_staging!r}")
    return np.dtype(np.uint8 if config.input_staging == "uint8" else np.float32)


def shard_batch(batch: Tuple[np.ndarray, ...], rank: int, world_size: int):
    """This rank's contiguous slice of a global batch (the rows the JAX
    package's batch sharding places on device ``rank``)."""
    b = batch[0].shape[0]
    if b % world_size:
        raise ValueError(f"global batch {b} not divisible by {world_size} ranks")
    n = b // world_size
    return tuple(x[rank * n:(rank + 1) * n] for x in batch)


def _host(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if device.type == "cuda" else t


def prefetch_to_device(it: Iterable[Tuple[np.ndarray, ...]], device,
                       size: int = 2) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Yield the batches of ``it`` on ``device``. A daemon thread runs
    the iterator and pins up to ``size`` batches ahead (the host work,
    overlapping the running step); each is copied to the device with a
    non-blocking copy on the consumer's current stream when taken.
    Closing the generator stops the thread."""
    device = torch.device(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    end = object()
    err: list = []
    cancelled = threading.Event()

    def put(item) -> bool:
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if not put(tuple(_host(x, device) for x in batch)):
                    return
        except Exception as e:  # raised again on the consumer side
            err.append(e)
        finally:
            put(end)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield tuple(t.to(device, non_blocking=True) for t in item)
    finally:
        cancelled.set()


def to_device(batch: Tuple[np.ndarray, ...], device) -> Tuple[Any, ...]:
    """Stage a numpy batch ``(images NHWC, labels[, weights])`` on
    ``device``: images stay NHWC (the layout the port's ResNet takes),
    through pinned memory and a non-blocking copy on the current
    stream, so a later kernel on that stream sees the data."""
    device = torch.device(device)
    return tuple(_host(x, device).to(device, non_blocking=True) for x in batch)


def normalize_staged_images(images: torch.Tensor) -> torch.Tensor:
    """A uint8 NHWC batch (raw RGB bytes) becomes torchvision-normalised
    f32, ``(x/255 - mean)/sd``; anything else passes through."""
    if images.dtype != torch.uint8 or images.dim() != 4:
        return images
    mean, sd = _normalization(images.device)
    return (images.to(torch.float32) / 255.0 - mean) / sd


_NORMALIZATION: dict = {}


def _normalization(device: torch.device):
    """The mean and sd on ``device``, copied there once: a captured step
    (``metrics.StepFn.aot_compile``) may not copy from the host."""
    got = _NORMALIZATION.get(device)
    if got is None:
        got = _NORMALIZATION[device] = tuple(
            torch.tensor(v, dtype=torch.float32, device=device)
            for v in (IMAGENET_RGB_MEAN, IMAGENET_RGB_SD))
    return got
