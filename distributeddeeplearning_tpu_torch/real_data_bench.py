"""Real-data input-pipeline throughput: the port's twin of
``scripts/real_data_bench.py``.

Stages a real-JPEG dataset (synthetic images encoded as JPEG: it is
DECODE throughput that matters), then measures:

1. host-only decode+augment rate of each reader (ImageFolder with PIL on
   threads or spawned processes, tf.data TFRecord where TensorFlow
   imports, the native TFRecord reader): img/s and img/s/core;
2. host->device transfer rate of one batch per staging dtype;
3. end-to-end training img/s on the card with the real pipeline feeding
   the train step of fused ResNet-50 (the port's main path).

Usage::

    python -m distributeddeeplearning_tpu_torch.real_data_bench prepare [--images 2048] [--root DIR]
    python -m distributeddeeplearning_tpu_torch.real_data_bench host [--root DIR] [--steps 8]
    python -m distributeddeeplearning_tpu_torch.real_data_bench transfer [--batch 256]
    python -m distributeddeeplearning_tpu_torch.real_data_bench e2e [--root DIR] [--batch 256]

Default root: ``.benchdata/`` in the working directory (gitignored in
the repository). ``--image-size`` (224) sizes the prepared JPEGs and the
crops; ``BENCH_DEVICE`` (``cuda``) the device of ``transfer`` and
``e2e``; ``NUM_WORKERS`` (8) and ``INPUT_STAGING`` the ``e2e`` reader.
PIL is imported by ``prepare`` and by the readers' decode only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

DEFAULT_ROOT = os.path.join(os.getcwd(), ".benchdata")


def prepare(root: str, n_images: int, image_size: int = 224, classes: int = 8):
    """ImageFolder tree of JPEGs (smooth low-frequency content: random
    noise would be unrealistically slow to decode) + 8 TFRecord shards,
    the JAX script's images byte for byte."""
    from PIL import Image

    from distributeddeeplearning_tpu_torch.data.prepare import write_tfrecords

    folder = os.path.join(root, "imagefolder")
    rng = np.random.RandomState(42)
    for c in range(classes):
        os.makedirs(os.path.join(folder, f"class{c:03d}"), exist_ok=True)
    t0 = time.perf_counter()
    for i in range(n_images):
        c = i % classes
        # low-frequency pattern + mild noise ≈ natural-image entropy
        yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
        base = (
            127
            + 80 * np.sin(xx / (7 + c) + i)[..., None]
            * np.cos(yy / (11 + c))[..., None]
            + rng.normal(0, 12, (image_size, image_size, 3))
        )
        img = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
        img.save(os.path.join(folder, f"class{c:03d}", f"img{i:06d}.jpg"), quality=85)
    dt = time.perf_counter() - t0
    n, _ = write_tfrecords(folder, os.path.join(root, "tfrecords"), num_shards=8)
    sizes = []
    for dirpath, _, files in os.walk(folder):
        sizes += [os.path.getsize(os.path.join(dirpath, f)) for f in files]
    print(f"prepared {n} JPEGs ({np.mean(sizes) / 1024:.1f} KB avg) in {dt:.1f}s "
          f"+ 8 TFRecord shards under {root}", flush=True)
    return {"images": n, "jpeg_kb_mean": float(np.mean(sizes) / 1024), "write_s": dt}


def _rate(name: str, it, steps: int, warmup: int = 2) -> float:
    n, t0 = 0, None
    for i, item in enumerate(it):
        if i == warmup:
            t0 = time.perf_counter()
            n = 0
        if i >= warmup:
            n += item[0].shape[0]
        if i >= warmup + steps:
            break
    if t0 is None or n == 0:
        raise SystemExit(f"{name}: dataset too small for warmup={warmup} + measurement "
                         "— lower --batch or add --images")
    dt = time.perf_counter() - t0
    cores = os.cpu_count() or 1
    print(f"{name:32s} {n / dt:8.1f} img/s host-only "
          f"({n / dt / cores:.1f} img/s/core, {cores} cores)", flush=True)
    return n / dt


def host(root: str, steps: int, batch: int, workers: int, worker_mode: str,
         image_size: int = 224) -> dict:
    """Host-only img/s of each reader: ImageFolder, tf.data (where
    TensorFlow imports; else reported as skipped) and the native
    TFRecord reader through ``make_dataset``."""
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import make_dataset
    from distributeddeeplearning_tpu_torch.data.imagenet import (
        ImageFolderDataset,
        TFRecordImageNetDataset,
    )

    folder = os.path.join(root, "imagefolder")
    pattern = os.path.join(root, "tfrecords", "imagenet-*")
    results = {}
    ds = ImageFolderDataset(folder, global_batch_size=batch, image_size=image_size,
                            train=True, num_workers=workers, worker_mode=worker_mode)
    try:
        results["imagefolder"] = _rate(f"ImageFolder (PIL, {workers} {worker_mode}s)",
                                       ds.epoch(0), steps)
    finally:
        ds.close()
    try:
        import tensorflow  # noqa: F401
    except ImportError:
        print("TFRecord (tf.data) skipped: TensorFlow is not installed", flush=True)
    else:
        tfds = TFRecordImageNetDataset(pattern, global_batch_size=batch,
                                       image_size=image_size, train=True)
        results["tfrecord-tfdata"] = _rate("TFRecord (tf.data)", tfds.epoch(0), steps)
    cfg = TrainConfig(fake=False, data_dir=os.path.join(root, "tfrecords"),
                      data_format="tfrecord-native", batch_size_per_device=batch,
                      image_size=image_size, num_workers=workers, worker_mode=worker_mode)
    nds = make_dataset(cfg, train=True)
    try:
        results["tfrecord-native"] = _rate(
            f"TFRecord (native reader, {workers} {worker_mode}s)", nds.epoch(0), steps)
    finally:
        nds.close()
    return results


def transfer(batch: int, image_size: int = 224, reps: int = 12) -> dict:
    """Host->device rate of one batch per staging dtype, through
    ``data.to_device`` (pinned memory, a non-blocking copy): fenced (one
    copy at a time) and streamed (every copy enqueued, one fence)."""
    import torch

    from distributeddeeplearning_tpu_torch import bench
    from distributeddeeplearning_tpu_torch.data import to_device

    device = bench._device()
    rng = np.random.RandomState(0)
    base = rng.randint(0, 255, size=(batch, image_size, image_size, 3))
    labels = rng.randint(0, 1000, size=(batch,)).astype(np.int32)

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for name, arr in (("float32", base.astype(np.float32)), ("uint8", base.astype(np.uint8))):
        to_device((arr, labels), device)
        fence()
        t0 = time.perf_counter()
        for _ in range(reps):
            to_device((arr, labels), device)
            fence()
        fenced = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            to_device((arr, labels), device)
        fence()
        streamed = (time.perf_counter() - t0) / reps
        mb = arr.nbytes / 1e6
        out[name] = batch / streamed
        print(f"transfer {name:8s}: {mb:6.1f} MB/batch  fenced {fenced * 1e3:7.1f} ms "
              f"({batch / fenced:7.1f} img/s)  streamed {streamed * 1e3:7.1f} ms "
              f"({mb / streamed / 1e3:5.2f} GB/s, {batch / streamed:7.1f} img/s)", flush=True)
    return out


def e2e(root: str, batch: int, steps: int, image_size: int = 224, device=None) -> float:
    """Real pipeline -> device prefetch -> the train step of fused
    ResNet-50 (bf16) on ``device`` (default ``BENCH_DEVICE``).
    ``INPUT_STAGING=uint8`` stages raw bytes and normalises on the
    device."""
    import torch

    from distributeddeeplearning_tpu_torch import bench
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data import make_dataset, prefetch_to_device
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        make_train_step,
    )

    device = bench._device() if device is None else torch.device(device)
    cfg = TrainConfig(fake=False, data_dir=os.path.join(root, "imagefolder"),
                      batch_size_per_device=batch, image_size=image_size,
                      num_workers=int(os.environ.get("NUM_WORKERS", "8")),
                      input_staging=os.environ.get("INPUT_STAGING", "auto"))
    data = make_dataset(cfg, train=True)
    model = get_model("resnet50", num_classes=1000, dtype=cfg.compute_dtype, fused=True,
                      device=device)
    tx, _ = create_optimizer(cfg, steps_per_epoch=data.steps_per_epoch)
    state = create_train_state(model, cfg, tx, device=device)
    step = make_train_step(model, tx, cfg, device=device)

    seen, t0 = 0, None
    warmup = 2
    metrics = None
    for i, staged in enumerate(prefetch_to_device(data.epoch(0), device,
                                                  size=cfg.prefetch_batches)):
        state, metrics = step(state, staged[:2])
        if i + 1 == warmup:
            float(metrics["loss"])  # fence: first launches + pipeline spin-up done
            t0 = time.perf_counter()
            seen = 0
        elif i + 1 > warmup:
            seen += int(staged[0].shape[0])
        if i + 1 >= warmup + steps:
            break
    if t0 is None or metrics is None or seen == 0:
        raise SystemExit("e2e: dataset too small for warmup + measurement — lower --batch "
                         "or re-run `prepare` with more --images")
    loss = float(metrics["loss"])  # fence
    dt = time.perf_counter() - t0
    if hasattr(data, "close"):
        data.close()
    if not np.isfinite(loss):
        raise SystemExit(f"e2e: non-finite loss {loss}")
    print(f"end-to-end real-data: {seen / dt:8.1f} img/s on {device.type} "
          f"(batch {batch}, {seen} images)", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return seen / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["prepare", "host", "transfer", "e2e"])
    ap.add_argument("--root", default=DEFAULT_ROOT)
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--worker-mode", default="thread", choices=["thread", "process"])
    args = ap.parse_args(argv)
    if args.mode == "prepare":
        prepare(args.root, args.images, args.image_size)
    elif args.mode == "host":
        host(args.root, args.steps, args.batch, args.workers, args.worker_mode,
             args.image_size)
    elif args.mode == "transfer":
        transfer(args.batch, args.image_size)
    else:
        e2e(args.root, args.batch, args.steps, args.image_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
