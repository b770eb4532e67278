"""Data of the port: seeded synthetic images and tokens, host->device
staging, and the JAX package's dataset factory (:func:`make_dataset`,
its synthetic branch, and :func:`make_input_fn`)."""

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


def make_dataset(config, train: bool = True) -> SyntheticImageDataset:
    """The JAX package's ``make_dataset`` (``data/__init__.py:44-116``),
    synthetic branch: the train stream of ``config.fake_data_length``
    images from ``config.seed``; the eval stream from ``seed + 10_000``,
    ``max(fake_data_length // 25, global_batch)`` long and exact (every
    sample once, the last batch padded and zero-weighted). This
    process's share comes from the ``torch.distributed`` rank and world
    size. The real-data pipeline is a later slice and raises."""
    from distributeddeeplearning_tpu_torch.parallel import collectives

    if not config.fake:
        raise NotImplementedError(
            "FAKE=False: the real-data pipeline (data/imagenet.py, data/stream/) "
            "is not ported yet")
    return SyntheticImageDataset(
        length=(config.fake_data_length if train
                else max(config.fake_data_length // 25, config.global_batch_size)),
        global_batch_size=config.global_batch_size,
        image_size=config.image_size,
        num_classes=config.num_classes,
        seed=config.seed if train else config.seed + 10_000,
        process_index=collectives.rank(),
        process_count=collectives.size(),
        exact=not train,
        dtype=staging_dtype(config),
        topology=config.data_topology,
    )


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
