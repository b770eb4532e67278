"""Data of the port: seeded synthetic images and tokens, and host->device
staging."""

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

__all__ = [
    "SyntheticImageDataset",
    "SyntheticTokenDataset",
    "normalize_staged_images",
    "prefetch_to_device",
    "shard_batch",
    "staging_dtype",
    "to_device",
]
