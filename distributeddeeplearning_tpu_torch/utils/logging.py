"""Rank-aware logging for the port.

The JAX package's ``utils/logging.py`` resolves the rank through
``jax.process_index()``; this copy reads it from the environment
instead: ``RANK`` (set by ``torch.distributed`` launchers), else the
repo launcher's ``DDL_PROCESS_ID``, else 0. Record format and logger
name are the same, so mixed logs read alike; :func:`log_summary` prints
the same throughput block, field for field.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import lru_cache
from typing import Any, Mapping, MutableMapping, Optional


def _get_rank() -> int:
    return int(os.environ.get("RANK", os.environ.get("DDL_PROCESS_ID", 0)))


class RankAdapter(logging.LoggerAdapter):
    """Injects ``[rank]`` and ``[Epoch n]`` into records."""

    def __init__(self, logger: logging.Logger, rank: Optional[int] = None):
        # rank=None: resolve at log time (a launcher may set RANK after
        # the adapter was built).
        super().__init__(logger, {"rank": rank})

    def process(self, msg, kwargs: MutableMapping[str, Any]):
        extra = kwargs.pop("extra", {})
        epoch = extra.get("epoch")
        prefix = f"[Epoch {epoch}] " if epoch is not None else ""
        rank = self.extra["rank"]
        kwargs["extra"] = {"rank": _get_rank() if rank is None else rank}
        return f"{prefix}{msg}", kwargs


@lru_cache(maxsize=None)
def get_logger(name: str = "ddl_tpu", rank: Optional[int] = None) -> RankAdapter:
    """``lru_cache``'d rank-tagged logger singleton."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("%(asctime)s rank:%(rank)s [%(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return RankAdapter(logger, rank=rank)


def log_summary(
    *,
    data_length: int,
    duration_s: float,
    batch_size_per_device: int,
    num_devices: int,
    dataset_kind: str,
    logger: Optional[RankAdapter] = None,
    extra_fields: Optional[Mapping[str, Any]] = None,
) -> float:
    """Print the canonical throughput block; returns total images/sec.

    The JAX package's ``log_summary``, field for field (the reference's
    ``_log_summary``): duration, images processed, per-device and total
    batch size, device count, dataset kind, ``Total images/sec`` (the
    repo's canonical metric) and per device, then ``extra_fields``.
    Callers pass the *global* number of images actually processed."""
    log = logger or get_logger()
    images_per_sec = data_length / duration_s if duration_s > 0 else float("inf")
    log.info("Total duration: %.3f s", duration_s)
    log.info("Total images processed: %d", data_length)
    log.info("Batch size (per device): %d", batch_size_per_device)
    log.info("Batch size (total): %d", batch_size_per_device * num_devices)
    log.info("Devices: %d", num_devices)
    log.info("Dataset: %s", dataset_kind)
    log.info("Total images/sec: %.1f", images_per_sec)
    log.info("Images/sec per device: %.1f", images_per_sec / max(num_devices, 1))
    for k, v in (extra_fields or {}).items():
        log.info("%s: %s", k, v)
    return images_per_sec
