"""Rank-aware logging for the port.

The JAX package's ``utils/logging.py`` resolves the rank through
``jax.process_index()``; this copy reads it from the environment
instead: ``RANK`` (set by ``torch.distributed`` launchers), else the
repo launcher's ``DDL_PROCESS_ID``, else 0. Record format and logger
name are the same, so mixed logs read alike.
"""

from __future__ import annotations

import logging
import os
import sys
from functools import lru_cache
from typing import Any, MutableMapping, Optional


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
