"""The int32 counter buffers of the kernels whose last block of a tile
merges the tile's splits (``csrc/paged_decode.cu``,
``csrc/fused_grads.cu``; ``csrc/fused_block.cu``'s merge groups of
blocks).

One buffer per (device, stream): a launch's counters start zero and the
last block of each tile resets its own, so every launch leaves them
zero and one buffer serves every call on its stream, where launches run
in order; another stream gets its own. A buffer only grows.
"""

from __future__ import annotations

import torch

_COUNTERS: dict = {}


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for launches on ``stream``."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf
