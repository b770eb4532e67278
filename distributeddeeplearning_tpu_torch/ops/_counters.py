"""The int32 counter buffers of the kernels whose last block of a tile
merges the tile's splits (``csrc/paged_decode.cu``,
``csrc/fused_grads.cu``; ``csrc/fused_block.cu``'s merge groups of
blocks).

One buffer per (device, stream): a launch's counters start zero and the
last block of each tile resets its own, so every launch leaves them
zero and one buffer serves every call on its stream, where launches run
in order; another stream gets its own. A buffer only grows.

CUDA graphs bake a buffer's address in. Serving engines capture on one
shared stream and then replay on different ones: :func:`isolate` makes
the next launches on a stream take a fresh buffer (the engine that
captured with the old one keeps it alive through :func:`held`).
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


def isolate(stream: int) -> None:
    """Forget the buffers of ``stream``: the next launch there gets a new
    one. Whoever captured graphs with the old ones must hold them."""
    for key in [k for k in _COUNTERS if k[1] == stream]:
        del _COUNTERS[key]


def held(stream: int) -> list:
    """The buffers launches on ``stream`` use now (to keep them alive
    with the graphs that recorded their addresses)."""
    return [buf for key, buf in _COUNTERS.items() if key[1] == stream]
