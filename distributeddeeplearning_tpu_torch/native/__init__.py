"""Deterministic fills of the port, bit-identical to the JAX package's
``native.fill_uniform`` (its numpy splitmix64 path; the C++ library there
computes the same bits)."""

from __future__ import annotations

import numpy as np


def fill_uniform(shape, seed: int) -> np.ndarray:
    """float32 uniform [0, 1] array in splitmix64 counter mode:
    ``out[i] = hash(seed + i)``, the top 32 bits over 2**32.

    The upper bound is closed: uint32 draws >= 2**32 - 128 round up to
    1.0 in float32, as in the JAX package."""
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)
    chunk = 1 << 22  # bounds the uint64 temporaries
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            z = np.arange(lo, hi, dtype=np.uint64) + s
            z = z + np.uint64(0x9E3779B97F4A7C15)
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            z = z ^ (z >> np.uint64(31))
            bits = (z >> np.uint64(32)).astype(np.uint32)
            out[lo:hi] = bits.astype(np.float32) * np.float32(1.0 / 4294967296.0)
    return out.reshape(shape)


__all__ = ["fill_uniform"]
