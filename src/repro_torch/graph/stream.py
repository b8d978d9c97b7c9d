"""Edge-block padding for the ingest path (copy of ``repro.graph.stream``).

Only ``pad_block`` is ported so far, the JAX package's padding of an
edge block to a power-of-two shape with a validity mask; the port's local
engine does not pad (the CUDA accumulate kernel takes any length).
``EdgeStream`` and the owner router come with the streaming and sharded
slices.
"""
from __future__ import annotations

import numpy as np

__all__ = ["pad_block"]


def pad_block(arr: np.ndarray, size: int, fill: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad a trailing block to ``size``; returns (padded, valid_mask)."""
    k = len(arr)
    mask = np.zeros(size, dtype=bool)
    mask[:k] = True
    if arr.ndim == 1:
        out = np.full(size, fill, dtype=arr.dtype)
        out[:k] = arr
    else:
        out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:k] = arr
    return out, mask
