"""Query input normalization: id validation, shape buckets, padding.

Port of the backend-independent half of ``repro.engine.plans``. PyTorch
runs eagerly, so there is no compiled-plan cache here; what stays is the
host-side contract every query keeps:

* vertex ids are validated on the host, against the engine's universe
  ``[0, n)``, before any device gather. A jnp gather clamps an
  out-of-range id and a torch gather raises or faults; neither may be the
  check, so an out-of-range id raises ``ValueError`` here first;
* pair batches pad to power-of-two buckets with validity masks, and
  padding pairs point at row 0; the caller drops their answers.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bucket", "require_integer_ids", "split_pairs", "pad_pairs"]


def bucket(size: int, minimum: int = 8) -> int:
    """Next power-of-two shape bucket (>= minimum)."""
    return max(minimum, 1 << max(int(size) - 1, 0).bit_length())


def require_integer_ids(arr: np.ndarray, what: str) -> None:
    """Raise ValueError unless ``arr`` has an integer dtype.

    A float array cast with ``astype(int)`` silently truncates (3.7 -> 3),
    answering the query for a different vertex.
    """
    if arr.size and arr.dtype.kind not in "iu":
        raise ValueError(
            f"{what} must have an integer dtype; got {arr.dtype} — float "
            f"vertex ids would be silently truncated (e.g. 3.7 -> 3)")


def _validate_ids(arr: np.ndarray, n: int | None, query: str) -> None:
    """Raise ValueError for vertex ids outside [0, n), before the int32
    cast and before any device gather."""
    if n is None or arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= n:
        raise ValueError(
            f"{query} got vertex ids [{lo}, {hi}] outside the engine's "
            f"universe [0, {n})")


def split_pairs(pairs, n: int | None = None) -> tuple[np.ndarray, bool]:
    """Parse pair-query input into (validated int64[B, 2] ids, scalar)."""
    raw = np.asarray(pairs)
    require_integer_ids(raw, "intersection_size pair ids")
    arr = raw.astype(np.int64)
    scalar = arr.ndim == 1
    if scalar:
        arr = arr[None]
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"pairs must have shape (B, 2), got {arr.shape}")
    _validate_ids(arr, n, "intersection_size")
    return arr, scalar


def pad_pairs(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pad parsed (B, 2) pairs to bucketed (ids int32[B', 2], mask[B'])."""
    n_real = arr.shape[0]
    out = np.zeros((bucket(n_real), 2), np.int32)
    out[:n_real] = arr
    mask = np.zeros((out.shape[0],), bool)
    mask[:n_real] = True
    return out, mask

