"""Query input normalization: id validation, shape buckets, padding.

Port of the backend-independent half of ``repro.engine.plans``. PyTorch
runs eagerly, so there is no compiled-plan cache here; what stays is the
host-side contract every query keeps:

* vertex ids are validated on the host, against the engine's universe
  ``[0, n)``, before any device gather. A jnp gather clamps an
  out-of-range id and a torch gather raises or faults; neither may be the
  check, so an out-of-range id raises ``ValueError`` here first;
* pair batches pad to power-of-two buckets with validity masks, and
  padding pairs point at row 0; the caller drops their answers;
* set batches pad to power-of-two ``(B, L)`` buckets; padding slots are
  masked and merge nothing, so they never pull row 0 into a union.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bucket", "require_integer_ids", "split_sets", "pad_sets",
           "normalize_sets", "split_pairs", "pad_pairs"]


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


def split_sets(vertex_sets, n: int | None = None,
               ) -> tuple[list[np.ndarray], bool]:
    """Parse union-query input into (list of validated 1-D int64 id arrays,
    scalar).

    Accepts a single 1-D array of vertex ids (one set, scalar result), a
    list or tuple of 1-D arrays (ragged batch) or a 2-D array (rectangular
    batch). Dtypes and ids are validated against ``[0, n)`` here, on the
    host.
    """
    if isinstance(vertex_sets, (list, tuple)):
        raws = [np.asarray(s).ravel() for s in vertex_sets]
        for s in raws:
            require_integer_ids(s, "union_size vertex ids")
        sets = [s.astype(np.int64) for s in raws]
        scalar = False
    else:
        arr = np.asarray(vertex_sets)
        require_integer_ids(arr, "union_size vertex ids")
        if arr.ndim == 1:
            sets, scalar = [arr.astype(np.int64)], True
        elif arr.ndim == 2:
            sets, scalar = list(arr.astype(np.int64)), False
        else:
            raise ValueError(f"vertex_sets must be 1-D, 2-D or a list "
                             f"of 1-D arrays, got ndim={arr.ndim}")
    if not sets:
        raise ValueError("union_size needs at least one vertex set")
    for s in sets:
        _validate_ids(s, n, "union_size")
    return sets, scalar


def pad_sets(sets: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pad parsed id sets to bucketed (ids int32[B', L], mask bool[B', L]).

    Padding slots hold id 0 and are masked out, never merged.
    """
    longest = max((len(s) for s in sets), default=1)
    ids = np.zeros((bucket(len(sets)), bucket(max(longest, 1))), np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, s in enumerate(sets):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = True
    return ids, mask


def normalize_sets(vertex_sets, n: int | None = None,
                   ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Union-query input to bucketed (ids, mask, n_real, scalar):
    :func:`split_sets` then :func:`pad_sets`."""
    sets, scalar = split_sets(vertex_sets, n)
    ids, mask = pad_sets(sets)
    return ids, mask, len(sets), scalar


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

