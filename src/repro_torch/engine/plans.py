"""Query planning: input normalization, shape buckets, the plan cache and
the trace and event counters.

Port of the backend-independent half of ``repro.engine.plans``. The
host-side contract every query keeps:

* vertex ids are validated on the host, against the engine's universe
  ``[0, n)``, before any device gather. A jnp gather clamps an
  out-of-range id and a torch gather raises or faults; neither may be the
  check, so an out-of-range id raises ``ValueError`` here first;
* pair batches pad to power-of-two buckets with validity masks, and
  padding pairs point at row 0; the caller drops their answers;
* set batches pad to power-of-two ``(B, L)`` buckets; padding slots are
  masked and merge nothing, so they never pull row 0 into a union.

A *plan* is the function that answers one batched query kind (union,
intersection, or a mixed batch) at one shape bucket, resolved through
:class:`PlanCache` under the JAX package's key coordinates (query,
bucket, cfg, backend, layout, extra, family). PyTorch runs eagerly, so a
plan is a plain function and nothing compiles; what the cache keeps is
the JAX package's accounting for the kinds whose shapes vary with the
batch. Every other query calls its kernel directly. Its *trace counter*
(:func:`trace_counts`) counts the first build of each key, the quantity
that shape bucketing bounds to O(log batch) per query kind, so the
serving tests and ``stats()["plan_traces"]`` keep their meaning. The
*event counters* (:func:`event_counts`) count executions seen on the
host: engines record ``"propagate_pass"`` once per Algorithm 2 pass run
(the t-hop panel cache's "zero passes on an unchanged engine") and
``"lease_clone"`` once per register panel cloned for a live snapshot.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import registry
from repro_torch.tracing import span

__all__ = ["bucket", "require_integer_ids", "split_sets", "pad_sets",
           "normalize_sets", "split_pairs", "pad_pairs", "normalize_pairs",
           "pad_routing", "PlanKey",
           "PlanCache", "global_cache", "record_trace", "trace_counts",
           "reset_trace_counts", "record_event", "event_counts",
           "reset_event_counts", "build_union_plan", "build_intersection_plan",
           "build_mixed_plan"]


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


def normalize_pairs(pairs, n: int | None = None,
                    ) -> tuple[np.ndarray, np.ndarray, int, bool]:
    """Pair-query input to bucketed ((B, 2) ids, mask, n_real, scalar):
    :func:`split_pairs` then :func:`pad_pairs`."""
    arr, scalar = split_pairs(pairs, n)
    out, mask = pad_pairs(arr)
    return out, mask, arr.shape[0], scalar


def pad_routing(src: np.ndarray, dst: np.ndarray,
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A directed edge routing padded to its power-of-two bucket:
    ``(src int32[E'], dst int32[E'], mask bool[E'])``, E' =
    ``bucket(len(src))``, padding slots masked (``ops.propagate`` drops
    them). The port's engines pass their routing unpadded; this keeps the
    reference's helper for callers that bucket."""
    m = len(src)
    cap = bucket(max(m, 1))
    src_p = np.zeros((cap,), np.int32)
    dst_p = np.zeros((cap,), np.int32)
    mask = np.zeros((cap,), bool)
    src_p[:m] = src
    dst_p[:m] = dst
    mask[:m] = True
    return src_p, dst_p, mask


# ------------------------------------------------------ trace and event counters
_COUNT_LOCK = threading.Lock()
_TRACE_COUNTS: dict[str, int] = {}
_EVENT_COUNTS: dict[str, int] = {}


def record_trace(query: str) -> None:
    """Count one plan build for ``query`` (a :class:`PlanCache` miss)."""
    with _COUNT_LOCK:
        _TRACE_COUNTS[query] = _TRACE_COUNTS.get(query, 0) + 1


def trace_counts() -> dict[str, int]:
    """Snapshot of {query kind: plan builds since the last reset}."""
    with _COUNT_LOCK:
        return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    """Zero the trace counters (test fixtures; serving stats windows)."""
    with _COUNT_LOCK:
        _TRACE_COUNTS.clear()


def record_event(event: str) -> None:
    """Count one host-observed execution of ``event`` (e.g. one
    ``"propagate_pass"``, one ``"lease_clone"``)."""
    with _COUNT_LOCK:
        _EVENT_COUNTS[event] = _EVENT_COUNTS.get(event, 0) + 1


def event_counts() -> dict[str, int]:
    """Snapshot of {event: executions since the last reset}."""
    with _COUNT_LOCK:
        return dict(_EVENT_COUNTS)


def reset_event_counts() -> None:
    """Zero the event counters (test fixtures; serving stats windows)."""
    with _COUNT_LOCK:
        _EVENT_COUNTS.clear()


# ------------------------------------------------------------------ plan cache
@dataclass(frozen=True)
class PlanKey:
    """Identity of a query plan: the JAX package's key coordinates.

    Attributes:
      query: query kind ("union" | "intersection" | "mixed").
      bucket: the padded, bucketed input shape.
      cfg: the sketch config (a frozen dataclass).
      backend: engine backend ("local").
      impl: kernel implementation ("cuda" | "ref"); engines of different
        impls never share a plan.
      layout: register layout ("byte" | "packed").
      extra: further specialization (estimator method and iterations,
        the kinds of a mixed batch).
      family: sketch family ("hll" | "ads").
    """

    query: str
    bucket: tuple = ()
    cfg: object = None
    backend: str = "local"
    impl: str = "cuda"
    layout: str = "byte"
    extra: tuple = ()
    family: str = "hll"


class PlanCache:
    """LRU-bounded, thread-safe map from :class:`PlanKey` to plan.

    One instance (:func:`global_cache`) is shared by every engine in the
    process, so engines with identical coordinates share plans; a miss
    builds the plan and records one trace for ``key.query``.
    """

    def __init__(self, maxsize: int = 256):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self._maxsize = int(maxsize)
        self._entries: OrderedDict[PlanKey, object] = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def maxsize(self) -> int:
        """The LRU bound."""
        return self._maxsize

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: PlanKey) -> bool:
        with self._lock:
            return key in self._entries

    def get(self, key: PlanKey, builder):
        """The plan for ``key``, built by ``builder()`` (and counted as one
        trace of ``key.query``) on a miss."""
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return fn
            self.misses += 1
            fn = builder()
            record_trace(key.query)
            self._entries[key] = fn
            while len(self._entries) > self._maxsize:
                self._entries.popitem(last=False)
                self.evictions += 1
            return fn

    def clear(self) -> None:
        """Drop every cached plan (the statistics are kept)."""
        with self._lock:
            self._entries.clear()

    def stats(self) -> dict:
        """Snapshot {hits, misses, evictions, size, maxsize}."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._entries),
                    "maxsize": self._maxsize}


_GLOBAL_CACHE = PlanCache()


def global_cache() -> PlanCache:
    """The process-wide plan cache engines share by default."""
    return _GLOBAL_CACHE


# --------------------------------------------------------------- plan builders
# Plans exist for the kinds whose traces the servers report (``union``,
# ``intersection``, ``mixed``); every other query calls its kernel
# directly. A builder closes over the config and the kernel set only,
# never over an engine, so one plan serves every engine with the same
# key. Host inputs (padded ids and masks) cross to the panel's device
# inside.

def _on(regs: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(regs.device)


def build_union_plan(cfg, kernels):
    """(regs, ids int32[B, L], mask bool[B, L]) -> float32[B] unions."""
    def plan(regs, ids, mask):
        return kernels.union_estimate(regs, _on(regs, ids), _on(regs, mask),
                                      cfg)
    return plan


def build_intersection_plan(cfg, kernels, method: str, iters: int):
    """(regs, ids int32[B, 2]) -> float32[B] pair estimates."""
    fam = registry.family(kernels.family)

    def plan(regs, ids):
        with span("pairs.stats"):
            stats, sz = kernels.intersection_stats(regs, _on(regs, ids), cfg)
        return fam.estimate_from_pair_stats(stats, sz, cfg, method, iters,
                                            impl=kernels.impl)
    return plan


def build_mixed_plan(cfg, kernels, kinds: tuple, method: str, iters: int):
    """One plan for a batch of two or more kinds among degrees, union and
    intersection: each kind runs the same kernels as its own query on the
    same inputs, so the answers equal the per-kind queries' bit for bit."""
    uni = build_union_plan(cfg, kernels)
    inter = build_intersection_plan(cfg, kernels, method, iters)

    def plan(regs, u_ids, u_mask, p_ids):
        out = {}
        if "degrees" in kinds:
            out["degrees"] = kernels.estimate_rows(regs, cfg)
        if "union" in kinds:
            out["union"] = uni(regs, u_ids, u_mask)
        if "intersection" in kinds:
            out["intersection"] = inter(regs, p_ids)
        return out
    return plan
