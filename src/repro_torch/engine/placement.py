"""Workload-aware placement: access stats, hot-vertex policy, traffic model
(copy of ``repro.engine.placement``, numpy only).

DegreeSketch's distributed cost hinges on where vertex sketches live: the
block partition fixed at ``open`` time pays a cross-shard gather for every
union/intersection endpoint, and Zipfian query traffic — the distribution
real graphs induce — collapses those gathers onto the few shards that own
the hot vertices (gSketch, arXiv:1111.7167, makes the same observation for
stream sketches). This module (DESIGN.md §12) turns placement into a
*measured* decision:

* :class:`AccessStats` — per-vertex × per-query-kind access counters,
  cheap enough to fold into the serving drain loop (single-writer numpy
  ``add.at``; no locks on the hot path).
* :class:`PlacementPolicy` — picks the top-K hot vertices from those
  counters; the engine replicates their register rows across shards
  (``SketchEngine.replicate``) so hot gathers resolve shard-locally.
* :func:`remap_ids` — host-side id remapping onto replica row slots: a
  sharded query plan that concatenates the replica panel below the
  register table reads byte-identical rows through the remapped ids, so
  replica-on answers are bit-identical to owner-only execution by
  construction. The port's local backend has no owner shard to spare and
  gathers the owner rows (``engine.base``); the remap waits for the
  sharded backend.
* :func:`gather_traffic` — the deterministic cost model: per-owner-shard
  row-fetch counts for a query id stream, with and without a replica
  set (analytic, jitter-free).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["AccessStats", "PlacementPolicy", "remap_ids", "gather_traffic",
           "ID_KINDS", "SCAN_KINDS"]

#: query kinds whose requests carry vertex ids (countable per vertex);
#: the gather kinds the hot-vertex policy replicates for.
ID_KINDS = ("union", "intersection")

#: kinds counted per request: table scans (degrees and the t-hop /
#: HIP-curve queries, which touch every row) and the serving barriers.
#: A kind in neither tuple raises — serving a new query kind without
#: registering it here would silently hide its traffic from placement
#: decisions (DESIGN.md §12/§13).
SCAN_KINDS = ("degrees", "neighborhood", "triangle", "distance_histogram",
              "closeness", "effective_diameter", "ingest", "replicate")


class AccessStats:
    """Per-vertex × per-kind access counters over a vertex universe [0, n).

    Designed for the serving drain loop: one writer (the worker/reader
    thread) calls :meth:`note_ids` / :meth:`note_query` as it serves each
    coalesced segment — a numpy ``add.at`` per segment, no locks, no
    device work. Readers (``stats()`` endpoints, placement decisions) see
    counts that are approximate under concurrency by at most the segment
    being drained, which is all a placement heuristic needs.
    """

    def __init__(self, n: int):
        self.n = int(n)
        self._per_vertex: dict[str, np.ndarray] = {}
        self._totals: dict[str, int] = {}

    def note_ids(self, kind: str, ids) -> None:
        """Count one access per vertex id for ``kind`` (ids may repeat).

        ``kind`` must be one of :data:`ID_KINDS` (``ValueError``
        otherwise — an unregistered kind must fail loudly, not leak out
        of the placement model). Out-of-range ids are ignored (the
        serving layer validates before queuing; this keeps the counter
        robust to direct callers).
        """
        if kind not in ID_KINDS:
            raise ValueError(
                f"unknown id-carrying access kind {kind!r}; register it in "
                f"placement.ID_KINDS (known: {ID_KINDS}) or count it via "
                f"note_query")
        arr = np.asarray(ids).ravel()
        if arr.size == 0:
            return
        per = self._per_vertex.get(kind)
        if per is None:
            per = self._per_vertex[kind] = np.zeros(self.n, np.int64)
        ok = arr[(arr >= 0) & (arr < self.n)]
        np.add.at(per, ok, 1)
        self._totals[kind] = self._totals.get(kind, 0) + int(ok.size)

    def note_query(self, kind: str, count: int = 1) -> None:
        """Count ``count`` requests of a kind that carries no vertex ids.

        ``kind`` must be one of :data:`SCAN_KINDS` (``ValueError``
        otherwise): a query kind added to the serving surface without a
        placement registration would otherwise drop its traffic on the
        floor silently, starving the hot-vertex policy of signal.
        """
        if kind not in SCAN_KINDS:
            raise ValueError(
                f"unknown access kind {kind!r}; register it in "
                f"placement.SCAN_KINDS (known: {SCAN_KINDS}) or, if its "
                f"requests carry vertex ids, count it via note_ids")
        self._totals[kind] = self._totals.get(kind, 0) + int(count)

    def counts(self, kinds=None) -> np.ndarray:
        """Combined per-vertex counts int64[n] over ``kinds`` (default all)."""
        out = np.zeros(self.n, np.int64)
        for kind, per in self._per_vertex.items():
            if kinds is None or kind in kinds:
                out += per
        return out

    def top_k(self, k: int, kinds=None) -> tuple[np.ndarray, np.ndarray]:
        """The ``<= k`` most-accessed vertices, hottest first.

        Returns ``(ids int64[k'], counts int64[k'])`` with zero-count
        vertices excluded — an idle server reports an empty hot set
        rather than k arbitrary cold vertices.
        """
        c = self.counts(kinds)
        k = min(int(k), self.n)
        if k <= 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        idx = np.argpartition(c, -k)[-k:]
        idx = idx[np.argsort(c[idx])[::-1]]
        keep = c[idx] > 0
        return idx[keep].astype(np.int64), c[idx[keep]]

    def totals(self) -> dict[str, int]:
        """{kind: total accesses} — id kinds count per-vertex touches,
        table-scan kinds count requests."""
        return dict(self._totals)

    def snapshot(self, top: int = 16) -> dict:
        """JSON-serializable summary for ``stats()`` endpoints.

        ``{"totals": {kind: int}, "top": [[vertex, count], ...]}`` with
        the ``top`` list hottest-first (empty when nothing was counted).
        """
        ids, cnt = self.top_k(top)
        return {"totals": self.totals(),
                "top": [[int(i), int(c)] for i, c in zip(ids, cnt)]}

    def reset(self) -> None:
        """Zero every counter (serving stats windows)."""
        self._per_vertex.clear()
        self._totals.clear()


@dataclass(frozen=True)
class PlacementPolicy:
    """Top-K hot-vertex replication policy over measured access counters.

    Attributes:
      top_k: replicate at most this many vertices (the replica panel costs
        ``top_k * row_width`` bytes per shard — small against the O(n/S)
        register block).
      min_count: a vertex must have been accessed at least this often to
        qualify; keeps a barely-warmed server from replicating noise.
      kinds: which access kinds count toward hotness (default: the
        id-carrying gather kinds — table scans don't gather rows).
    """

    top_k: int = 64
    min_count: int = 1
    kinds: tuple = ID_KINDS

    def hot_vertices(self, access: AccessStats) -> np.ndarray:
        """The replica candidate set: sorted int64 vertex ids (may be empty).

        Sorted ascending because the engine's replica remapping
        (:func:`remap_ids`) binary-searches the set; hotness ordering is
        irrelevant once a vertex is in.
        """
        ids, cnt = access.top_k(self.top_k, kinds=self.kinds)
        return np.sort(ids[cnt >= self.min_count])


def remap_ids(ids: np.ndarray, hot_sorted: np.ndarray,
              base: int) -> np.ndarray:
    """Remap replicated vertex ids onto replica row slots ``base + slot``.

    ``hot_sorted`` is the sorted replica id set; ``base`` is the register
    table's padded row count, so a query plan that concatenates the
    replica panel below the table gathers replicated vertices from their
    (byte-identical) replica rows and everything else from the table.
    Pure host-side numpy — the kernels never learn about
    replicas.
    """
    ids = np.asarray(ids)
    if hot_sorted is None or len(hot_sorted) == 0:
        return ids
    pos = np.searchsorted(hot_sorted, ids)
    pos = np.minimum(pos, len(hot_sorted) - 1)
    hit = hot_sorted[pos] == ids
    return np.where(hit, base + pos, ids).astype(ids.dtype)


def gather_traffic(ids, n_pad: int, shards: int,
                   hot_ids=None) -> np.ndarray:
    """Modeled per-owner-shard gather traffic for a query id stream.

    Each queried vertex id costs one register-row fetch from its owner
    shard (``id // v_loc`` under the block partition); ids in ``hot_ids``
    are served from the local replica panel and charge no owner. Returns
    int64[shards] row counts — the deterministic metric behind
    ``BENCH_shard.json``'s max-owner reduction gate (no timing, no
    jitter; the ``BENCH_roofline`` ``bytes_ratio`` precedent).
    """
    if n_pad % shards:
        raise ValueError(f"n_pad={n_pad} not divisible by shards={shards}")
    v_loc = n_pad // shards
    arr = np.asarray(ids).ravel()
    if hot_ids is not None and len(hot_ids):
        hot = np.sort(np.asarray(hot_ids).ravel())
        pos = np.minimum(np.searchsorted(hot, arr), len(hot) - 1)
        arr = arr[hot[pos] != arr]
    return np.bincount(arr // v_loc, minlength=shards).astype(np.int64)
