"""SketchEngine: the persistent sketch query surface (port of
``repro.engine.base``).

An engine owns an accumulated register panel ``uint8[n_pad, w]``:
``w = r`` bytes on the byte layout, ``r/2`` on the packed 4-bit
layout (``kernels.packing``), whose kernels serve every query alike. The
local backend holds it as one tensor on one device; the sharded backend
(``engine.sharded``) as one block of rows per shard. The few places that
read the panel as a whole go through backend hooks (per-shard row
estimates, rows gathered for a query, the n true rows for merge and
save, the lease clone), which the local backend implements on its one
tensor.
``ingest(edge_block)`` folds edge blocks into it in place (Algorithm 1);
queries answer from it:

* ``degrees()``                          — d̃(x) for all x
* ``union_size(vertex_sets)``            — batched |∪ N(x)| (§6)
* ``intersection_size(pairs, method=)``  — batched |N(x) ∩ N(y)| (Eq. 10)
* ``query_batch(...)``                   — a mixed degrees/union/
  intersection batch in one call, answers equal to the per-kind methods'
  bit for bit
* ``neighborhood(t_max, schedule=)``     — Algorithm 2, served from the
  t-hop panel cache: materialized ``D^t`` panels keyed by the engine's
  ``version``, extended incrementally and dropped on the next ingest, so a
  repeat on an unchanged engine runs zero propagate passes. Every name in
  ``SCHEDULES`` is accepted; a single-device backend runs one dataflow
  for all of them, as the JAX local backend does, and the sharded one
  caches each schedule's panels apart
* ``triangle_heavy_hitters(k, mode=)``   — Algorithms 4/5
* ``distance_histogram / closeness / effective_diameter`` — HIP-curve
  distance queries of the ADS family, built on the same cached D^t
  panels as ``neighborhood``; the curve rows are cached beside them

``merge(other)`` folds another engine's sketch in by register max
(Algorithm 6 MERGE; nibble-wise on packed panels, converting ``other``'s
rows when its layout differs), and ``save(path)`` writes a checkpoint in
the JAX package's format that ``repro_torch.engine.load`` and the JAX package's
``repro.engine.load`` both restore.

``snapshot()`` returns a read-only view at the current version in O(1):
it shares the panel, the edge list and the cached D^t panels. Because
ingest and merge write the panel in place (the JAX engine's panels are
immutable arrays), the panel is *leased* while a snapshot of it is alive:
the writer's next in-place write first clones it, once per
snapshot-then-write cycle (``_release_lease``), so a snapshot answers
bit for bit at its version while the writer moves on. ``replicate(ids)``
installs a hot-vertex replica set, carried by snapshots and checkpoints;
on one device its rows are the owner rows themselves, and the sharded
backend merges them from a replica panel in its propagate passes.

Batched union, intersection and mixed queries resolve their plan through
the shared :class:`~repro_torch.engine.plans.PlanCache`, which counts
the first build of every key (``plans.trace_counts``); every other query
calls its kernel directly. Each Algorithm 2 pass and each lease clone is
counted as an event (``plans.event_counts``).

Query kinds the engine's sketch family does not serve raise
:class:`UnsupportedQuery` up front. Ids are validated on the host before
anything reaches the device.
"""
from __future__ import annotations

import abc
import copy
import operator
import threading
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.engine import plans
from repro_torch.kernels import inputs, packing, registry
from repro_torch.kernels.inputs import pad_vertices, resolve_device
from repro_torch.tracing import span

#: the ``format`` a checkpoint of an engine records (the JAX package's)
ENGINE_FORMAT = "degreesketch-engine-v1"

__all__ = ["SketchEngine", "ENGINE_FORMAT", "SnapshotFrozen",
           "UnsupportedQuery", "SCHEDULES", "resolve_device",
           "validate_t_max", "pad_vertices", "bucket"]

#: the shape bucket of ``engine.plans``, re-exported as the reference does
bucket = plans.bucket

#: Algorithm 2 schedules every backend accepts; the sharded backend picks
#: its dataflow by them ("auto" is the ring), a single-device one ignores
#: them
SCHEDULES = ("auto", "ring", "ring_overlap", "allgather")


class SnapshotFrozen(RuntimeError):
    """Raised when a mutating call (``ingest``, ``merge``, ``replicate``)
    hits a read-only :meth:`SketchEngine.snapshot` view; mutations go to
    the writer engine the snapshot was taken from."""


class UnsupportedQuery(ValueError):
    """Raised for a query kind the engine's sketch family cannot answer."""


def validate_t_max(t_max) -> int:
    """Validate a neighborhood horizon: an integer >= 1, returned as int."""
    try:
        t = operator.index(t_max)
    except TypeError:
        raise ValueError(
            f"t_max must be an integer >= 1, got {t_max!r}") from None
    if t < 1:
        raise ValueError(f"t_max must be >= 1, got {t}")
    return t


def _check_edge_ids(raw: np.ndarray, n: int, what: str) -> np.ndarray:
    """Integer dtype and range checks before the int32 cast (no wrapping)."""
    with span("engine.check_ids"):
        plans.require_integer_ids(raw, what)
        if len(raw):
            lo, hi = int(raw.min()), int(raw.max())
            if lo < 0 or hi >= n:
                raise ValueError(
                    f"{what}: vertex ids [{lo}, {hi}] lie outside the "
                    f"engine's universe [0, {n})")
        return np.ascontiguousarray(raw, dtype=np.int32)


@dataclass
class _PanelSet:
    """Materialized D^t register panels for one engine version and
    schedule.

    ``panels[i]`` is D^{i+1}: ``panels[0]`` is the accumulated panel
    itself, each later entry one more Algorithm 2 pass over it. Valid only
    while the engine's ``version`` equals ``version`` and the query's
    schedule key (``_canonical_schedule``) equals ``schedule``. ``aux`` holds
    derived per-hop caches with the same lifetime: the ADS family's
    cumulative HIP curve rows (``aux["hip"][i]`` is C^{i+1}, host
    float64[n]).
    """

    version: int
    schedule: str
    panels: list = field(default_factory=list)
    aux: dict = field(default_factory=dict)


class SketchEngine(abc.ABC):
    """Backend-agnostic persistent query engine over an accumulated sketch.

    Construct through :mod:`repro_torch.engine` (``open``/``build``) or
    ``from_regs``. Subclasses provide the block accumulation step and one
    propagate pass; a backend whose panel is not one tensor also
    overrides the panel hooks (``_estimate_panel``, ``_hip_delta_panel``,
    ``_clone_panel``, ``_true_rows``, ``_max_into``, ``_query_panel``).
    """

    backend = "abstract"

    #: undirected edges per accumulate launch (``kernels.inputs``);
    #: ``ingest`` splits larger blocks
    INGEST_BLOCK = inputs.INGEST_BLOCK

    #: at most this many D^t panels are kept (~n_pad * r bytes each);
    #: deeper horizons are computed transiently
    MAX_CACHED_PANELS = 8

    def __init__(self, regs: torch.Tensor, n: int, cfg,
                 edges: np.ndarray | None, layout: str = "byte",
                 impl: str = "cuda"):
        self.kernels = registry.resolve(cfg, layout=layout, impl=impl)
        self.family = registry.family(self.kernels.family)
        self._regs = regs
        self.n = int(n)
        self.cfg = cfg
        self.layout = layout
        if edges is not None:
            edges = _check_edge_ids(np.asarray(edges), self.n, "edges")
        self._edges0 = edges
        self._edge_chunks: list[np.ndarray] = []
        self._version = 0
        self._prop_routing: tuple[torch.Tensor, ...] | None = None
        self._panel_set: _PanelSet | None = None
        self._replica_ids: np.ndarray | None = None  # sorted, or None
        self._plan_cache = plans.global_cache()
        #: Algorithm 2 passes run by this engine (the panel cache's proof)
        self.propagate_passes = 0
        self._frozen = False  # True only on snapshot() views
        # live snapshots that share the current panel (the lease)
        self._lessees: weakref.WeakSet = weakref.WeakSet()
        self._snap_lock = threading.RLock()  # guards lazy query caches

    # ------------------------------------------------------------- state
    @property
    def device(self) -> torch.device:
        """The device the register panel lives on."""
        return self._regs.device

    @property
    def impl(self) -> str:
        """Kernel implementation: "cuda" (the kernels on a CUDA panel, their
        plain versions on a CPU one) or "ref" (the plain versions)."""
        return self.kernels.impl

    @property
    def n_pad(self) -> int:
        """Padded vertex-row count of the register table (>= n)."""
        return int(self._regs.shape[0])

    @property
    def version(self) -> int:
        """Panel version: bumps on every ingest that changes the panel."""
        return self._version

    @property
    def frozen(self) -> bool:
        """True iff this engine is a read-only :meth:`snapshot` view."""
        return self._frozen

    @property
    def regs_leased(self) -> bool:
        """True while a live snapshot shares the current register panel;
        the next ingest or merge then clones the panel first."""
        return len(self._lessees) > 0

    @property
    def plan_cache(self) -> plans.PlanCache:
        """The (shared, LRU-bounded) plan cache this engine resolves in."""
        return self._plan_cache

    @property
    def regs(self) -> torch.Tensor:
        """The accumulated register table uint8[n_pad, w] (w = r, or r/2 on
        the packed layout).

        Ingest and merge update the panel in place while no snapshot of
        it is alive, so a handle taken before them sees the new registers
        then. While a snapshot shares the panel, they first clone it and
        write the clone: the handle (like the snapshot) keeps the old
        registers. Compare :attr:`version` rather than holding a handle.
        """
        return self._regs

    @property
    def edges(self) -> np.ndarray | None:
        """Every undirected edge ingested so far, int32[m, 2].

        ``None`` iff the engine was created from a bare register table
        (``from_regs`` without ``edges=``).
        """
        if self._edges0 is None:
            return None
        if self._edge_chunks:
            with span("engine.edges"):
                self._edges0 = np.concatenate(
                    [self._edges0] + self._edge_chunks)
            self._edge_chunks = []
        return self._edges0

    @property
    def m(self) -> int:
        """Number of undirected edges ingested so far (0 if untracked)."""
        e = self.edges
        return 0 if e is None else len(e)

    def _require_edges(self, query: str) -> np.ndarray:
        e = self.edges
        if e is None:
            raise ValueError(
                f"{query} re-reads the edge stream, but this engine was "
                f"built without edges (from_regs without edges=...)")
        return e

    # ---------------------------------------------------------- ingestion
    def ingest(self, edge_block) -> "SketchEngine":
        """Fold a block of undirected edges into the sketch (Algorithm 1).

        ``edge_block`` is int[k, 2]; both orientations of every edge are
        inserted. Ids must lie in [0, n) — checked before the int32 cast
        and before any mutation (``ValueError``). Blocks larger than
        ``INGEST_BLOCK`` are split into chunks, each inserted in both
        orientations at once, with no padding. Register max is
        commutative and idempotent, so any blocking of the same edges
        gives a byte-identical panel. Bumps :attr:`version`. Returns self.
        Raises :class:`SnapshotFrozen` on a snapshot view.
        """
        with span("engine.ingest"):
            self._check_mutable("ingest")
            raw = np.asarray(edge_block)
            if raw.ndim != 2 or raw.shape[1] != 2:
                raise ValueError(
                    f"edge_block must have shape (k, 2), got {raw.shape}")
            if raw.shape[0] == 0:
                return self
            block = _check_edge_ids(raw, self.n, "edge block")
            self._release_lease()  # never write a panel a snapshot still reads
            for s in range(0, len(block), self.INGEST_BLOCK):
                with span("ingest.chunk"):
                    self._accumulate_block(block[s:s + self.INGEST_BLOCK])
            self._version += 1
            if self._edges0 is not None:
                self._edge_chunks.append(block)
            self._invalidate_caches()
            return self

    def _invalidate_caches(self) -> None:
        """Drop what derives from the panel or the edges: the propagate
        routing, the D^t panels and their HIP curve rows."""
        self._prop_routing = None
        self._panel_set = None

    def ingest_stream(self, stream) -> "SketchEngine":
        """Drain an edge stream (anything with ``all_blocks()``, such as an
        ``EdgeStream``) into the sketch, block by block."""
        for blk in stream.all_blocks():
            self.ingest(blk)
        return self

    def merge(self, other: "SketchEngine") -> "SketchEngine":
        """Fold another engine's sketch into this one (register max).

        Register max is the sketches' closed union operator (Algorithm 6
        MERGE): merging engines that each ingested part of the edges is
        bit-identical to one engine ingesting them all. Requires the same
        sketch family (:class:`~repro_torch.ckpt.checkpoint.FamilyMismatch`
        otherwise), then an identical config and vertex count
        (``ValueError``). ``other``'s rows are copied to this engine's
        device, converted to this engine's layout when the two differ
        (byte -> packed saturates at 15, which commutes with the max;
        packed -> byte is exact), and maxed into its panel in place,
        nibble by nibble on the packed layout. If both engines track
        edges the lists concatenate; if either does not, the merged
        engine stops tracking. Bumps :attr:`version`; ``other`` is left
        untouched, and so is every snapshot of either engine. Returns
        self. Raises :class:`SnapshotFrozen` on a snapshot view.
        """
        self._check_mutable("merge")
        if not isinstance(other, SketchEngine):
            raise TypeError(f"can only merge SketchEngine, got {type(other)}")
        if other.family.name != self.family.name:
            from repro_torch.ckpt.checkpoint import FamilyMismatch
            raise FamilyMismatch(
                f"merge: cannot fold a {other.family.name!r}-family engine "
                f"into a {self.family.name!r}-family engine — identical "
                f"register bytes, different estimator semantics")
        if other.cfg != self.cfg:
            raise ValueError(
                f"merge requires an identical sketch config (same hash "
                f"family): {self.cfg} != {other.cfg}")
        if other.n != self.n:
            raise ValueError(
                f"merge requires identical vertex universe: n={self.n} vs "
                f"n={other.n}")
        # ``other``'s rows are read by this call: a later in-place ingest
        # into ``other`` cannot reach them
        rows = packing.to_layout(other._true_rows().to(self.device),
                                 other.layout, self.layout)
        self._release_lease()  # the merge writes the panel in place
        self._max_into(rows)
        self._version += 1
        mine, theirs = self.edges, other.edges
        self._edges0 = (None if mine is None or theirs is None
                        else np.concatenate([mine, theirs]))
        self._edge_chunks = []
        self._invalidate_caches()
        return self

    # ---------------------------------------------------------- replication
    @property
    def replicated_ids(self) -> np.ndarray | None:
        """The installed hot-vertex replica set (sorted int64), or ``None``.

        Set by :meth:`replicate` (directly, by a serving placement
        decision, or by ``load`` restoring a checkpoint that carried a
        replica set).
        """
        ids = self._replica_ids
        return None if ids is None else ids.copy()

    def replicate(self, vertex_ids) -> "SketchEngine":
        """Install (or clear) the hot-vertex replica set.

        On one device a replica row would be a byte copy of its owner row,
        so the queries read the owner rows: answers are bit-identical
        with or without replicas, and neither a replica panel nor a
        per-query concatenation of it is paid. The set itself is kept:
        serving placement decisions, snapshots and checkpoints carry it.
        The sharded backend merges the replica rows in its propagate
        passes (``engine.sharded``).

        Args:
          vertex_ids: integer vertex ids in [0, n); duplicates collapse.
            An empty array clears replication.

        Returns self. Raises :class:`SnapshotFrozen` on a snapshot view.
        """
        self._check_mutable("replicate")
        raw = np.asarray(vertex_ids)
        plans.require_integer_ids(raw, "replicate vertex ids")
        ids = np.unique(raw.astype(np.int64).ravel())
        if len(ids) and (ids[0] < 0 or ids[-1] >= self.n):
            raise ValueError(
                f"replicate got vertex ids [{ids[0]}, {ids[-1]}] outside "
                f"the engine's universe [0, {self.n})")
        self._replica_ids = ids if len(ids) else None
        self._on_replicas_changed()
        return self

    def _on_replicas_changed(self) -> None:
        """Hook: a new replica id set was installed (the sharded backend
        reroutes its propagate plan)."""

    # ----------------------------------------------------------- snapshots
    def snapshot(self) -> "SketchEngine":
        """A read-only view of this engine at its current version, in O(1).

        The view (same class) answers every query bit-identically to this
        engine now, and keeps doing so while this engine ingests and
        merges: it shares the register panel, the consolidated edge list
        (concatenation always allocates, so the array is stable), the
        kernel set, the plan cache, the propagate routing and the D^t
        panels and HIP curve rows cached at this version, so a served
        ``neighborhood`` on it reruns no propagate pass.

        The panel is leased to the view: this engine's next ingest or
        merge clones it first (:meth:`_release_lease`), once per
        snapshot-then-write cycle, on the writer's path, never a reader's.
        Snapshots at one version share one panel. Mutating calls on the
        view raise :class:`SnapshotFrozen`.
        """
        edges = self.edges  # consolidate chunks into one stable array
        snap = copy.copy(self)
        snap._edges0 = edges
        snap._edge_chunks = []      # never share the writer's chunk list
        snap._frozen = True
        snap._lessees = weakref.WeakSet()
        snap._snap_lock = threading.RLock()
        ps = self._panel_set
        if ps is not None and ps.version == self._version:
            snap._panel_set = _PanelSet(
                version=ps.version, schedule=ps.schedule,
                panels=list(ps.panels),
                aux={k: list(v) for k, v in ps.aux.items()})
        else:
            snap._panel_set = None
        self._lessees.add(snap)
        return snap

    def _check_mutable(self, what: str) -> None:
        if self._frozen:
            raise SnapshotFrozen(
                f"{what} on a read-only snapshot (version {self._version}); "
                f"ingest into the writer engine it was taken from")

    def _release_lease(self) -> None:
        """Clone the register panel if a live snapshot shares it.

        Called before every in-place write of the panel (accumulate and
        merge); a no-op while no snapshot of the current panel is alive.
        The clone moves the panel's bytes once and holds a second panel
        for as long as the snapshot lives; each clone is counted as a
        ``"lease_clone"`` event.
        """
        if self._lessees:
            self._regs = self._clone_panel(self._regs)
            self._lessees = weakref.WeakSet()
            plans.record_event("lease_clone")

    # ----------------------------------------------------- plan resolution
    def _plan(self, query: str, bucket: tuple = (), extra: tuple = (),
              builder=None):
        """Resolve a query plan through the shared plan cache.

        The key is the JAX package's ``(query, bucket, cfg, backend,
        impl, layout, extra, family)``: engines with identical
        coordinates share plans, and a plan never closes over one
        engine's state.
        """
        key = plans.PlanKey(query=query, bucket=tuple(bucket), cfg=self.cfg,
                            backend=self.backend, impl=self.impl,
                            layout=self.layout, extra=tuple(extra),
                            family=self.kernels.family)
        return self._plan_cache.get(key, builder)

    # ------------------------------------------------------------ queries
    # A replica row would be a byte copy of its owner row, so the gathers
    # below read the owner rows whether or not a replica set is installed:
    # on one device that gives bit-identical answers without concatenating
    # the panel and the replica rows on every query, as the JAX plans do.
    def degrees(self) -> np.ndarray:
        """d̃(x) for every vertex x < n, float32[n]."""
        return self._estimate_panel(self._regs)

    def _require_kind(self, kind: str) -> None:
        """Gate a query kind on the family's declared query surface."""
        if kind not in self.family.query_kinds:
            raise UnsupportedQuery(
                f"query kind {kind!r} is not served by sketch family "
                f"{self.family.name!r} (supported kinds: "
                f"{', '.join(self.family.query_kinds)})")

    def union_size(self, vertex_sets):
        """|∪_{x in S} N(x)| for one vertex set or a batch of sets.

        Accepts a 1-D array (returns a float), a list of 1-D arrays
        (ragged batch) or a 2-D array; batches return float32 arrays [B].
        Non-integer ids and ids outside [0, n) raise ``ValueError``.
        """
        self._require_kind("union")
        sets, scalar = plans.split_sets(vertex_sets, self.n)
        out = self._union_presplit(sets)
        return float(out[0]) if scalar else out

    def _union_presplit(self, sets: list[np.ndarray]) -> np.ndarray:
        """Batched union over parsed, validated id sets: one launch of the
        fused union kernel over the padded ``(B, L)`` panel. The serving
        path calls it with a coalesced batch validated on client
        threads."""
        self._require_kind("union")
        ids, mask = plans.pad_sets(sets)
        fn = self._plan("union", bucket=ids.shape,
                        builder=lambda: plans.build_union_plan(self.cfg,
                                                               self.kernels))
        panel, ids = self._query_panel(ids)
        return fn(panel, ids, mask).cpu().numpy()[: len(sets)]

    def intersection_size(self, pairs, *, method: str = "mle",
                          iters: int | None = None):
        """|N(x) ∩ N(y)| for one (x, y) pair or a batch (B, 2) of pairs.

        ``method="mle"`` is Ertl's maximum-likelihood estimator (the
        paper's T̃(xy); ``iters=None`` takes the family's Newton default),
        ``"ie"`` the inclusion-exclusion baseline (Eq. 18, can be < 0).
        Vertex ids outside [0, n) raise ``ValueError``.
        """
        self._require_kind("intersection")
        iters = self._pair_iters(method, iters)
        with span("pairs.prepare"):
            arr, scalar = plans.split_pairs(pairs, self.n)
        out = self._intersection_presplit(arr, method, iters)
        return float(out[0]) if scalar else out

    def _resolve_iters(self, iters: int | None) -> int | None:
        """``None`` resolves to the family's Newton-iteration default."""
        return self.family.default_iters if iters is None else iters

    def _pair_iters(self, method: str, iters: int | None) -> int:
        """Validate the pair estimator and return its Newton iterations
        (``None`` takes the family's default)."""
        if method not in ("mle", "ie"):
            raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
        return self._resolve_iters(iters)

    def _intersection_presplit(self, arr: np.ndarray, method: str,
                               iters: int) -> np.ndarray:
        """Batched intersection over parsed, validated (B, 2) pairs (the
        serving path's entry, like :meth:`_union_presplit`)."""
        self._require_kind("intersection")
        with span("pairs.prepare"):
            ids, _ = plans.pad_pairs(arr)  # padding pairs (0, 0) sort last
        fn = self._plan(
            "intersection", bucket=(ids.shape[0],), extra=(method, iters),
            builder=lambda: plans.build_intersection_plan(
                self.cfg, self.kernels, method, iters))
        panel, ids = self._query_panel(ids)
        out = fn(panel, ids)
        with span("pairs.copy_back"):
            return out.cpu().numpy()[: arr.shape[0]]

    def query_batch(self, *, vertex_sets=None, pairs=None,
                    degrees: bool = False, method: str = "mle",
                    iters: int | None = None) -> dict:
        """Answer a mixed degrees/union/intersection batch in one call.

        Each kind runs the same kernels under the same padding as its
        per-kind method, so the answers equal those of ``degrees()``,
        ``union_size`` and ``intersection_size`` bit for bit. All inputs
        are validated before any kernel runs.

        Args:
          vertex_sets: union input (the forms :meth:`union_size` takes),
            or ``None`` to skip union queries.
          pairs: intersection input (the forms of
            :meth:`intersection_size`), or ``None`` to skip.
          degrees: include the full d̃(x) table in the answer.
          method / iters: the intersection estimator, one per batch.

        Returns a dict with keys among ``"degrees"``, ``"union"`` and
        ``"intersection"``, arrays shaped like the per-kind methods'
        batched returns.
        """
        iters = self._pair_iters(method, iters)
        sets = arr = None
        if vertex_sets is not None:
            self._require_kind("union")
            sets, _ = plans.split_sets(vertex_sets, self.n)
        if pairs is not None:
            self._require_kind("intersection")
            arr, _ = plans.split_pairs(pairs, self.n)
        return self._query_batch_presplit(sets, arr, degrees, method, iters)

    def _query_batch_presplit(self, sets, arr, want_degrees: bool,
                              method: str, iters: int) -> dict:
        """Mixed-kind batch over parsed inputs: ``sets`` a list of
        validated id arrays or ``None``, ``arr`` validated (B, 2) pairs or
        ``None``; empty inputs are skipped. One kind runs its own plan;
        two or more resolve one ``mixed`` plan keyed by the combined
        buckets, the kinds and the estimator (the serving path's fused
        segment)."""
        if sets:
            self._require_kind("union")
        has_pairs = arr is not None and len(arr) > 0
        if has_pairs:
            self._require_kind("intersection")
        kinds = tuple(k for k, want in (("degrees", want_degrees),
                                        ("union", bool(sets)),
                                        ("intersection", has_pairs)) if want)
        if len(kinds) < 2:  # nothing to fuse: the per-kind plans
            out = {}
            if want_degrees:
                out["degrees"] = self.degrees()
            if sets:
                out["union"] = self._union_presplit(sets)
            if has_pairs:
                out["intersection"] = self._intersection_presplit(
                    arr, method, iters)
            return out
        u_ids, u_mask = (plans.pad_sets(sets) if sets else
                         (np.zeros((1, 1), np.int32), np.zeros((1, 1), bool)))
        p_ids = (plans.pad_pairs(arr)[0] if has_pairs
                 else np.zeros((1, 2), np.int32))
        fn = self._plan(
            "mixed", bucket=(u_ids.shape, p_ids.shape[0]),
            extra=(kinds, method, iters),
            builder=lambda: plans.build_mixed_plan(self.cfg, self.kernels,
                                                   kinds, method, iters))
        panel, u_ids, p_ids = self._query_panel(u_ids, p_ids)
        raw = fn(panel, u_ids, u_mask, p_ids)
        out = {}
        if "degrees" in raw:
            out["degrees"] = raw["degrees"].cpu().numpy()[: self.n]
        if "union" in raw:
            out["union"] = raw["union"].cpu().numpy()[: len(sets)]
        if "intersection" in raw:
            out["intersection"] = raw["intersection"].cpu().numpy()[
                : arr.shape[0]]
        return out

    # ------------------------------------------------- t-hop panel cache
    @property
    def panels_cached(self) -> int:
        """Materialized D^t panels cached for the current version."""
        ps = self._panel_set
        if ps is None or ps.version != self._version:
            return 0
        return len(ps.panels)

    def _panels_up_to(self, t_max: int, sched: str | None = None) -> list:
        """The D^1..D^{t_max} panels under schedule key ``sched`` (default:
        that of "auto"), served from and extending the cache, which holds
        one (version, schedule) at a time.

        Serialized under the engine's lock: a snapshot may be served by
        several reader threads, and extending the cache is the one lazy
        mutation a query makes.
        """
        sched = sched or self._canonical_schedule("auto")
        with self._snap_lock:
            ps = self._panel_set
            if (ps is None or ps.version != self._version
                    or ps.schedule != sched):
                ps = _PanelSet(version=self._version, schedule=sched,
                               panels=[self._regs])
                self._panel_set = ps
            while len(ps.panels) < min(t_max, self.MAX_CACHED_PANELS):
                ps.panels.append(self._propagate_pass(ps.panels[-1], sched))
            out = list(ps.panels[:t_max])
        while len(out) < t_max:  # beyond the memory bound: transient
            out.append(self._propagate_pass(out[-1], sched))
        return out

    def _propagate_pass(self, regs, sched: str):
        """One counted Algorithm 2 pass (the only propagate entry point)."""
        with span("propagate.pass"):
            out = self._propagate(regs, sched)
        self.propagate_passes += 1
        plans.record_event("propagate_pass")
        return out

    def _canonical_schedule(self, schedule: str) -> str:
        """Validate ``schedule`` (one of :data:`SCHEDULES`, ``ValueError``
        otherwise) and return the panel-cache key it maps to (the servers
        coalesce hop queries by it): a single device runs one dataflow for
        every schedule, so all share one key."""
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        return "local"

    def _check_hop_query(self, kind: str, t_max, schedule: str) -> int:
        """Validate a hop query before any work: ``t_max`` an integer >= 1,
        ``kind`` served by the family, ``schedule`` one of
        :data:`SCHEDULES`, and an edge list to route over. Returns
        ``t_max`` as an int."""
        t_max = validate_t_max(t_max)
        self._require_kind(kind)
        self._canonical_schedule(schedule)
        self._require_edges(kind)
        return t_max

    def neighborhood(self, t_max: int, schedule: str = "auto",
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Algorithm 2: t-neighborhood sizes for t = 1..t_max.

        Returns (Ñ(x,t) float64[t_max, n], Ñ(t) float64[t_max]). The
        engine's own registers are not changed. ``schedule`` is one of
        :data:`SCHEDULES`; a single-device backend runs one dataflow and
        gives the same answer for each, from one panel cache. Unknown
        names raise ``ValueError``.
        """
        t_max = self._check_hop_query("neighborhood", t_max, schedule)
        sched = self._canonical_schedule(schedule)
        local = np.zeros((t_max, self.n), dtype=np.float64)
        glob = np.zeros((t_max,), dtype=np.float64)
        for t, regs in enumerate(self._panels_up_to(t_max, sched), start=1):
            with span("engine.estimate"):
                est = self._estimate_panel(regs)
                local[t - 1] = est
                glob[t - 1] = est.sum()
        return local, glob

    # --------------------------------------------- HIP distance queries
    def _hip_curve(self, t_max: int, sched: str | None = None) -> np.ndarray:
        """Cumulative batch-HIP curve C^t float64[t_max, n] (ADS family).

        C^1 is the plain row estimate of D^1; each later hop adds the
        ``hip_delta`` increments of D^{t-1} -> D^t and floors at the plain
        estimate of D^t (``core.ads``). Rows are cached in the panel set's
        ``aux["hip"]`` beside the panels they derive from, so a repeat on
        an unchanged engine runs no kernel; rows beyond
        :attr:`MAX_CACHED_PANELS` are computed transiently, and the
        version bump of ingest and merge drops the cache.
        """
        sched = sched or self._canonical_schedule("auto")
        panels = self._panels_up_to(t_max, sched)
        with self._snap_lock:
            ps = self._panel_set
            cached = (ps.aux.setdefault("hip", []) if ps is not None
                      and ps.version == self._version
                      and ps.schedule == sched else [])
            rows = list(cached[:t_max])
            while len(rows) < t_max:
                i = len(rows)  # panels[i] is D^{i+1}
                plain = self._estimate_panel(panels[i]).astype(np.float64)
                if i == 0:
                    cur = plain
                else:
                    delta = self._hip_delta_panel(panels[i - 1], panels[i])
                    delta = delta.astype(np.float64)
                    cur = np.maximum(rows[i - 1] + delta, plain)
                rows.append(cur)
                if len(cached) == i and i < self.MAX_CACHED_PANELS:
                    cached.append(cur)
        return np.stack(rows)

    def distance_histogram(self, t_max: int, schedule: str = "auto",
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Per-vertex hop-distance histograms h^t(x) for t = 1..t_max.

        ``h^t(x)`` estimates |{y : d(x,y) = t}|, the per-hop increments of
        the cumulative HIP curve (ADS family only; other families raise
        :class:`UnsupportedQuery`). Returns ``(hist float64[t_max, n],
        glob float64[t_max])``, ``glob`` summing each hop over the
        vertices. Served from the same cached D^t panels as
        :meth:`neighborhood`.
        """
        t_max = self._check_hop_query("distance_histogram", t_max, schedule)
        curve = self._hip_curve(t_max, self._canonical_schedule(schedule))
        hist = self.family.hip_histogram(curve)
        return hist, hist.sum(axis=1)

    def closeness(self, t_max: int, schedule: str = "auto") -> np.ndarray:
        """Closeness centralities within a ``t_max``-hop horizon.

        ``c(x) = reach(x) / sum_y d(x, y)`` over the vertices reached
        within ``t_max`` hops, both from the HIP curve (ADS family only).
        Returns float64[n]; isolated vertices get 0.
        """
        t_max = self._check_hop_query("closeness", t_max, schedule)
        return self.family.hip_closeness(
            self._hip_curve(t_max, self._canonical_schedule(schedule)))

    def effective_diameter(self, t_max: int, q: float = 0.9,
                           schedule: str = "auto") -> float:
        """Effective diameter: the smallest t, linearly interpolated
        between hops, at which a ``q`` fraction of the pairs reachable
        within ``t_max`` hops is covered, from the global HIP curve (ADS
        family only). ``q`` must lie in (0, 1].
        """
        t_max = self._check_hop_query("effective_diameter", t_max, schedule)
        glob = self._hip_curve(
            t_max, self._canonical_schedule(schedule)).sum(axis=1)
        return float(self.family.hip_effective_diameter(glob, q))

    # -------------------------------------------------------- persistence
    def checkpoint_state(self) -> tuple[dict, dict]:
        """The ``(tree, extra)`` pair :meth:`save` persists.

        ``tree`` holds host numpy arrays that own their bytes: a copy of
        the registers sliced to the n true rows (``uint8[n, r/2]`` on the
        packed layout, recorded as ``extra["layout"]``), the edge list
        int32[m, 2] if tracked, and the replica id set if one is
        installed. ``extra``
        holds the JAX package's manifest keys except ``impl``: that
        package reads ``impl`` back as its own kernel choice (``ref`` or
        ``pallas``) and defaults it to ``ref`` when absent, so the port
        records none.
        Call it between ingest blocks, not during one.
        """
        tree = {"regs": self._true_rows().to("cpu", copy=True).numpy()}
        edges = self.edges
        if edges is not None:
            tree["edges"] = edges
        if self._replica_ids is not None:
            tree["replica_ids"] = self._replica_ids.copy()
        extra = {
            "format": ENGINE_FORMAT,
            "backend": self.backend,
            "n": self.n,
            "layout": self.layout,
            "family": self.family.name,
            "m_ingested": self.m,
            "cfg": self.family.config_dict(self.cfg),
        }
        extra.update(self._save_extra())
        return tree, extra

    def _save_extra(self) -> dict:
        """Backend-specific manifest keys (the sharded backend's
        ``shards``)."""
        return {}

    def save(self, path: str, step: int = 0) -> str:
        """Persist the sketch as checkpoint step ``step`` under ``path``.

        One ``.npy`` per leaf plus a ``manifest.json`` whose ``extra``
        records family, config, backend, layout and the ingested edge
        count (:meth:`checkpoint_state`). Only the n true rows are stored.
        Legal mid-stream: a loaded engine resumes ingestion where this
        one stopped. Returns the step directory.
        """
        from repro_torch.ckpt.checkpoint import save_checkpoint
        tree, extra = self.checkpoint_state()
        return save_checkpoint(path, step, tree, extra=extra)

    # ------------------------------------------------ panel backend hooks
    # The local backend's panel is one tensor; the sharded backend
    # overrides each of these for its per-shard blocks.
    def _estimate_panel(self, panel) -> np.ndarray:
        """Row estimates float32[n] of a D^t panel (one estimate launch)."""
        est = self.kernels.estimate_rows(panel, self.cfg)
        return est.cpu().numpy()[: self.n]

    def _hip_delta_panel(self, prev, cur) -> np.ndarray:
        """HIP increments float32[n] between two hop panels (ADS)."""
        return self.kernels.hip_delta(prev, cur).cpu().numpy()[: self.n]

    def _clone_panel(self, panel):
        """A copy of the register panel (the lease clone)."""
        return panel.clone()

    def _true_rows(self) -> torch.Tensor:
        """The n true rows uint8[n, w] on :attr:`device` (a view here;
        merge and save read them)."""
        return self._regs[: self.n]

    def _max_into(self, rows: torch.Tensor) -> None:
        """Fold ``rows`` uint8[n, w] (this engine's layout and device) into
        the n true rows in place, nibble by nibble on the packed layout."""
        head = self._regs[: self.n]
        if self.layout == "packed":
            head.copy_(packing.merge_rows(head, rows, self.layout))
        else:
            torch.maximum(head, rows, out=head)

    def _query_panel(self, *ids: np.ndarray) -> tuple:
        """The panel a union, intersection or mixed plan reads and the id
        arrays remapped onto it: here the whole panel and the ids as they
        are."""
        return (self._regs, *ids)

    # ----------------------------------------------------- backend hooks
    @abc.abstractmethod
    def _accumulate_block(self, chunk: np.ndarray) -> None:
        """Scatter-max one undirected edge block int32[<=INGEST_BLOCK, 2]
        into ``self._regs`` in place."""

    @abc.abstractmethod
    def _propagate(self, regs, schedule: str):
        """One Algorithm 2 pass under the schedule key ``schedule``:
        D^t[x] = D^{t-1}[x] ∪̃ (∪̃_{xy∈E} D^{t-1}[y])."""

    @abc.abstractmethod
    def triangle_heavy_hitters(self, k: int, *, mode: str = "edge",
                               iters: int = 30,
                               ) -> tuple[float, np.ndarray, np.ndarray]:
        """Algorithms 4/5: (T̃ global, top-k values, top-k edge/vertex ids)."""
