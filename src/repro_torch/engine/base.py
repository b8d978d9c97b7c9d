"""SketchEngine: the persistent sketch query surface (port of
``repro.engine.base``, the subset this slice serves).

An engine owns an accumulated register panel ``uint8[n_pad, w]`` on one
device: ``w = r`` bytes on the byte layout, ``r/2`` on the packed 4-bit
layout (``kernels.packing``), whose kernels serve every query alike.
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
  for all of them, as the JAX local backend does
* ``triangle_heavy_hitters(k, mode=)``   — Algorithms 4/5
* ``distance_histogram / closeness / effective_diameter`` — HIP-curve
  distance queries of the ADS family, built on the same cached D^t
  panels as ``neighborhood``; the curve rows are cached beside them

``merge(other)`` folds another engine's sketch in by register max
(Algorithm 6 MERGE; nibble-wise on packed panels, converting ``other``'s
rows when its layout differs), and ``save(path)`` writes a checkpoint in
the JAX package's format that ``repro_torch.engine.load`` and the JAX package's
``repro.engine.load`` both restore. Not ported yet, and absent rather
than stubbed: snapshots and the replica panel (ROADMAP).

Query kinds the engine's sketch family does not serve raise
:class:`UnsupportedQuery` up front. Ids are validated on the host before
anything reaches the device.
"""
from __future__ import annotations

import abc
import operator
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.engine import plans
from repro_torch.kernels import packing, registry

#: the ``format`` a checkpoint of an engine records (the JAX package's)
ENGINE_FORMAT = "degreesketch-engine-v1"

__all__ = ["SketchEngine", "ENGINE_FORMAT", "UnsupportedQuery", "SCHEDULES",
           "resolve_device", "validate_t_max", "pad_vertices"]

#: Algorithm 2 schedules every backend accepts; the sharded backend (not
#: ported yet) picks its dataflow by them, a single-device one ignores them
SCHEDULES = ("auto", "ring", "ring_overlap", "allgather")


class UnsupportedQuery(ValueError):
    """Raised for a query kind the engine's sketch family cannot answer."""


def resolve_device(device=None) -> torch.device:
    """The engine device: ``None`` means the card, which must be present.

    Entry points never carry on on the CPU by themselves: asking for (or
    defaulting to) ``cuda`` without a card raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def pad_vertices(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple (register-table row padding)."""
    return ((n + multiple - 1) // multiple) * multiple


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
    """Materialized D^t register panels for one engine version.

    ``panels[i]`` is D^{i+1}: ``panels[0]`` is the accumulated panel
    itself, each later entry one more Algorithm 2 pass over it. Valid only
    while the engine's ``version`` equals ``version``. ``aux`` holds
    derived per-hop caches with the same lifetime: the ADS family's
    cumulative HIP curve rows (``aux["hip"][i]`` is C^{i+1}, host
    float64[n]).
    """

    version: int
    panels: list = field(default_factory=list)
    aux: dict = field(default_factory=dict)


class SketchEngine(abc.ABC):
    """Backend-agnostic persistent query engine over an accumulated sketch.

    Construct through :mod:`repro_torch.engine` (``open``/``build``) or
    ``LocalEngine.from_regs``. Subclasses provide the block accumulation
    step and one propagate pass.
    """

    backend = "abstract"

    #: undirected edges per accumulate launch; ``ingest`` splits larger
    #: blocks. The JAX package's 2^15 serves XLA's static shape buckets;
    #: the CUDA kernel takes any length, so a chunk here is as large as
    #: host and device memory allow cheaply (32 MB of host ids, 64 MB of
    #: directed ids on the device) and a 64M-edge build takes 16 launches
    INGEST_BLOCK = 1 << 22

    #: at most this many D^t panels are kept (~n_pad * r bytes each);
    #: deeper horizons are computed transiently
    MAX_CACHED_PANELS = 8

    def __init__(self, regs: torch.Tensor, n: int, cfg,
                 edges: np.ndarray | None, layout: str = "byte"):
        self.kernels = registry.resolve(cfg, layout=layout)
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
        #: Algorithm 2 passes run by this engine (the panel cache's proof)
        self.propagate_passes = 0
        #: hot-vertex replica ids (int64) a loaded checkpoint carried, kept
        #: as plain data and written back by :meth:`save`; the port builds
        #: no replica panel yet (ROADMAP)
        self.replica_ids: np.ndarray | None = None

    # ------------------------------------------------------------- state
    @property
    def device(self) -> torch.device:
        """The device the register panel lives on."""
        return self._regs.device

    @property
    def n_pad(self) -> int:
        """Padded vertex-row count of the register table (>= n)."""
        return int(self._regs.shape[0])

    @property
    def version(self) -> int:
        """Panel version: bumps on every ingest that changes the panel."""
        return self._version

    @property
    def regs(self) -> torch.Tensor:
        """The accumulated register table uint8[n_pad, w] (w = r, or r/2 on
        the packed layout).

        Ingest updates this tensor in place (the JAX engine donates it),
        so a handle taken before an ``ingest`` sees the new registers.
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
            self._edges0 = np.concatenate([self._edges0] + self._edge_chunks)
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
        """
        raw = np.asarray(edge_block)
        if raw.ndim != 2 or raw.shape[1] != 2:
            raise ValueError(
                f"edge_block must have shape (k, 2), got {raw.shape}")
        if raw.shape[0] == 0:
            return self
        block = _check_edge_ids(raw, self.n, "edge block")
        for s in range(0, len(block), self.INGEST_BLOCK):
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
        untouched. Returns self.
        """
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
        head = self._regs[: self.n]
        rows = packing.to_layout(other.regs[: self.n].to(self.device),
                                 other.layout, self.layout)
        if self.layout == "packed":
            head.copy_(packing.merge_rows(head, rows, self.layout))
        else:
            torch.maximum(head, rows, out=head)
        self._version += 1
        mine, theirs = self.edges, other.edges
        self._edges0 = (None if mine is None or theirs is None
                        else np.concatenate([mine, theirs]))
        self._edge_chunks = []
        self._invalidate_caches()
        return self

    # ------------------------------------------------------------ queries
    def degrees(self) -> np.ndarray:
        """d̃(x) for every vertex x < n, float32[n]."""
        est = self.kernels.estimate_rows(self._regs, self.cfg)
        return est.cpu().numpy()[: self.n]

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
        fused union kernel over the padded ``(B, L)`` panel."""
        ids, mask = plans.pad_sets(sets)
        est = self.kernels.union_estimate(
            self._regs, torch.from_numpy(ids).to(self.device),
            torch.from_numpy(mask).to(self.device), self.cfg)
        return est.cpu().numpy()[: len(sets)]

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
        arr, scalar = plans.split_pairs(pairs, self.n)
        out = self._intersection_presplit(arr, method, iters)
        return float(out[0]) if scalar else out

    def _pair_iters(self, method: str, iters: int | None) -> int:
        """Validate the pair estimator and return its Newton iterations
        (``None`` takes the family's default)."""
        if method not in ("mle", "ie"):
            raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
        return self.family.default_iters if iters is None else iters

    def _intersection_presplit(self, arr: np.ndarray, method: str,
                               iters: int) -> np.ndarray:
        """Batched intersection over parsed, validated (B, 2) pairs."""
        ids, _ = plans.pad_pairs(arr)  # padding pairs (0, 0) sort last
        ids_t = torch.from_numpy(ids).to(self.device)
        stats, sz = self.kernels.intersection_stats(self._regs, ids_t,
                                                    self.cfg)
        est = self.family.estimate_from_pair_stats(stats, sz, self.cfg,
                                                   method, iters)
        return est.cpu().numpy()[: arr.shape[0]]

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
        ``None``; empty inputs are skipped."""
        out = {}
        if want_degrees:
            out["degrees"] = self.degrees()
        if sets:
            out["union"] = self._union_presplit(sets)
        if arr is not None and len(arr):
            out["intersection"] = self._intersection_presplit(arr, method,
                                                              iters)
        return out

    # ------------------------------------------------- t-hop panel cache
    @property
    def panels_cached(self) -> int:
        """Materialized D^t panels cached for the current version."""
        ps = self._panel_set
        if ps is None or ps.version != self._version:
            return 0
        return len(ps.panels)

    def _panels_up_to(self, t_max: int) -> list:
        """The D^1..D^{t_max} panels, served from and extending the cache."""
        ps = self._panel_set
        if ps is None or ps.version != self._version:
            ps = _PanelSet(version=self._version, panels=[self._regs])
            self._panel_set = ps
        while len(ps.panels) < min(t_max, self.MAX_CACHED_PANELS):
            ps.panels.append(self._propagate_pass(ps.panels[-1]))
        out = list(ps.panels[:t_max])
        while len(out) < t_max:  # beyond the memory bound: transient
            out.append(self._propagate_pass(out[-1]))
        return out

    def _propagate_pass(self, regs: torch.Tensor) -> torch.Tensor:
        """One counted Algorithm 2 pass (the only propagate entry point)."""
        out = self._propagate(regs)
        self.propagate_passes += 1
        return out

    def _check_hop_query(self, kind: str, t_max, schedule: str) -> int:
        """Validate a hop query before any work: ``t_max`` an integer >= 1,
        ``kind`` served by the family, ``schedule`` one of
        :data:`SCHEDULES`, and an edge list to route over. Returns
        ``t_max`` as an int."""
        t_max = validate_t_max(t_max)
        self._require_kind(kind)
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {schedule!r}")
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
        local = np.zeros((t_max, self.n), dtype=np.float64)
        glob = np.zeros((t_max,), dtype=np.float64)
        for t, regs in enumerate(self._panels_up_to(t_max), start=1):
            est = self.kernels.estimate_rows(regs, self.cfg).cpu().numpy()
            est = est[: self.n]
            local[t - 1] = est
            glob[t - 1] = est.sum()
        return local, glob

    # --------------------------------------------- HIP distance queries
    def _hip_curve(self, t_max: int) -> np.ndarray:
        """Cumulative batch-HIP curve C^t float64[t_max, n] (ADS family).

        C^1 is the plain row estimate of D^1; each later hop adds the
        ``hip_delta`` increments of D^{t-1} -> D^t and floors at the plain
        estimate of D^t (``core.ads``). Rows are cached in the panel set's
        ``aux["hip"]`` beside the panels they derive from, so a repeat on
        an unchanged engine runs no kernel; rows beyond
        :attr:`MAX_CACHED_PANELS` are computed transiently, and the
        version bump of ingest and merge drops the cache.
        """
        panels = self._panels_up_to(t_max)
        cached = self._panel_set.aux.setdefault("hip", [])
        rows = list(cached[:t_max])
        while len(rows) < t_max:
            i = len(rows)  # panels[i] is D^{i+1}
            plain = self.kernels.estimate_rows(panels[i], self.cfg)
            plain = plain.cpu().numpy()[: self.n].astype(np.float64)
            if i == 0:
                cur = plain
            else:
                delta = self.kernels.hip_delta(panels[i - 1], panels[i])
                delta = delta.cpu().numpy()[: self.n].astype(np.float64)
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
        hist = self.family.hip_histogram(self._hip_curve(t_max))
        return hist, hist.sum(axis=1)

    def closeness(self, t_max: int, schedule: str = "auto") -> np.ndarray:
        """Closeness centralities within a ``t_max``-hop horizon.

        ``c(x) = reach(x) / sum_y d(x, y)`` over the vertices reached
        within ``t_max`` hops, both from the HIP curve (ADS family only).
        Returns float64[n]; isolated vertices get 0.
        """
        t_max = self._check_hop_query("closeness", t_max, schedule)
        return self.family.hip_closeness(self._hip_curve(t_max))

    def effective_diameter(self, t_max: int, q: float = 0.9,
                           schedule: str = "auto") -> float:
        """Effective diameter: the smallest t, linearly interpolated
        between hops, at which a ``q`` fraction of the pairs reachable
        within ``t_max`` hops is covered, from the global HIP curve (ADS
        family only). ``q`` must lie in (0, 1].
        """
        t_max = self._check_hop_query("effective_diameter", t_max, schedule)
        glob = self._hip_curve(t_max).sum(axis=1)
        return float(self.family.hip_effective_diameter(glob, q))

    # -------------------------------------------------------- persistence
    def checkpoint_state(self) -> tuple[dict, dict]:
        """The ``(tree, extra)`` pair :meth:`save` persists.

        ``tree`` holds host numpy arrays: the registers sliced to the n
        true rows (``uint8[n, r/2]`` on the packed layout, recorded as
        ``extra["layout"]``), the edge list int32[m, 2] if tracked, and
        the replica id set if a loaded checkpoint carried one. ``extra``
        holds the JAX package's manifest keys except ``impl``: that
        package reads ``impl`` back as its own kernel choice (``ref`` or
        ``pallas``) and defaults it to ``ref`` when absent, so the port
        records none.
        Call it between ingest blocks, not during one.
        """
        tree = {"regs": self._regs[: self.n].cpu().numpy()}
        edges = self.edges
        if edges is not None:
            tree["edges"] = edges
        if self.replica_ids is not None:
            tree["replica_ids"] = np.asarray(self.replica_ids, np.int64)
        extra = {
            "format": ENGINE_FORMAT,
            "backend": self.backend,
            "n": self.n,
            "layout": self.layout,
            "family": self.family.name,
            "m_ingested": self.m,
            "cfg": self.family.config_dict(self.cfg),
        }
        return tree, extra

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

    # ----------------------------------------------------- backend hooks
    @abc.abstractmethod
    def _accumulate_block(self, chunk: np.ndarray) -> None:
        """Scatter-max one undirected edge block int32[<=INGEST_BLOCK, 2]
        into ``self._regs`` in place."""

    @abc.abstractmethod
    def _propagate(self, regs: torch.Tensor) -> torch.Tensor:
        """One Algorithm 2 pass: D^t[x] = D^{t-1}[x] ∪̃ (∪̃_{xy∈E} D^{t-1}[y])."""

    @abc.abstractmethod
    def triangle_heavy_hitters(self, k: int, *, mode: str = "edge",
                               iters: int = 30,
                               ) -> tuple[float, np.ndarray, np.ndarray]:
        """Algorithms 4/5: (T̃ global, top-k values, top-k edge/vertex ids)."""
