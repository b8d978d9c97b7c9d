"""SketchEngine: the persistent sketch query surface (port of
``repro.engine.base``, the subset this slice serves).

An engine owns an accumulated register panel ``uint8[n_pad, r]`` on one
device. ``ingest(edge_block)`` folds edge blocks into it in place
(Algorithm 1); queries answer from it:

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

Not ported yet, and absent rather than stubbed: ``merge``, snapshots,
replicas, persistence and the ADS distance queries (ROADMAP).

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
from repro_torch.kernels import registry

__all__ = ["SketchEngine", "UnsupportedQuery", "SCHEDULES", "resolve_device",
           "validate_t_max", "pad_vertices"]

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
    while the engine's ``version`` equals ``version``.
    """

    version: int
    panels: list = field(default_factory=list)


class SketchEngine(abc.ABC):
    """Backend-agnostic persistent query engine over an accumulated sketch.

    Construct through :mod:`repro_torch.engine` (``open``/``build``) or
    ``LocalEngine.from_regs``. Subclasses provide the block accumulation
    step and one propagate pass.
    """

    backend = "abstract"

    #: edges per internal accumulate step; ``ingest`` splits larger blocks
    INGEST_BLOCK = 1 << 15

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
        """The accumulated register table uint8[n_pad, r].

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
        ``INGEST_BLOCK`` are split; each directed sub-block is padded to a
        power-of-two size with a validity mask. Register max is
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
        self._prop_routing = None
        self._panel_set = None
        return self

    def ingest_stream(self, stream) -> "SketchEngine":
        """Drain an edge stream (anything with ``all_blocks()``, such as an
        ``EdgeStream``) into the sketch, block by block."""
        for blk in stream.all_blocks():
            self.ingest(blk)
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

    def neighborhood(self, t_max: int, schedule: str = "auto",
                     ) -> tuple[np.ndarray, np.ndarray]:
        """Algorithm 2: t-neighborhood sizes for t = 1..t_max.

        Returns (Ñ(x,t) float64[t_max, n], Ñ(t) float64[t_max]). The
        engine's own registers are not changed. ``schedule`` is one of
        :data:`SCHEDULES`; a single-device backend runs one dataflow and
        gives the same answer for each, from one panel cache. Unknown
        names raise ``ValueError``.
        """
        self._require_kind("neighborhood")
        t_max = validate_t_max(t_max)
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        self._require_edges("neighborhood")
        local = np.zeros((t_max, self.n), dtype=np.float64)
        glob = np.zeros((t_max,), dtype=np.float64)
        for t, regs in enumerate(self._panels_up_to(t_max), start=1):
            est = self.kernels.estimate_rows(regs, self.cfg).cpu().numpy()
            est = est[: self.n]
            local[t - 1] = est
            glob[t - 1] = est.sum()
        return local, glob

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
