"""ShardedEngine: the sharded backend (port of ``repro.engine.sharded``).

One controller over per-shard register blocks, the counterpart of the
JAX engine's one object over a device mesh: shard ``s`` owns the rows
``[s * v_loc, (s + 1) * v_loc)`` as its own ``uint8[v_loc, w]`` tensor,
on card ``s mod device_count`` (``distributed.sketch_dist``). Every
entry point answers globally, so serving, snapshots, placement and
reshard hold one engine whatever the shard count.

* ingest routes each chunk to the owner shards on the device and inserts
  it with one accumulate launch per shard;
* degrees, neighborhood estimates and the HIP increments run per shard;
* union, intersection and ``query_batch`` gather their member rows from
  the owner shards into one compact panel with remapped ids, then launch
  the local backend's set and pair kernels, so their answers equal the
  local backend's bit for bit;
* ``neighborhood`` and the ADS distance queries run the ring (``"auto"``,
  ``"ring"``), the double-buffered ring (``"ring_overlap"``) or the
  all-gather schedule over the routing ``DistPlan``, built lazily on the
  device from the ingested edges (and the replica set) under the
  snapshot lock; each schedule's D^t panels are cached apart;
* triangle heavy hitters run per shard over rows gathered from the
  owners, with a distributed top-k; the per-edge estimates are kept for
  the engine's version, so the edge and vertex modes and
  ``edge_triangle_estimates`` share one MLE pass.

The vertex partition is fixed at ``open`` from ``(n, shards)`` alone
(``sketch_dist.vertex_partition``), so ``from_regs`` re-pads a saved
panel of any shard count onto it: a checkpoint reshards on load with no
edge replay.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import sketch_dist as sd
from repro_torch.engine.base import SCHEDULES, SketchEngine
from repro_torch.kernels import packing, registry
from repro_torch.kernels.inputs import directed_block, resolve_device

__all__ = ["ShardedEngine", "default_shards"]


def default_shards(device: torch.device) -> int:
    """Shards when the caller passes none: one per visible card on the
    card, one on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _check_shards(shards) -> int:
    if isinstance(shards, bool) or not isinstance(shards, (int, np.integer)) \
            or shards < 1:
        raise ValueError(f"shards must be an integer >= 1, got {shards!r}")
    return int(shards)


class ShardedEngine(SketchEngine):
    """Sharded engine: register rows block-partitioned over ``shards``
    per-shard tensors ``uint8[v_loc, w]``."""

    backend = "sharded"

    def __init__(self, parts: list, n: int, cfg, edges, *, layout="byte",
                 impl="cuda", plan: sd.DistPlan | None = None):
        super().__init__(parts, n, cfg, edges, layout=layout, impl=impl)
        self.shards = len(parts)
        self.v_loc = int(parts[0].shape[0])
        self._dist_plan = plan
        self._tri = None  # ((version, iters), per-shard T̃(uv))

    # ------------------------------------------------------------- state
    @property
    def device(self) -> torch.device:
        """The first shard's device: queries gather onto it."""
        return self._regs[0].device

    @property
    def devices(self) -> list:
        """Each shard's device."""
        return [p.device for p in self._regs]

    @property
    def n_pad(self) -> int:
        """Padded vertex-row count, ``shards * v_loc`` (>= n)."""
        return self.shards * self.v_loc

    @property
    def regs(self) -> torch.Tensor:
        """The whole register table uint8[n_pad, w], gathered into a new
        tensor on :attr:`device` (a copy: later ingests do not reach it).
        :attr:`shard_regs` are the shards' own tensors."""
        return torch.cat([p.to(self.device) for p in self._regs])

    @property
    def shard_regs(self) -> list:
        """The per-shard register tensors uint8[v_loc, w] (shard s holds
        rows ``[s * v_loc, (s + 1) * v_loc)``)."""
        return list(self._regs)

    # ------------------------------------------------------------- plan
    @property
    def plan(self) -> sd.DistPlan:
        """The routing ``DistPlan`` of the edges ingested so far (and the
        installed replica set), built on the device at first use.

        Rebuilt lazily after ingest, merge or ``replicate`` drops it; the
        build is double-checked under the snapshot lock, so reader threads
        of one snapshot build it once, and a snapshot taken after the
        build shares it (it is immutable). Requires a tracked edge list.
        """
        if self._dist_plan is None:
            with self._snap_lock:
                if self._dist_plan is None:
                    edges = self._require_edges(
                        "the distributed routing plan")
                    self._dist_plan = sd.build_plan(
                        edges, self.n, self.shards, device=self.device,
                        replica_ids=self._replica_ids, devices=self.devices)
        return self._dist_plan

    def _invalidate_caches(self) -> None:
        super()._invalidate_caches()
        self._dist_plan = None

    def _on_replicas_changed(self) -> None:
        """A new replica set reroutes hot-source edges: rebuild the plan.
        The panels are unchanged (register max commutes), so the cached
        D^t panels stay."""
        self._dist_plan = None

    # ------------------------------------------------------ construction
    @staticmethod
    def _tables(n: int, cfg, shards: int, layout: str, impl: str, dev,
                ) -> list:
        kernels = registry.resolve(cfg, layout=layout, impl=impl)
        fam = registry.family(kernels.family)
        _, v_loc = sd.vertex_partition(n, shards)
        return [fam.empty_table(v_loc, cfg, layout=layout, device=d)
                for d in sd.shard_devices(dev, shards)]

    @classmethod
    def open(cls, n: int, cfg, *, shards: int | None = None,
             layout: str = "byte", impl: str = "cuda",
             device=None) -> "ShardedEngine":
        """An empty engine over [0, n), ready to ingest.

        Fixes the block partition ``(n_pad, v_loc)`` from ``(n, shards)``
        and allocates each shard's zeroed ``uint8[v_loc, w]`` on its
        device (``None`` means the card, and raises without one).
        ``shards`` defaults to :func:`default_shards`.
        """
        dev = resolve_device(device)
        shards = _check_shards(default_shards(dev) if shards is None
                               else shards)
        parts = cls._tables(n, cfg, shards, layout, impl, dev)
        return cls(parts, n, cfg, np.zeros((0, 2), np.int32), layout=layout,
                   impl=impl)

    @classmethod
    def build(cls, edges: np.ndarray, n: int, cfg, *,
              shards: int | None = None, layout: str = "byte",
              impl: str = "cuda", device=None) -> "ShardedEngine":
        """Algorithm 1, sharded, in one call: ``open`` + ``ingest``."""
        return cls.open(n, cfg, shards=shards, layout=layout, impl=impl,
                        device=device).ingest(edges)

    @classmethod
    def from_regs(cls, regs, n: int, cfg, *, edges: np.ndarray | None = None,
                  shards: int | None = None, layout: str = "byte",
                  impl: str = "cuda", device=None) -> "ShardedEngine":
        """Re-host a row table uint8[>=n, w] (numpy or tensor) on
        ``shards`` shards.

        The n true rows are re-padded to this shard count's partition, so
        a panel saved at any shard count (or by the local backend) loads
        at any other; the routing plan, when a query needs it, is rebuilt
        from ``edges``. The row width must be that of ``layout``
        (``ValueError`` otherwise).
        """
        dev = resolve_device(device)
        shards = _check_shards(default_shards(dev) if shards is None
                               else shards)
        table = (regs if isinstance(regs, torch.Tensor)
                 else torch.from_numpy(np.array(regs)))
        if table.dtype != torch.uint8 or table.dim() != 2:
            raise ValueError(f"regs must be uint8[n, r], got {table.dtype}"
                             f"{list(table.shape)}")
        want = packing.row_width(cfg.r, layout)
        if table.shape[1] != want:
            raise ValueError(
                f"register rows have width {table.shape[1]}, but layout "
                f"{layout!r} at p={cfg.p} needs width {want}")
        parts = cls._tables(n, cfg, shards, layout, impl, dev)
        v_loc = parts[0].shape[0]
        rows = table[:n]
        for s, part in enumerate(parts):
            blk = rows[s * v_loc:(s + 1) * v_loc]
            part[: blk.shape[0]] = blk.to(part.device)
        return cls(parts, n, cfg, edges, layout=layout, impl=impl)

    # ------------------------------------------------------ backend hooks
    def _accumulate_block(self, chunk: np.ndarray) -> None:
        """Both orientations of the chunk, built on the first shard's
        device, routed to the owners of their rows there, and inserted
        with one accumulate launch per owner shard."""
        rows, keys = directed_block(chunk, self.device)
        sd.accumulate_block(
            self._regs, rows, keys, self.v_loc,
            lambda part, r, k: self.kernels.accumulate(part, r, k, self.cfg))

    def _canonical_schedule(self, schedule: str) -> str:
        """Each schedule keys its own D^t panels; "auto" is the ring."""
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        return "ring" if schedule == "auto" else schedule

    def _propagate(self, regs: list, schedule: str) -> list:
        if schedule in ("ring", "ring_overlap"):
            return sd.dist_propagate_ring(
                self.plan, regs, layout=self.layout, impl=self.impl,
                overlap=schedule == "ring_overlap")
        return sd.dist_propagate_allgather(self.plan, regs,
                                           layout=self.layout,
                                           impl=self.impl)

    def triangle_heavy_hitters(self, k, *, mode="edge", iters=30):
        """Algorithms 4/5 over the shards (see the base class):
        ``sketch_dist.dist_triangle_heavy_hitters`` over the plan's
        triangle groups."""
        self._require_kind("triangle")
        if mode not in ("edge", "vertex"):
            raise ValueError(f"mode must be 'edge' or 'vertex', got {mode!r}")
        return sd.triangle_top(self.plan, self._triangle_estimates(iters), k,
                               mode)

    def edge_triangle_estimates(self, iters: int = 30) -> np.ndarray:
        """T̃(xy) of every ingested edge, float64[m] in the edge list's
        order (the per-edge values behind :meth:`triangle_heavy_hitters`)."""
        self._require_kind("triangle")
        return sd.dist_edge_triangle_estimates(
            self.plan, self.cfg, self._regs,
            ests=self._triangle_estimates(iters))

    def _triangle_estimates(self, iters: int) -> list:
        """The shards' triangle-group estimates at this version and
        ``iters``, computed once (under the snapshot lock) and kept until
        the next ingest or merge."""
        with self._snap_lock:
            key = (self._version, iters)
            if self._tri is None or self._tri[0] != key:
                self._tri = (key, sd.shard_triangle_estimates(
                    self.plan, self.cfg, self._regs, iters, self.layout,
                    self.impl))
            return self._tri[1]

    def _save_extra(self) -> dict:
        """Record the shard count, as the JAX package's manifest does."""
        return {"shards": self.shards}

    # ------------------------------------------------ panel backend hooks
    def _estimate_panel(self, panel: list) -> np.ndarray:
        est = [self.kernels.estimate_rows(p, self.cfg).cpu().numpy()
               for p in panel]
        return np.concatenate(est)[: self.n]

    def _hip_delta_panel(self, prev: list, cur: list) -> np.ndarray:
        delta = [self.kernels.hip_delta(a, b).cpu().numpy()
                 for a, b in zip(prev, cur)]
        return np.concatenate(delta)[: self.n]

    def _clone_panel(self, panel: list) -> list:
        return [p.clone() for p in panel]

    def _true_rows(self) -> torch.Tensor:
        return self.regs[: self.n]

    def _max_into(self, rows: torch.Tensor) -> None:
        for s, part in enumerate(self._regs):
            blk = rows[s * self.v_loc:(s + 1) * self.v_loc]
            if blk.shape[0] == 0:
                break
            head = part[: blk.shape[0]]
            blk = blk.to(part.device)
            if self.layout == "packed":
                head.copy_(packing.merge_rows(head, blk, self.layout))
            else:
                torch.maximum(head, blk, out=head)

    def _query_panel(self, *ids: np.ndarray) -> tuple:
        """Gather every row the query names from its owner shard into one
        compact panel on :attr:`device`; the ids become indices into it.
        The kernels' answers depend only on the rows they read, so they
        equal the local backend's bit for bit."""
        uniq = np.unique(np.concatenate([a.ravel() for a in ids]))
        gids = torch.from_numpy(uniq.astype(np.int64)).to(self.device)
        panel = sd.gather_rows(self._regs, self.v_loc, gids, self.device)
        return (panel, *(np.searchsorted(uniq, a).astype(np.int32)
                         for a in ids))

    def _query_batch_presplit(self, sets, arr, want_degrees: bool,
                              method: str, iters: int) -> dict:
        """Degrees run per shard; the union and intersection kinds on the
        gathered panel, so degrees leave the fused plan."""
        out = super()._query_batch_presplit(sets, arr, False, method, iters)
        if want_degrees:
            out["degrees"] = self.degrees()
        return out
