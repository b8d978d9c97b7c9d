"""Sharded DegreeSketch: per-shard register panels, the routing plan and
the schedules of Algorithms 1-5 (port of ``repro.distributed.sketch_dist``).

The JAX package runs one ``shard_map`` program over a device mesh; the
port runs one controller over per-shard device tensors, its faithful
counterpart. Shard ``s`` owns the vertex block ``[s * v_loc, (s + 1) *
v_loc)`` (the block partition f of :func:`vertex_partition`) as its own
``uint8[v_loc, w]`` allocation on device ``s mod device_count`` (all on
one card when there is one; all on the CPU for ``device="cpu"``). The
collectives become explicit tensor copies between shard panels, so every
exchange moves real bytes even when the shards share a card:

* a ``ppermute`` is a copy of each shard's in-flight block to the next
  shard's receive buffer;
* an ``all_gather`` is a concatenation of every block onto the reading
  shard;
* a replica panel is gathered once from the owners and copied to every
  shard.

:func:`copied_bytes` counts the bytes each kind of exchange moved.

:func:`build_plan` plays Algorithm 1's Send context: it routes the edge
list to owner shards on the engine's device with stable ``torch.sort``
(the JAX package sorts with numpy on the host). Groups are ragged:
offsets into one sorted edge tensor, never panels padded to the largest
group, and every accumulate, ring, all-gather and replica group is
sorted by its local destination, the order the pull kernel reads.

Every schedule merges rows with the two-panel propagate kernel
(``ops.propagate_into``), the port's kernel for the JAX package's
``packing.scatter_max_rows``: ``out[dst] max= src_panel[src]`` in place,
where ``src_panel`` is a ring step's in-flight block, an all-gathered
panel or the replica panel. Triangles run the MLE of
``core.intersection`` (the ``ertl_stats`` kernel) per shard over rows
gathered from the owners.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import intersection
from repro_torch.core.degreesketch import EDGE_BLOCK
from repro_torch.distributed.topk import distributed_topk
from repro_torch.kernels import ops
from repro_torch.kernels.inputs import _to_device, directed_routing

__all__ = [
    "DistPlan", "vertex_partition", "shard_devices", "build_plan",
    "accumulate_block", "dist_accumulate", "dist_propagate_allgather",
    "dist_propagate_ring", "shard_triangle_estimates",
    "dist_edge_triangle_estimates", "triangle_top",
    "dist_triangle_heavy_hitters", "gather_rows", "copied_bytes",
    "reset_copied_bytes",
]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def vertex_partition(n: int, num_shards: int,
                     pad_multiple: int = 8) -> tuple[int, int]:
    """The block vertex partition f: returns (n_pad, v_loc), as the JAX
    package's. A function of (n, num_shards) alone, so an engine fixes its
    row layout at ``open`` and a plan rebuilt from later edges lands on
    the same partition."""
    n_pad = _round_up(max(n, num_shards), num_shards * pad_multiple)
    return n_pad, n_pad // num_shards


def shard_devices(device: torch.device, num_shards: int,
                  ) -> list[torch.device]:
    """Where each shard's panel lives: shard ``s`` on card ``s mod
    device_count`` for a CUDA ``device``, every shard on the CPU for a CPU
    one."""
    if device.type != "cuda":
        return [device] * num_shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(num_shards)]


# ------------------------------------------------------- exchange counters
_BYTES_LOCK = threading.Lock()
_BYTES = {"ppermute": 0, "all_gather": 0, "replica": 0, "rows": 0}


def _count(kind: str, n_bytes: int) -> None:
    with _BYTES_LOCK:
        _BYTES[kind] += int(n_bytes)


def copied_bytes() -> dict[str, int]:
    """Bytes copied between shards since the last reset, by exchange:
    ``ppermute`` (ring steps), ``all_gather`` (concatenated panels),
    ``replica`` (replica panels gathered and copied to every shard) and
    ``rows`` (rows gathered from owner shards for queries and
    triangles)."""
    with _BYTES_LOCK:
        return dict(_BYTES)


def reset_copied_bytes() -> None:
    """Set every exchange's byte counter to 0."""
    with _BYTES_LOCK:
        for k in _BYTES:
            _BYTES[k] = 0


def _copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A fresh copy of ``t`` on ``device``: a new allocation even on the
    same device, so the exchange moves the bytes."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def gather_rows(parts: list[torch.Tensor], v_loc: int, gids: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """Rows ``gids`` (global vertex ids, int64 on ``device``) of a sharded
    panel, gathered from their owner shards into one new panel
    ``uint8[len(gids), w]`` on ``device``."""
    w = parts[0].shape[1]
    out = torch.empty((gids.shape[0], w), dtype=torch.uint8, device=device)
    if gids.shape[0] == 0:
        return out
    if len(parts) == 1:
        out.copy_(parts[0][gids.to(parts[0].device)])
    else:
        owner = torch.div(gids, v_loc, rounding_mode="floor")
        for s, part in enumerate(parts):
            sel = (owner == s).nonzero().squeeze(1)
            if sel.numel():
                local = (gids[sel] - s * v_loc).to(part.device)
                out[sel] = part[local].to(device)
    _count("rows", gids.shape[0] * w)
    return out


# ------------------------------------------------------------------ plan
@dataclass
class DistPlan:
    """The routing plan: the Send context, precomputed on the device.

    Per-shard lists hold shard ``s``'s group on ``devices[s]``; each is a
    slice of one sorted edge tensor (ragged, unpadded). Local ids are
    relative to the shard's (or, for ``ring_src``, the source block's)
    first vertex.
    """

    n: int
    n_pad: int
    v_loc: int
    num_shards: int
    devices: list
    # accumulation: directed (dst_local, key) owned by the dst shard,
    # sorted by dst_local (every directed edge, replicas or not)
    acc_dst: list
    acc_key: list
    # ring: shard s's edges grouped by source block b (offsets
    # ring_off[s][b] .. ring_off[s][b + 1]), each group sorted by dst_local
    ring_src: list
    ring_dst: list
    ring_off: list
    # all-gather: shard s's edges, src global, sorted by dst_local
    flat_src: list
    flat_dst: list
    # triangles: undirected edges owned by the shard of u, sorted by u;
    # tri_idx[s] their rows in the edge list (int64)
    tri_u: list
    tri_v: list
    tri_idx: list
    # hot-vertex replicas: propagate edges whose SOURCE is replicated leave
    # the ring and all-gather groups and merge from the replica panel,
    # rows ``rep_gids`` of D^{t-1}; rep_slot indexes that panel
    rep_ids: np.ndarray | None = None
    rep_gids: torch.Tensor | None = None
    rep_dst: list | None = None
    rep_slot: list | None = None

    @property
    def has_replicas(self) -> bool:
        """Whether this plan routes any edges through the replica panel."""
        return self.rep_ids is not None and len(self.rep_ids) > 0

    def ring_group(self, s: int, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard ``s``'s edges whose source lies in block ``b``: (src local
        to the block, dst local to the shard)."""
        lo, hi = self.ring_off[s][b], self.ring_off[s][b + 1]
        return self.ring_src[s][lo:hi], self.ring_dst[s][lo:hi]


def _bounds(sorted_ids: torch.Tensor, v_loc: int, num_shards: int,
            ) -> list[int]:
    """Offsets of each shard's block in ids sorted ascending."""
    cuts = torch.arange(num_shards + 1, device=sorted_ids.device,
                        dtype=sorted_ids.dtype) * v_loc
    return torch.searchsorted(sorted_ids, cuts).tolist()


def _split(t: torch.Tensor, bounds: list[int], devices: list) -> list:
    return [t[bounds[s]:bounds[s + 1]].to(devices[s])
            for s in range(len(devices))]


def build_plan(edges: np.ndarray, n: int, num_shards: int,
               device: torch.device | str = "cpu", pad_multiple: int = 8,
               replica_ids: np.ndarray | None = None,
               devices: list | None = None) -> DistPlan:
    """Route an undirected edge list ``int32[m, 2]`` to owner shards.

    The edge list crosses to ``device`` once; both orientations are
    sorted there by destination (``kernels.inputs.directed_routing``,
    slice by slice), which gives every accumulate, all-gather and replica
    group dst-sorted at once; one more stable sort by (shard, source
    block) gives the ring groups, still dst-sorted within each. The
    triangle groups are the undirected edges stably sorted by ``u``.
    ``devices`` (default :func:`shard_devices`) places the groups.

    ``replica_ids`` (hot-vertex ids) reroutes the propagate edges whose
    source is replicated out of the ring and all-gather groups into
    replica groups served from the replica panel, as the JAX package's
    plan does; accumulate and triangle groups do not depend on it.
    """
    dev = torch.device(device)
    n_pad, v_loc = vertex_partition(n, num_shards, pad_multiple)
    devices = devices or shard_devices(dev, num_shards)
    S = num_shards
    src, dst = directed_routing(edges, dev)
    owner = torch.div(dst, v_loc, rounding_mode="floor")
    dst_local = dst - owner * v_loc
    bounds = _bounds(dst, v_loc, S)
    acc_dst = _split(dst_local, bounds, devices)
    acc_key = [k.view(torch.uint32) for k in _split(src, bounds, devices)]

    rep_ids = rep_gids = rep_dst = rep_slot = None
    p_src, p_dst, p_dst_local, p_bounds = src, dst, dst_local, bounds
    if replica_ids is not None and len(replica_ids):
        rep_ids = np.unique(np.asarray(replica_ids, np.int64).ravel())
        rep_t = torch.from_numpy(rep_ids).to(dev)
        hit = torch.isin(src.to(torch.int64), rep_t)
        r_dst = dst[hit]
        slot = torch.searchsorted(rep_t, src[hit].to(torch.int64))
        rb = _bounds(r_dst, v_loc, S)
        rep_dst = _split(dst_local[hit], rb, devices)
        rep_slot = _split(slot.to(torch.int32), rb, devices)
        rep_gids = rep_t
        keep = ~hit
        p_src, p_dst, p_dst_local = src[keep], dst[keep], dst_local[keep]
        p_bounds = _bounds(p_dst, v_loc, S)
    flat_src = _split(p_src, p_bounds, devices)
    flat_dst = _split(p_dst_local, p_bounds, devices)

    blk = torch.div(p_src, v_loc, rounding_mode="floor")
    key = torch.div(p_dst, v_loc, rounding_mode="floor") * S + blk
    key, order = torch.sort(key, stable=True)
    r_src = (p_src - blk * v_loc)[order]
    r_dst = p_dst_local[order]
    off = [0] + torch.bincount(key, minlength=S * S).cumsum(0).tolist()
    ring_src, ring_dst, ring_off = [], [], []
    for s in range(S):
        lo, hi = off[s * S], off[(s + 1) * S]
        ring_src.append(r_src[lo:hi].to(devices[s]))
        ring_dst.append(r_dst[lo:hi].to(devices[s]))
        ring_off.append([o - lo for o in off[s * S:(s + 1) * S + 1]])
    del key, order, r_src, r_dst, blk

    e = _to_device(np.ascontiguousarray(edges, dtype=np.int32), dev)
    u_sorted, t_order = torch.sort(e[:, 0], stable=True)
    tb = _bounds(u_sorted, v_loc, S)
    tri_u = _split(u_sorted, tb, devices)
    tri_v = _split(e[:, 1][t_order], tb, devices)
    tri_idx = _split(t_order, tb, devices)

    return DistPlan(
        n=n, n_pad=n_pad, v_loc=v_loc, num_shards=S, devices=devices,
        acc_dst=acc_dst, acc_key=acc_key, ring_src=ring_src,
        ring_dst=ring_dst, ring_off=ring_off, flat_src=flat_src,
        flat_dst=flat_dst, tri_u=tri_u, tri_v=tri_v, tri_idx=tri_idx,
        rep_ids=rep_ids, rep_gids=rep_gids, rep_dst=rep_dst,
        rep_slot=rep_slot)


# ----------------------------------------------------------- accumulation
def accumulate_block(parts: list[torch.Tensor], rows: torch.Tensor,
                     keys: torch.Tensor, v_loc: int, accumulate) -> None:
    """Route one directed block (``rows`` int32, ``keys`` uint32, on the
    first shard's device) to the owner shards of ``rows`` and insert it
    into ``parts`` in place: one ``accumulate(part, rows_local, keys)``
    launch per shard that owns any of the rows."""
    if len(parts) == 1:
        accumulate(parts[0], rows, keys)
        return
    owner = torch.div(rows, v_loc, rounding_mode="floor")
    owner, order = torch.sort(owner, stable=True)
    cuts = torch.arange(len(parts) + 1, device=rows.device,
                        dtype=owner.dtype)
    bounds = torch.searchsorted(owner, cuts).tolist()
    # CUDA has no uint32 gather: reorder the keys' bits as int32
    rows = rows[order]
    keys = keys.view(torch.int32)[order].view(torch.uint32)
    for s, part in enumerate(parts):
        lo, hi = bounds[s], bounds[s + 1]
        if lo == hi:
            continue
        accumulate(part, (rows[lo:hi] - s * v_loc).to(part.device),
                   keys[lo:hi].to(part.device))


def dist_accumulate(plan: DistPlan, cfg, layout: str = "byte",
                    impl: str = "cuda") -> list[torch.Tensor]:
    """Algorithm 1, sharded, from the plan's accumulate groups: one insert
    launch per shard into a fresh ``uint8[v_loc, w]`` panel on its
    device."""
    from repro_torch.kernels import registry
    fam = registry.family(registry.resolve(cfg, layout, impl).family)
    parts = []
    for s in range(plan.num_shards):
        part = fam.empty_table(plan.v_loc, cfg, layout=layout,
                               device=plan.devices[s])
        if plan.acc_dst[s].numel():
            ops.accumulate(part, plan.acc_dst[s], plan.acc_key[s], cfg,
                           layout=layout, impl=impl)
        parts.append(part)
    return parts


# ------------------------------------------------------------- propagate
def _merge(out, src_panel, src, dst, layout, impl) -> None:
    """One group's merge ``out[dst] max= src_panel[src]`` (dst-sorted by
    the plan's construction; an empty group launches nothing)."""
    ops.propagate_into(out, src_panel, src, dst, layout=layout, impl=impl)


def _rep_prepass(plan: DistPlan, parts, out, layout, impl) -> None:
    """Merge the replicated source rows into every shard: the replica rows
    are gathered fresh from D^{t-1} and copied to each shard (the
    replicated panel), then each shard merges its replica group."""
    if not plan.has_replicas:
        return
    rows = gather_rows(parts, plan.v_loc, plan.rep_gids, plan.devices[0])
    for s in range(plan.num_shards):
        rep = _copy_to(rows, plan.devices[s])
        _count("replica", rep.numel())
        _merge(out[s], rep, plan.rep_slot[s], plan.rep_dst[s], layout, impl)


def dist_propagate_allgather(plan: DistPlan, parts: list[torch.Tensor],
                             layout: str = "byte", impl: str = "cuda",
                             ) -> list[torch.Tensor]:
    """One Algorithm 2 pass, paper-faithful all-gather dataflow.

    Each shard's output starts as a copy of its block (D^t <- D^{t-1});
    after the replica pre-pass (replica-aware plans), each shard
    concatenates every block onto its device (the all-gather: a new
    ``uint8[n_pad, w]`` panel) and merges its group from it with one
    two-panel launch. Peak: one gathered panel beside the two sharded
    ones. Returns the new per-shard panels.
    """
    out = [p.clone() for p in parts]
    _rep_prepass(plan, parts, out, layout, impl)
    for s in range(plan.num_shards):
        full = torch.cat([p.to(plan.devices[s]) for p in parts])
        _count("all_gather", full.numel())
        _merge(out[s], full, plan.flat_src[s], plan.flat_dst[s], layout,
               impl)
        del full
    return out


def _ppermute(held: list[torch.Tensor], devices: list) -> list:
    """Shift every in-flight block to the next shard: the block of shard
    i is copied to a new allocation on shard i + 1 (mod S)."""
    S = len(held)
    nxt = [None] * S
    for i in range(S):
        nxt[(i + 1) % S] = _copy_to(held[i], devices[(i + 1) % S])
        _count("ppermute", held[i].numel())
    return nxt


def _ring_plain(plan, parts, out, layout, impl) -> None:
    S = plan.num_shards
    held = list(parts)  # step 0: each shard holds its own block
    for step in range(S):
        for i in range(S):
            src, dst = plan.ring_group(i, (i - step) % S)
            _merge(out[i], held[i], src, dst, layout, impl)
        if step + 1 < S:
            held = _ppermute(held, plan.devices)


def _ring_overlap(plan, parts, out, layout, impl) -> None:
    """The ring with step s+1's copies issued on a side stream of each
    card before step s's launches, ordered by events: the copy of the next
    block overlaps the merge of the current one. Two receive buffers per
    shard (three panels in flight, as the JAX package's double-buffered
    ring)."""
    S = plan.num_shards
    devs = plan.devices
    cards = list(dict.fromkeys(devs))
    main = {d: torch.cuda.current_stream(d) for d in cards}
    side = {d: torch.cuda.Stream(d) for d in cards}
    recv = [[torch.empty_like(parts[i]) for i in range(S)] for _ in range(2)]
    held = list(parts)
    for step in range(S):
        if step + 1 < S:
            # the buffers this copy writes were read by step - 1's merges
            for d in cards:
                side[d].wait_stream(main[d])
            nxt = [None] * S
            for i in range(S):
                j = (i + 1) % S
                with torch.cuda.stream(side[devs[i]]), \
                        torch.cuda.stream(side[devs[j]]):
                    recv[(step + 1) % 2][j].copy_(held[i], non_blocking=True)
                nxt[j] = recv[(step + 1) % 2][j]
                _count("ppermute", held[i].numel())
        for i in range(S):
            src, dst = plan.ring_group(i, (i - step) % S)
            _merge(out[i], held[i], src, dst, layout, impl)
        if step + 1 < S:
            for d in cards:  # the next merges read what the side copied
                main[d].wait_stream(side[d])
            held = nxt


def dist_propagate_ring(plan: DistPlan, parts: list[torch.Tensor],
                        layout: str = "byte", impl: str = "cuda",
                        overlap: bool = False) -> list[torch.Tensor]:
    """One Algorithm 2 pass; the ring schedule.

    Step s: shard i holds block ``(i - s) mod S`` and merges the edges
    whose source lies in it (one two-panel launch), then every block moves
    on to the next shard (a ppermute: S copies of ``v_loc x w`` bytes);
    S steps, S - 1 shifts. Peak: two sharded panels and the in-flight
    blocks. ``overlap=True`` (engine ``schedule="ring_overlap"``) issues
    the copies of step s+1 on a side CUDA stream before step s's
    launches (:func:`_ring_overlap`); on the CPU it is the plain ring.
    Both forms merge the same groups into the same outputs, so they agree
    bit for bit with each other and with the all-gather (register max is
    commutative and idempotent). Replica-aware plans merge the replica
    panel first.
    """
    out = [p.clone() for p in parts]
    _rep_prepass(plan, parts, out, layout, impl)
    if overlap and parts[0].is_cuda and plan.num_shards > 1:
        _ring_overlap(plan, parts, out, layout, impl)
    else:
        _ring_plain(plan, parts, out, layout, impl)
    return out


# ------------------------------------------------------------- triangles
def _shard_edge_estimates(plan: DistPlan, cfg, parts, s: int, iters: int,
                          layout: str, impl: str) -> torch.Tensor:
    """T̃(uv) of shard ``s``'s triangle group (float32 on its device): u's
    rows are local, v's gathered from their owners, in blocks of
    ``EDGE_BLOCK`` edges."""
    dev = plan.devices[s]
    u, v = plan.tri_u[s], plan.tri_v[s]
    est = torch.empty(u.shape[0], dtype=torch.float32, device=dev)
    for lo in range(0, u.shape[0], EDGE_BLOCK):
        hi = min(lo + EDGE_BLOCK, u.shape[0])
        a = parts[s][(u[lo:hi] - s * plan.v_loc).to(torch.int64)]
        b = gather_rows(parts, plan.v_loc, v[lo:hi].to(torch.int64), dev)
        est[lo:hi] = intersection.mle_intersection(a, b, cfg, iters, layout,
                                                   impl)
    return est


def shard_triangle_estimates(plan: DistPlan, cfg, parts: list[torch.Tensor],
                             iters: int = 30, layout: str = "byte",
                             impl: str = "cuda") -> list[torch.Tensor]:
    """T̃(uv) of every shard's triangle group (Algorithm 3), float32 on
    the shard's device, in the group's order."""
    return [_shard_edge_estimates(plan, cfg, parts, s, iters, layout, impl)
            for s in range(plan.num_shards)]


def dist_edge_triangle_estimates(plan: DistPlan, cfg,
                                 parts: list[torch.Tensor], iters: int = 30,
                                 layout: str = "byte", impl: str = "cuda",
                                 ests: list | None = None) -> np.ndarray:
    """T̃(xy) for every edge, float64[m] in the edge list's order (the
    plan's ``tri_idx`` puts each shard's estimates back); ``ests`` reuses
    :func:`shard_triangle_estimates`' output."""
    if ests is None:
        ests = shard_triangle_estimates(plan, cfg, parts, iters, layout, impl)
    m = sum(int(t.shape[0]) for t in plan.tri_idx)
    out = np.zeros(m, dtype=np.float64)
    for s, est in enumerate(ests):
        out[plan.tri_idx[s].cpu().numpy()] = est.cpu().numpy()
    return out


def dist_triangle_heavy_hitters(plan: DistPlan, cfg,
                                parts: list[torch.Tensor], k: int,
                                iters: int = 30, mode: str = "edge",
                                layout: str = "byte", impl: str = "cuda",
                                ) -> tuple[float, np.ndarray, np.ndarray]:
    """Algorithms 3-5, sharded: :func:`shard_triangle_estimates`, then
    :func:`triangle_top`."""
    if mode not in ("edge", "vertex"):
        raise ValueError(f"mode must be 'edge' or 'vertex', got {mode!r}")
    ests = shard_triangle_estimates(plan, cfg, parts, iters, layout, impl)
    return triangle_top(plan, ests, k, mode)


def triangle_top(plan: DistPlan, ests: list[torch.Tensor], k: int,
                 mode: str = "edge") -> tuple[float, np.ndarray, np.ndarray]:
    """Algorithms 4/5 from the shards' triangle-group estimates ``ests``:
    ``mode="edge"`` (Algorithm 4) or ``"vertex"`` (Algorithm 5).

    Returns (T̃ global, top-k values float64, top-k ids int64): edge pairs
    ``[kk, 2]`` or vertex ids ``[kk]``. T̃ sums the shards' float64 sums
    over 3. Edge mode takes the
    top-k through :func:`~repro_torch.distributed.topk.distributed_topk`;
    vertex mode scatter-adds every estimate to both endpoints on each
    shard (a float64 ``[n_pad]`` accumulator), reduce-scatters the
    accumulators to the owner shards, halves them, and takes the top-k
    with padding rows (ids >= n) scored ``-inf``. Non-finite candidates
    score ``-inf`` and every non-finite value is trimmed after the global
    top-k, so the arrays hold at most ``min(k, #candidates)`` real entries.
    """
    if mode not in ("edge", "vertex"):
        raise ValueError(f"mode must be 'edge' or 'vertex', got {mode!r}")
    S, v_loc = plan.num_shards, plan.v_loc
    total = sum(float(e.to(torch.float64).sum()) for e in ests) / 3.0
    ninf = torch.tensor(float("-inf"))
    if mode == "edge":
        vals = [torch.where(torch.isfinite(e), e.to(torch.float64),
                            ninf.to(e.device)) for e in ests]
        ids = [torch.stack([plan.tri_u[s], plan.tri_v[s]], 1)
               for s in range(S)]
    else:
        accs = []
        for s in range(S):
            dev = plan.devices[s]
            acc = torch.zeros(plan.n_pad, dtype=torch.float64, device=dev)
            e64 = ests[s].to(torch.float64)
            acc.index_add_(0, plan.tri_u[s].to(torch.int64), e64)
            acc.index_add_(0, plan.tri_v[s].to(torch.int64), e64)
            accs.append(acc)
        vals, ids = [], []
        for j in range(S):  # reduce-scatter onto the owners
            dev = plan.devices[j]
            part = sum(a[j * v_loc:(j + 1) * v_loc].to(dev)
                       for a in accs) / 2.0
            vid = torch.arange(j * v_loc, (j + 1) * v_loc, device=dev)
            ok = (vid < plan.n) & torch.isfinite(part)
            vals.append(torch.where(ok, part, ninf.to(dev)))
            ids.append(vid)
    gv, gi = distributed_topk(vals, ids, k)
    gv = gv.cpu().numpy()
    keep = np.isfinite(gv)
    return total, gv[keep], gi.cpu().numpy().astype(np.int64)[keep]
