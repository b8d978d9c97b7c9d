"""DegreeSketch (paper §3): a queryable sketch table, Algorithm 1
(accumulation), Algorithm 2 (neighborhood approximation) and the triangle
heavy-hitter queries, Algorithms 4/5 (port of ``repro.core.degreesketch``).

Layout: ``regs: uint8[n_pad, w]``, one HLL row per vertex, on the card
or the CPU, ``w = r`` bytes (byte layout) or ``r/2`` (packed 4-bit
layout). Every per-edge estimate T̃(xy) is the joint MLE over the rows
of x and y (``intersection.mle_intersection``): the ``ertl_stats`` kernel
builds the Eq. 19 histograms and the estimate kernel the initializer's
|A|, |B| and |A ∪ B|. Edges go through in blocks of ``EDGE_BLOCK``; each
edge's estimate is independent of its block, so the block only bounds
device memory. A packed panel stays packed: each block gathers packed
rows and the packed kernels read them, where the JAX package unpacks the
whole panel first; the histograms and the exact packed ``(s, z)`` give
the same estimates.

These are the functional reference semantics; the persistent, batched
query surface is ``repro_torch.engine``, whose ingest and
``neighborhood`` give the same registers and estimates bit for bit:
:func:`accumulate` launches ``hll_accumulate`` once per block of
directed edges, and :func:`neighborhood_estimates` builds the engine's
dst-sorted routing (``kernels.inputs.directed_routing``) once and runs
every pass over it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hll, intersection
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import ops
from repro_torch.kernels.inputs import (directed_block, directed_routing,
                                        pad_vertices, resolve_device)

__all__ = ["DegreeSketch", "accumulate", "neighborhood_pass",
           "neighborhood_estimates", "edge_triangle_estimates",
           "triangle_heavy_hitters", "vertex_triangle_estimates",
           "vertex_heavy_hitters", "pad_vertices", "EDGE_BLOCK"]

#: edges per MLE block: at p=8 a block's Eq. 19 histograms take 304 MB and
#: the Newton step's float32[block, q+2] temporaries about 61 MB each
EDGE_BLOCK = 1 << 18


@dataclass(frozen=True)
class DegreeSketch:
    """A queryable accumulated sketch table (the paper's leave-behind D).

    Attributes:
      regs: uint8[n_pad, w] register table.
      n: true vertex count (rows >= n are padding).
      cfg: the sketch config.
      layout: register layout of ``regs``, "byte" or "packed".
      impl: kernel implementation of the queries, "cuda" (the kernels on
        a CUDA panel) or "ref" (their plain versions).
    """

    regs: torch.Tensor
    n: int
    cfg: HLLConfig
    layout: str = "byte"
    impl: str = "cuda"

    def degrees(self) -> torch.Tensor:
        """d̃(x) for all x < n, float32[n]."""
        return ops.estimate(self.regs, self.cfg, layout=self.layout,
                            impl=self.impl)[: self.n]

    def union_size(self, xs) -> torch.Tensor:
        """|∪_{x in xs} N(x)| for one vertex set, a float32 scalar."""
        ids = torch.as_tensor(np.asarray(xs, dtype=np.int32).reshape(1, -1),
                              device=self.regs.device)
        mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        return ops.union_estimate(self.regs, ids, mask, self.cfg,
                                  layout=self.layout, impl=self.impl)[0]

    def intersection_size(self, x: int, y: int) -> torch.Tensor:
        """|N(x) ∩ N(y)| via the Ertl MLE, the T̃(xy) primitive."""
        return intersection.mle_intersection(
            self.regs[x][None], self.regs[y][None], self.cfg,
            layout=self.layout, impl=self.impl)[0]


def accumulate(edges: np.ndarray, n: int, cfg: HLLConfig,
               n_pad: int | None = None, block: int = 1 << 15,
               device=None) -> DegreeSketch:
    """Algorithm 1: one pass over the edge stream, both orientations.

    The table ``uint8[n_pad, r]`` is made on ``device`` (``None``: the
    card, which must be present). The edge list crosses to the device
    once; its directed edges, every ``(u, v)`` then every ``(v, u)`` as in
    the JAX package, go through ``hll_accumulate`` one launch per
    ``block``. Register max is commutative and idempotent, so the
    registers are byte-identical for any ``block``.
    """
    dev = resolve_device(device)
    regs = hll.empty_table(n_pad or pad_vertices(n, 8), cfg, device=dev)
    rows, keys = directed_block(_edge_array(edges, regs.shape[0]), dev)
    for s in range(0, rows.shape[0], block):
        ops.accumulate(regs, rows[s:s + block], keys[s:s + block], cfg)
    return DegreeSketch(regs=regs, n=n, cfg=cfg)


def _edge_array(edges, rows: int) -> np.ndarray:
    """An undirected edge list as contiguous int32[m, 2], its ids checked
    against the ``rows`` sketch rows (``ValueError``) before any reaches a
    kernel."""
    e = np.asarray(edges).reshape(-1, 2)
    if len(e) and (int(e.min()) < 0 or int(e.max()) >= rows):
        raise ValueError(f"edge ids [{int(e.min())}, {int(e.max())}] lie "
                         f"outside the {rows} sketch rows")
    return np.ascontiguousarray(e, dtype=np.int32)


def _routing(src, dst, regs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """A directed routing (tensors or arrays) as int32 tensors on the
    panel's device, its ids checked against the panel's rows."""
    src, dst = (hll._as_rows(a, regs.device) for a in (src, dst))
    if src.shape != dst.shape:
        raise ValueError(f"src and dst differ in length: {src.shape[0]} "
                         f"and {dst.shape[0]}")
    if src.numel() and (min(int(src.min()), int(dst.min())) < 0 or max(
            int(src.max()), int(dst.max())) >= regs.shape[-2]):
        raise ValueError(f"routing ids lie outside the panel's "
                         f"{regs.shape[-2]} rows")
    return src, dst


def neighborhood_pass(regs: torch.Tensor, src, dst) -> torch.Tensor:
    """One pass of Algorithm 2:
    D^t[x] = D^{t-1}[x] ∪̃ (∪̃_{y:xy∈E} D^{t-1}[y]).

    A new panel (``ops.propagate``; ``regs`` is unchanged). ``src``/``dst``
    are the directed routing in any order, tensors or arrays; on the card
    an unsorted routing is sorted first, once per call.
    """
    return ops.propagate(regs, *_routing(src, dst, regs))


def neighborhood_estimates(edges: np.ndarray, n: int, cfg: HLLConfig,
                           t_max: int, sketch: DegreeSketch | None = None,
                           device=None,
                           ) -> tuple[np.ndarray, np.ndarray, DegreeSketch]:
    """Algorithm 2 over ``t_max`` hops: (Ñ(x,t) float64[t_max, n],
    Ñ(t) float64[t_max], D^{t_max}).

    Pass t=1 reads the accumulated sketch (``sketch``, or
    :func:`accumulate` on ``device``); passes 2..t_max merge neighbor
    sketches over one dst-sorted routing, built on the panel's device
    once per call (``kernels.inputs.directed_routing``), the engine's.
    Every pass and estimate keeps the sketch's layout and impl, and so
    does the returned sketch. Each Ñ(t) sums that hop's float32 estimates as the engine's
    ``neighborhood`` does, so both agree bit for bit.
    """
    ds = sketch or accumulate(edges, n, cfg, device=device)
    regs, kw = ds.regs, {"layout": ds.layout, "impl": ds.impl}
    src, dst = directed_routing(_edge_array(edges, regs.shape[0]),
                                regs.device)
    local = np.zeros((t_max, n), dtype=np.float64)
    glob = np.zeros((t_max,), dtype=np.float64)
    for t in range(1, t_max + 1):
        if t > 1:
            regs = ops.propagate(regs, src, dst, **kw)
        est = ops.estimate(regs, cfg, **kw).cpu().numpy()[:n]
        local[t - 1] = est
        glob[t - 1] = est.sum()  # REDUCE (line 19)
    return local, glob, DegreeSketch(regs=regs, n=n, cfg=cfg, **kw)


def edge_triangle_estimates(sketch: DegreeSketch, edges: np.ndarray,
                            block: int = EDGE_BLOCK,
                            iters: int = 30) -> np.ndarray:
    """T̃(xy) = |D[x] ∩̃ D[y]| for every edge (Eq. 10), float64[m].

    The edge list goes to the device once; each block gathers its rows
    there and runs the MLE.
    """
    out = np.zeros(len(edges), dtype=np.float64)
    dev = sketch.regs.device
    ends = torch.from_numpy(np.asarray(edges, dtype=np.int64)).to(dev)
    for s in range(0, len(edges), block):
        chunk = ends[s:s + block]
        est = intersection.mle_intersection(sketch.regs[chunk[:, 0]],
                                            sketch.regs[chunk[:, 1]],
                                            sketch.cfg, iters, sketch.layout,
                                            sketch.impl)
        out[s:s + len(chunk)] = est.cpu().numpy()
    return out


def triangle_heavy_hitters(sketch: DegreeSketch, edges: np.ndarray, k: int,
                           block: int = EDGE_BLOCK, iters: int = 30,
                           ) -> tuple[float, np.ndarray, np.ndarray]:
    """Algorithm 4: (T̃ global, top-k values, top-k edges).

    T̃ = (1/3) Σ T̃(xy) (Eq. 11). Returns at most ``min(k, len(edges))``
    entries, all real edges; top-k is ``np.argsort(-est)[:k]`` over the
    float64 estimates, as in the JAX package.
    """
    est = edge_triangle_estimates(sketch, edges, block=block, iters=iters)
    total = float(est.sum()) / 3.0
    idx = np.argsort(-est)[: min(k, len(est))]
    return total, est[idx], edges[idx]


def vertex_triangle_estimates(sketch: DegreeSketch, edges: np.ndarray,
                              block: int = EDGE_BLOCK,
                              iters: int = 30) -> np.ndarray:
    """Algorithm 5 local counts: T̃(x) = 1/2 Σ_{xy∈E} T̃(xy) (Eq. 12)."""
    return _vertex_counts(sketch.n, edges, edge_triangle_estimates(
        sketch, edges, block=block, iters=iters))


def vertex_heavy_hitters(sketch: DegreeSketch, edges: np.ndarray, k: int,
                         block: int = EDGE_BLOCK, iters: int = 30,
                         ) -> tuple[float, np.ndarray, np.ndarray]:
    """Algorithm 5: (T̃ global, top-k values, top-k vertices).

    Returns at most ``min(k, n)`` entries with vertex ids < n: the
    accumulator covers only the true vertex rows.
    """
    edge_est = edge_triangle_estimates(sketch, edges, block=block,
                                       iters=iters)
    total = float(edge_est.sum()) / 3.0
    acc = _vertex_counts(sketch.n, edges, edge_est)
    idx = np.argsort(-acc)[: min(k, sketch.n)]
    return total, acc[idx], idx


def _vertex_counts(n: int, edges: np.ndarray,
                   edge_est: np.ndarray) -> np.ndarray:
    """Scatter-add each edge estimate to both endpoints, halved (the EST
    message of Algorithm 5)."""
    acc = np.zeros(n, dtype=np.float64)
    np.add.at(acc, edges[:, 0], edge_est)
    np.add.at(acc, edges[:, 1], edge_est)
    return acc / 2.0
