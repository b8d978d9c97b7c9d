"""DegreeSketch (paper §3): a queryable sketch table and the triangle
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

Not ported yet: ``accumulate``, ``neighborhood_pass`` and
``neighborhood_estimates`` (the engine's ingest and ``neighborhood``
serve Algorithms 1 and 2).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import intersection
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import ops

__all__ = ["DegreeSketch", "edge_triangle_estimates", "triangle_heavy_hitters",
           "vertex_triangle_estimates", "vertex_heavy_hitters", "EDGE_BLOCK"]

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
    """

    regs: torch.Tensor
    n: int
    cfg: HLLConfig
    layout: str = "byte"

    def degrees(self) -> torch.Tensor:
        """d̃(x) for all x < n, float32[n]."""
        return ops.estimate(self.regs, self.cfg, layout=self.layout)[: self.n]

    def union_size(self, xs) -> torch.Tensor:
        """|∪_{x in xs} N(x)| for one vertex set, a float32 scalar."""
        ids = torch.as_tensor(np.asarray(xs, dtype=np.int32).reshape(1, -1),
                              device=self.regs.device)
        mask = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        return ops.union_estimate(self.regs, ids, mask, self.cfg,
                                  layout=self.layout)[0]

    def intersection_size(self, x: int, y: int) -> torch.Tensor:
        """|N(x) ∩ N(y)| via the Ertl MLE, the T̃(xy) primitive."""
        return intersection.mle_intersection(
            self.regs[x][None], self.regs[y][None], self.cfg,
            layout=self.layout)[0]


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
                                            sketch.cfg, iters, sketch.layout)
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
