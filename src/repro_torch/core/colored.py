"""Colored DegreeSketch, the paper's §6 (Conclusions) future-work queries
(port of ``repro.core.colored``).

"A simple generalization ... allows us to estimate interesting queries of
the form 'how many of x's t-neighbors are both red and green?' or 'how many
of x's t-neighbors are not blue?'"

One register plane per color class, the planes one ``uint8[C, n_pad, r]``
tensor: Algorithm 1 inserts neighbor y only into the plane of y's color,
and Algorithm 2 propagates each plane independently (a color-c sketch of
x always summarizes {y : d(x,y) <= t, color(y) = c}). Byte layout only,
as in the JAX package.

On the device the planes are one flat ``[C * n_pad, r]`` panel: the
accumulate kernel inserts key y into row ``color[y] * n_pad + x``, one
launch per ingest chunk whatever C (the hash stays in the kernel), and a
pass runs one ``hll_propagate`` launch per plane over one dst-sorted
routing, so the routing is held once, not C times.

Queries on an accumulated ColoredDegreeSketch:
  count(x, c)            ~ |{y in N_t(x) : color(y) = c}|       (plane c)
  count_not(x, c)        ~ |union of all planes != c|            (closed ∪̃)
  count_union(x, cs)     ~ |N_t(x) restricted to colors in cs|
  count_and(x, c1, c2)   ~ |plane c1 ∩ plane c2| via Ertl MLE, for
                           *multi-label* colorings (a vertex may be both
                           red and green); identically 0 for partitions.

Space: |colors| * n * r bytes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hll, intersection
from repro_torch.core.degreesketch import _edge_array, _routing, pad_vertices
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import inputs, ops
from repro_torch.kernels.hll_propagate import dst_sorted, sort_routing
from repro_torch.kernels.inputs import (directed_block, directed_routing,
                                        resolve_device)

__all__ = ["ColoredDegreeSketch", "colored_accumulate", "colored_pass",
           "colored_neighborhood"]


@dataclass(frozen=True)
class ColoredDegreeSketch:
    """regs: uint8[num_colors, n_pad, r], one sketch plane per color."""

    regs: torch.Tensor
    n: int
    num_colors: int
    cfg: HLLConfig

    def count(self, x: int, color: int) -> float:
        """~|{y : y reachable, color(y) = color}| for the accumulated t."""
        return float(hll.estimate(self.regs[color, x], self.cfg))

    def count_union(self, x: int, colors) -> float:
        """~|{y : y reachable, color(y) in colors}| (register max of the
        planes' rows)."""
        rows = self.regs[list(colors), x]
        return float(hll.estimate(rows.amax(dim=0), self.cfg))

    def count_not(self, x: int, color: int) -> float:
        """~|{y : y reachable, color(y) != color}|."""
        others = [c for c in range(self.num_colors) if c != color]
        return self.count_union(x, others)

    def count_and(self, x: int, c1: int, c2: int) -> float:
        """Multi-label intersection query (Ertl MLE; heavy-hitter caveats
        of Appendix B apply)."""
        return float(intersection.mle_intersection(
            self.regs[c1, x][None], self.regs[c2, x][None], self.cfg)[0])


def colored_accumulate(edges: np.ndarray, colors: np.ndarray, n: int,
                       cfg: HLLConfig, num_colors: int | None = None,
                       device=None) -> ColoredDegreeSketch:
    """Algorithm 1 with color planes: INSERT(D[color(y)][x], y).

    ``colors`` is int[>= n], one color in [0, num_colors) per vertex
    (``num_colors`` defaults to ``colors.max() + 1``). The planes are
    made on ``device`` (``None``: the card, which must be present); the
    edges go through ``hll_accumulate`` one launch per
    ``kernels.inputs.INGEST_BLOCK`` undirected edges, both orientations
    built on the device as the engine's ingest builds them. Raises
    ``ValueError`` for colors outside [0, num_colors) and for
    ``num_colors * n_pad >= 2**31`` (the kernel's rows are int32).
    """
    colors = np.asarray(colors)
    num_colors = num_colors or int(colors.max()) + 1
    n_pad = pad_vertices(n, 8)
    if num_colors * n_pad >= 1 << 31:
        raise ValueError(
            f"{num_colors} colors x {n_pad} rows exceed the int32 rows of "
            f"the accumulate kernel")
    if len(colors) < n or (n and (colors[:n].min() < 0
                                  or colors[:n].max() >= num_colors)):
        raise ValueError(f"colors must give each of the {n} vertices a "
                         f"color in [0, {num_colors})")
    dev = resolve_device(device)
    regs = torch.zeros((num_colors, n_pad, cfg.r), dtype=torch.uint8,
                       device=dev)
    flat = regs.view(num_colors * n_pad, cfg.r)
    plane = torch.from_numpy(colors[:n].astype(np.int32)).to(dev) * n_pad
    edges = _edge_array(edges, n)
    block = inputs.INGEST_BLOCK
    for s in range(0, len(edges), block):
        x, y = directed_block(edges[s:s + block], dev)
        rows = plane[y.view(torch.int32).long()] + x
        ops.accumulate(flat, rows, y, cfg)
    return ColoredDegreeSketch(regs=regs, n=n, num_colors=num_colors,
                               cfg=cfg)


def colored_pass(regs: torch.Tensor, src, dst) -> torch.Tensor:
    """One Algorithm 2 pass applied to every color plane independently.

    A new ``uint8[C, n_pad, r]`` tensor; ``regs`` is unchanged. The
    routing (any order, tensors or arrays) is put on the planes' device
    and, on the card, sorted by ``dst`` once; then one ``hll_propagate``
    launch per plane.
    """
    src, dst = _routing(src, dst, regs)
    if regs.is_cuda and not dst_sorted(dst):
        src, dst = sort_routing(src, dst)
    out = torch.empty_like(regs)
    for c in range(regs.shape[0]):
        out[c] = ops.propagate(regs[c], src, dst)
    return out


def colored_neighborhood(sketch: ColoredDegreeSketch, edges: np.ndarray,
                         t_max: int) -> ColoredDegreeSketch:
    """Advance an accumulated colored sketch to D^{t_max}, every pass over
    one dst-sorted routing built on the planes' device
    (``kernels.inputs.directed_routing``)."""
    regs = sketch.regs
    if t_max > 1:
        src, dst = directed_routing(_edge_array(edges, sketch.n),
                                    regs.device)
        for _ in range(2, t_max + 1):
            regs = colored_pass(regs, src, dst)
    return ColoredDegreeSketch(regs=regs, n=sketch.n,
                               num_colors=sketch.num_colors, cfg=sketch.cfg)
