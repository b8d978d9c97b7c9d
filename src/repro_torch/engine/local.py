"""LocalEngine: the single-device backend (port of ``repro.engine.local``).

The register panel lives on one device, the card unless the caller asks
for the CPU. Ingest copies each undirected edge chunk to the device once,
builds both orientations there and folds them into the panel in place
with one accumulate launch; a neighborhood pass runs the propagate kernel
over the whole directed edge routing, which is built on the device once
per engine version, sorted by destination (the order the card's kernel
pulls in), and kept there. Triangle heavy hitters run the family's
per-edge MLE over the ingested edge list.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.base import SketchEngine, pad_vertices, resolve_device
from repro_torch.kernels import packing, registry
from repro_torch.kernels.hll_propagate import sort_routing

__all__ = ["LocalEngine", "directed_block", "directed_routing"]


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array ``a`` on ``device``, copied first when it is read-only
    (a tensor may not alias read-only memory)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _orientations(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the edge list ``e`` int32[k, 2]: (the first
    column then the second, the second column then the first)."""
    return torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]])


def directed_block(chunk: np.ndarray, device: torch.device,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the undirected ``chunk`` int32[k, 2] as
    accumulate inputs on ``device``: rows int32[2k] (the first column,
    then the second) and keys uint32[2k] (the other endpoint,
    reinterpreted). The chunk crosses to the device once."""
    rows, keys = _orientations(_to_device(chunk, device))
    return rows, keys.view(torch.uint32)


#: directed edges per slice of the routing build: the sort's temporaries
#: are those of one slice, not of the whole routing
ROUTING_SLICE = 1 << 23


def directed_routing(edges: np.ndarray, device: torch.device,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the undirected ``edges`` int32[m, 2] as a
    propagate routing ``(src, dst)`` int32[2m] on ``device``, stably
    sorted by ``dst``: equal to ``sort_routing`` of ``(first column then
    second, second then first)``. The edge list crosses to the device
    once. The routing is built there in slices of consecutive
    destinations, each about ``ROUTING_SLICE`` directed edges (a vertex's
    in-edges never split), so the device holds the edge list, the result
    and one slice's temporaries at a time."""
    e = _to_device(edges, device)
    n_dir = 2 * e.shape[0]
    src = torch.empty(n_dir, dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    if n_dir == 0:
        return src, dst
    # cum[v]: directed edges whose dst is <= v (in-degree = degree)
    cum = torch.bincount(e.reshape(-1)).cumsum(0)
    n_slices = -(-n_dir // ROUTING_SLICE)
    cuts = torch.searchsorted(
        cum, torch.arange(1, n_slices, device=device) * ROUTING_SLICE)
    bounds = [0, *(cuts + 1).tolist(), cum.numel()]
    at = 0
    for lo, hi in zip(bounds, bounds[1:]):
        if lo >= hi:
            continue
        part = e[((e >= lo) & (e < hi)).any(1)]
        s, d = _orientations(part)
        keep = (d >= lo) & (d < hi)
        s, d = sort_routing(s[keep], d[keep])
        src[at:at + d.numel()] = s
        dst[at:at + d.numel()] = d
        at += d.numel()
    return src, dst


def _family_table(n_pad: int, cfg, layout: str,
                  device: torch.device) -> torch.Tensor:
    """The zeroed register table of ``cfg``'s family, once the registry
    has accepted ``(cfg, layout)``."""
    kernels = registry.resolve(cfg, layout=layout)
    return registry.family(kernels.family).empty_table(
        n_pad, cfg, layout=layout, device=device)


class LocalEngine(SketchEngine):
    """Single-device engine: register table uint8[n_pad, w] on one device."""

    backend = "local"

    # ------------------------------------------------------ construction
    @classmethod
    def open(cls, n: int, cfg, *, layout: str = "byte",
             device=None) -> "LocalEngine":
        """An empty engine over vertex universe [0, n), ready to ingest.

        Allocates the zeroed register table uint8[n_pad, w] (n padded to a
        multiple of 8; w = r bytes, or r/2 on the packed layout) on
        ``device``; ``None`` means the card, and raises when there is none.
        """
        dev = resolve_device(device)
        regs = _family_table(pad_vertices(n, 8), cfg, layout, dev)
        return cls(regs, n, cfg, np.zeros((0, 2), np.int32), layout=layout)

    @classmethod
    def build(cls, edges: np.ndarray, n: int, cfg, *, layout: str = "byte",
              device=None) -> "LocalEngine":
        """Algorithm 1 in one call: ``open(n, cfg)`` + ``ingest(edges)``."""
        return cls.open(n, cfg, layout=layout, device=device).ingest(edges)

    @classmethod
    def from_regs(cls, regs, n: int, cfg, *, edges: np.ndarray | None = None,
                  layout: str = "byte", device=None) -> "LocalEngine":
        """Wrap an existing register table uint8[>=n, w] as a query engine.

        ``regs`` may be a numpy array or a tensor; it is copied to
        ``device`` (``None`` means the card). The row width must be that
        of ``layout`` (``packing.row_width``; ``ValueError`` otherwise: a
        packed panel handed to a byte engine would be misread, not
        caught downstream). Rows are padded with empty sketches to a
        multiple of 8. Engines without ``edges`` answer
        degrees and intersections but not neighborhoods; given edges are
        validated against [0, n).
        """
        dev = resolve_device(device)
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
        full = _family_table(pad_vertices(max(n, table.shape[0]), 8), cfg,
                             layout, dev)
        full[: table.shape[0]] = table.to(dev)
        return cls(full, n, cfg, edges, layout=layout)

    # ------------------------------------------------------ backend hooks
    def _accumulate_block(self, chunk: np.ndarray) -> None:
        """Insert both orientations of an edge chunk (scatter-max): the
        directed rows and keys are built on the device
        (:func:`directed_block`) and folded into the panel in place by one
        launch, every edge live: no padding, no mask. ``ingest`` has
        released the snapshot lease before the first chunk."""
        rows, keys = directed_block(chunk, self.device)
        self.kernels.accumulate(self._regs, rows, keys, self.cfg)

    def _propagate(self, regs: torch.Tensor) -> torch.Tensor:
        if self._prop_routing is None:
            self._prop_routing = directed_routing(
                self._require_edges("neighborhood"), self.device)
        src, dst = self._prop_routing
        return self.kernels.propagate(regs, src, dst)

    def triangle_heavy_hitters(self, k, *, mode="edge", iters=30):
        """Algorithms 4/5 on one device (see the base class).

        ``mode="edge"`` returns the top-k edges by T̃(xy), ``"vertex"``
        the top-k vertices by T̃(x); routed through the sketch family
        (``family.triangle_local``). An engine built without edges raises
        ``ValueError``.
        """
        self._require_kind("triangle")
        edges = self._require_edges("triangle_heavy_hitters")
        return self.family.triangle_local(self._regs, self.n, self.cfg,
                                          edges, k, mode, iters, self.layout)
