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

from repro_torch.engine.base import SketchEngine, pad_vertices
from repro_torch.kernels import packing, registry
from repro_torch.kernels.inputs import (directed_block, directed_routing,
                                        resolve_device)

__all__ = ["LocalEngine"]


def _family_table(n_pad: int, cfg, layout: str, impl: str,
                  device: torch.device) -> torch.Tensor:
    """The zeroed register table of ``cfg``'s family, once the registry
    has accepted ``(cfg, layout, impl)``."""
    kernels = registry.resolve(cfg, layout=layout, impl=impl)
    return registry.family(kernels.family).empty_table(
        n_pad, cfg, layout=layout, device=device)


class LocalEngine(SketchEngine):
    """Single-device engine: register table uint8[n_pad, w] on one device."""

    backend = "local"

    # ------------------------------------------------------ construction
    @classmethod
    def open(cls, n: int, cfg, *, layout: str = "byte", impl: str = "cuda",
             device=None) -> "LocalEngine":
        """An empty engine over vertex universe [0, n), ready to ingest.

        Allocates the zeroed register table uint8[n_pad, w] (n padded to a
        multiple of 8; w = r bytes, or r/2 on the packed layout) on
        ``device``; ``None`` means the card, and raises when there is none.
        ``impl`` is the kernel implementation ("cuda" or "ref").
        """
        dev = resolve_device(device)
        regs = _family_table(pad_vertices(n, 8), cfg, layout, impl, dev)
        return cls(regs, n, cfg, np.zeros((0, 2), np.int32), layout=layout,
                   impl=impl)

    @classmethod
    def build(cls, edges: np.ndarray, n: int, cfg, *, layout: str = "byte",
              impl: str = "cuda", device=None) -> "LocalEngine":
        """Algorithm 1 in one call: ``open(n, cfg)`` + ``ingest(edges)``."""
        return cls.open(n, cfg, layout=layout, impl=impl,
                        device=device).ingest(edges)

    @classmethod
    def from_regs(cls, regs, n: int, cfg, *, edges: np.ndarray | None = None,
                  layout: str = "byte", impl: str = "cuda",
                  device=None) -> "LocalEngine":
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
                             layout, impl, dev)
        full[: table.shape[0]] = table.to(dev)
        return cls(full, n, cfg, edges, layout=layout, impl=impl)

    # ------------------------------------------------------ backend hooks
    def _accumulate_block(self, chunk: np.ndarray) -> None:
        """Insert both orientations of an edge chunk (scatter-max): the
        directed rows and keys are built on the device
        (:func:`directed_block`) and folded into the panel in place by one
        launch, every edge live: no padding, no mask. ``ingest`` has
        released the snapshot lease before the first chunk."""
        rows, keys = directed_block(chunk, self.device)
        self.kernels.accumulate(self._regs, rows, keys, self.cfg)

    def _propagate(self, regs: torch.Tensor, schedule: str) -> torch.Tensor:
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
                                          edges, k, mode, iters, self.layout,
                                          self.impl)
