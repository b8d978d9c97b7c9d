"""LocalEngine: the single-device backend (port of ``repro.engine.local``).

The register panel lives on one device, the card unless the caller asks
for the CPU. Ingest pushes each directed edge block through the
accumulate kernel, updating the panel in place; a neighborhood pass runs
the propagate kernel over the whole directed edge routing, which is built
once per engine version and kept on the device. Triangle heavy hitters
run the family's per-edge MLE over the ingested edge list.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import plans
from repro_torch.engine.base import SketchEngine, pad_vertices, resolve_device
from repro_torch.graph import stream as gstream
from repro_torch.kernels import packing, registry

__all__ = ["LocalEngine"]


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
        """Insert both orientations of an edge block (scatter-max).

        Directed pairs are padded up to a power-of-two size with a
        validity mask and folded into the panel in place.
        """
        directed = np.concatenate([chunk, chunk[:, ::-1]], axis=0)
        cap = 2 * self.INGEST_BLOCK
        dev = self.device
        for s in range(0, len(directed), cap):
            sub = directed[s:s + cap]
            padded, mask = gstream.pad_block(sub, plans.bucket(len(sub)))
            rows = torch.from_numpy(np.ascontiguousarray(padded[:, 0]))
            keys = torch.from_numpy(padded[:, 1].astype(np.uint32))
            self.kernels.accumulate(self._regs, rows.to(dev), keys.to(dev),
                                    self.cfg, mask=torch.from_numpy(mask).to(dev))

    def _propagate(self, regs: torch.Tensor) -> torch.Tensor:
        if self._prop_routing is None:
            e = self._require_edges("neighborhood")
            routing = (np.concatenate([e[:, 0], e[:, 1]]),
                       np.concatenate([e[:, 1], e[:, 0]]))
            self._prop_routing = tuple(torch.from_numpy(x).to(self.device)
                                       for x in routing)
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
