"""Public sketch query API: open / build a ``LocalEngine`` on the card.

    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig

    eng = engine.build(edges, n, HLLConfig(p=8))   # on the card
    deg = eng.degrees()
    loc, glob = eng.neighborhood(t_max=3)
    u = eng.union_size([ids_a, ids_b])              # batched |∪ N(x)|
    t = eng.intersection_size(edge_pairs)          # batched T̃(xy)
    out = eng.query_batch(degrees=True, vertex_sets=sets, pairs=edge_pairs)
    total, vals, top = eng.triangle_heavy_hitters(100, mode="edge")

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, which runs every kernel's plain PyTorch version); with
``device=None`` and no card they raise ``RuntimeError`` rather than
carry on on the CPU. Only the local backend, the HLL family and the byte
layout are ported so far (checkpoints, ``merge``, snapshots, serving,
ADS and the sharded backend are not; see ROADMAP.md); ``engine.convert``
carries a JAX engine's state across as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hll import HLLConfig
from repro_torch.engine.base import SketchEngine, resolve_device
from repro_torch.engine.local import LocalEngine

__all__ = ["SketchEngine", "LocalEngine", "open", "build", "default_device"]


def default_device() -> torch.device:
    """The device entry points use when the caller passes none: the card.

    Raises ``RuntimeError`` when ``torch.cuda.is_available()`` is False.
    """
    return resolve_device(None)


def open(n: int, cfg: HLLConfig | None = None, *, layout: str = "byte",
         device=None) -> LocalEngine:
    """An empty engine over vertex universe [0, n), ready to ingest.

    Args:
      n: vertex count; ingesting ids >= n raises ``ValueError``.
      cfg: sketch config (default ``HLLConfig()``).
      layout: register layout; only "byte" is ported.
      device: "cuda", "cpu" or a torch device; ``None`` means the card.
    """
    return LocalEngine.open(n, cfg or HLLConfig(), layout=layout,
                            device=device)


def build(edges: np.ndarray, n: int | None = None,
          cfg: HLLConfig | None = None, *, layout: str = "byte",
          device=None) -> LocalEngine:
    """Accumulate a sketch table (Algorithm 1) and return a query engine.

    ``open(n, cfg)`` plus one ``ingest(edges)``, so the registers are
    byte-identical to any block-streamed ingestion of the same edges.
    ``n`` defaults to ``edges.max() + 1``.
    """
    edges = np.asarray(edges)
    if n is None:
        n = int(edges.max()) + 1 if len(edges) else 1
    return open(n, cfg, layout=layout, device=device).ingest(edges)
