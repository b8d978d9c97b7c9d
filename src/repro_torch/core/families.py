"""The HLL sketch family: estimator math bound to the engine's needs.

Port of the HLL half of ``repro.core.families``: the engine reaches the
family-specific math (empty tables, the pair estimator tail, triangle
counting) and the query kinds the family serves through this object.
The ADS family is not ported yet (ROADMAP Queue A item 12);
``kernels.registry.resolve`` refuses it.
"""
from __future__ import annotations

import torch

from repro_torch.core import degreesketch as dsk
from repro_torch.core import hll as hll_mod
from repro_torch.core import intersection

__all__ = ["HLLFamily", "HLL"]


class HLLFamily:
    """HyperLogLog: the paper's cardinality-sketch instantiation.

    Attributes:
      name: registry coordinate.
      config_cls: the frozen config dataclass.
      query_kinds: the query kinds the engine may answer for this family.
      default_iters: Newton iterations of the intersection MLE by default.
    """

    name = "hll"
    config_cls = hll_mod.HLLConfig
    query_kinds = ("degrees", "union", "intersection", "mixed",
                   "neighborhood", "triangle")
    default_iters = intersection.NEWTON_ITERS

    def empty_table(self, n: int, cfg, layout: str = "byte",
                    device: torch.device | str = "cpu") -> torch.Tensor:
        """Zeroed uint8[n, r] register table on ``device``."""
        return hll_mod.empty_table(n, cfg, layout=layout, device=device)

    def estimate_from_pair_stats(self, stats, sz, cfg, method: str,
                                 iters: int) -> torch.Tensor:
        """Ertl T̃(xy) estimates from fused pair statistics (§4.1)."""
        return intersection.estimate_from_pair_stats(stats, sz, cfg, method,
                                                     iters=iters)

    def triangle_local(self, regs, n, cfg, edges, k, mode, iters):
        """Algorithms 4/5 over a single-device byte-layout register panel."""
        sketch = dsk.DegreeSketch(regs=regs, n=n, cfg=cfg)
        if mode == "edge":
            return dsk.triangle_heavy_hitters(sketch, edges, k, iters=iters)
        if mode == "vertex":
            return dsk.vertex_heavy_hitters(sketch, edges, k, iters=iters)
        raise ValueError(f"mode must be 'edge' or 'vertex', got {mode!r}")


#: the built-in family instance
HLL = HLLFamily()
