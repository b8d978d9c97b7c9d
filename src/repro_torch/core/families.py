"""The sketch families, HLL and ADS: estimator math bound to the engine.

Port of ``repro.core.families``: the engine reaches the family-specific
math (empty tables, config (de)serialization, the pair estimator tail,
triangle counting, the HIP curve math) and the query kinds each family
serves through these objects, found by name in ``kernels.registry``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ads as ads_mod
from repro_torch.core import degreesketch as dsk
from repro_torch.core import hll as hll_mod
from repro_torch.core import intersection

__all__ = ["SketchFamily", "HLLFamily", "ADSFamily", "HLL", "ADS"]


class SketchFamily:
    """The family protocol the engine stack programs against (the JAX
    package's ``kernels.registry.SketchFamily``): what both families
    share, config (de)serialization for checkpoint manifests and the
    default config.

    Attributes every family defines:
      name: registry coordinate ("hll" | "ads").
      config_cls: the frozen config dataclass.
      ops: the ops an impl must register to serve the family.
      layouts: register-panel layouts the family's semantics tolerate.
      query_kinds: the query kinds the engine may answer for this family.
      default_iters: Newton iterations of the intersection MLE by default
        (``None`` for a family without one).
    """

    name = ""
    config_cls = None
    ops = ()
    layouts = ("byte",)
    query_kinds = ()
    default_iters = None

    def default_config(self):
        """A default-constructed config of this family."""
        return self.config_cls()

    def config_dict(self, cfg) -> dict:
        """JSON-ready config fields for checkpoint manifests."""
        return {"p": cfg.p, "seed": cfg.seed, "estimator": cfg.estimator}

    def config_from_dict(self, d: dict):
        """Rebuild a config from :meth:`config_dict` output."""
        return self.config_cls(**d)


class HLLFamily(SketchFamily):
    """HyperLogLog: the paper's cardinality-sketch instantiation.

    Both register layouts suit its semantics: the Flajolet/beta
    combinations and the Eq. 19 histograms read registers through
    ``min(reg, 15)``-safe statistics at the p the packed layout admits.
    """

    name = "hll"
    config_cls = hll_mod.HLLConfig
    ops = ("accumulate", "propagate", "estimate", "ertl_stats",
           "union_estimate", "intersection_stats")
    layouts = ("byte", "packed")
    query_kinds = ("degrees", "union", "intersection", "mixed",
                   "neighborhood", "triangle")
    default_iters = intersection.NEWTON_ITERS

    def empty_table(self, n: int, cfg, layout: str = "byte",
                    device: torch.device | str = "cpu") -> torch.Tensor:
        """Zeroed uint8[n, w] register table on ``device`` (w = r, or r/2
        packed)."""
        return hll_mod.empty_table(n, cfg, layout=layout, device=device)

    def estimate_from_pair_stats(self, stats, sz, cfg, method: str,
                                 iters: int, impl: str = "cuda"
                                 ) -> torch.Tensor:
        """Ertl T̃(xy) estimates from fused pair statistics (§4.1), the
        Newton steps by ``impl``."""
        return intersection.estimate_from_pair_stats(stats, sz, cfg, method,
                                                     iters=iters, impl=impl)

    def triangle_local(self, regs, n, cfg, edges, k, mode, iters,
                       layout="byte", impl="cuda"):
        """Algorithms 4/5 over a single-device register panel; a packed
        panel is read packed, block by block (``core.degreesketch``),
        through the kernels of ``impl``."""
        sketch = dsk.DegreeSketch(regs=regs, n=n, cfg=cfg, layout=layout,
                                  impl=impl)
        if mode == "edge":
            return dsk.triangle_heavy_hitters(sketch, edges, k, iters=iters)
        if mode == "vertex":
            return dsk.vertex_heavy_hitters(sketch, edges, k, iters=iters)
        raise ValueError(f"mode must be 'edge' or 'vertex', got {mode!r}")


class ADSFamily(SketchFamily):
    """All-Distances Sketches with batch-HIP estimators (``core.ads``).

    The register geometry and merge semantics of HLL, so ADS tables ride
    the same accumulate and propagate kernels and the engine's t-hop
    panel cache, but its queries read the hop sequence through HIP
    curves: distance histograms, closeness and effective diameter. Byte
    layout only: packed 4-bit lanes saturate at 15 and would cap the
    ``2**x`` inverse change probabilities.
    """

    name = "ads"
    config_cls = ads_mod.ADSConfig
    ops = ("accumulate", "propagate", "estimate", "hip_delta")
    layouts = ("byte",)
    query_kinds = ("degrees", "neighborhood", "distance_histogram",
                   "closeness", "effective_diameter")

    def empty_table(self, n: int, cfg, layout: str = "byte",
                    device: torch.device | str = "cpu") -> torch.Tensor:
        """Zeroed uint8[n, r] register table on ``device`` (byte only)."""
        if layout != "byte":
            raise ValueError(
                f"ADS register rows are byte-layout only, got {layout!r}")
        return torch.zeros((n, cfg.r), dtype=torch.uint8, device=device)

    def hip_histogram(self, curve: np.ndarray) -> np.ndarray:
        """Per-hop distance histogram h^t = C^t - C^{t-1} (``core.ads``)."""
        return ads_mod.distance_histogram(curve)

    def hip_closeness(self, curve: np.ndarray) -> np.ndarray:
        """Closeness centralities from the cumulative curve (``core.ads``)."""
        return ads_mod.closeness_from_curve(curve)

    def hip_effective_diameter(self, glob: np.ndarray, q: float) -> float:
        """Interpolated effective diameter at quantile ``q`` (``core.ads``)."""
        return ads_mod.effective_diameter_from_curve(glob, q)


#: the built-in family instances
HLL = HLLFamily()
ADS = ADSFamily()
