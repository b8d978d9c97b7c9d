"""Kernel set resolution: one capability-checked bundle per engine.

Port of the part of ``repro.kernels.registry`` that the ported queries
use. The JAX package registers ``(family, op, impl)`` entries and lets
engines pick ``ref`` or ``pallas``; the port has one implementation per
op, the CUDA kernel, whose wrapper takes the plain PyTorch version for
CPU tensors, so a :class:`KernelSet` is resolved from the config and the
layout alone. It carries seven ops: accumulate, propagate and estimate
for both families, union_estimate, intersection_stats and ertl_stats for
HLL, and hip_delta for ADS; each HLL op has a kernel for the byte and
for the packed 4-bit layout (``kernels.packing``). The family comes from
the config's type (``family_of``). An ADS engine on the packed layout
fails here, up front, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.families import ADS, HLL

__all__ = ["KernelSet", "resolve", "family", "family_of"]

_FAMILIES = {fam.name: fam for fam in (HLL, ADS)}


def family(name: str):
    """The family object registered under ``name`` ("hll" or "ads")."""
    fam = _FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown sketch family {name!r}; known families: "
                         f"{sorted(_FAMILIES)}")
    return fam


def family_of(cfg):
    """The family whose config class ``cfg`` is an instance of."""
    for fam in _FAMILIES.values():
        if type(cfg) is fam.config_cls:
            return fam
    raise TypeError(f"config {type(cfg).__name__} belongs to no ported "
                    f"sketch family (have: {sorted(_FAMILIES)})")


@dataclass(frozen=True)
class KernelSet:
    """The main-path kernels for one (layout, family).

    The estimate kernel's ``(s, z)`` serve every estimator, so the set
    does not depend on ``cfg.estimator``.

    Attributes:
      layout: register-panel layout ("byte" or "packed").
      family: sketch-family coordinate ("hll" or "ads").
    """

    layout: str = "byte"
    family: str = "hll"

    def accumulate(self, regs, rows, keys, cfg, mask=None):
        """Algorithm 1 INSERT over an edge block, in place."""
        from repro_torch.kernels import ops
        return ops.accumulate(regs, rows, keys, cfg, mask=mask,
                              layout=self.layout)

    def propagate(self, regs, src, dst):
        """One Algorithm 2 merge pass into a fresh panel."""
        from repro_torch.kernels import ops
        return ops.propagate(regs, src, dst, layout=self.layout)

    def estimate_rows(self, regs, cfg):
        """Per-row cardinality estimates honoring ``cfg.estimator``."""
        from repro_torch.kernels import ops
        return ops.estimate(regs, cfg, layout=self.layout)

    def ertl_stats(self, a, b, cfg):
        """Eq. 19 pair statistics of gathered rows (``ops.ertl_stats``)."""
        from repro_torch.kernels import ops
        return ops.ertl_stats(a, b, cfg, layout=self.layout)

    def union_estimate(self, regs, ids, mask, cfg):
        """Fused batched union estimates (``ops.union_estimate``).

        The kernel reduces each merged row to ``(s, z)``; the combination
        honors ``cfg.estimator`` outside it.
        """
        from repro_torch.kernels import ops
        return ops.union_estimate(regs, ids, mask, cfg, layout=self.layout)

    def intersection_stats(self, regs, pairs, cfg):
        """Fused per-pair T̃(xy) statistics ``(stats, sz)``."""
        from repro_torch.kernels import ops
        return ops.intersection_stats(regs, pairs, cfg, layout=self.layout)

    def hip_delta(self, prev, cur):
        """Batch-HIP per-row increments between two hop panels (ADS)."""
        from repro_torch.kernels import ops
        return ops.hip_delta(prev, cur, layout=self.layout)


def resolve(cfg, layout: str = "byte") -> KernelSet:
    """Check that this slice serves ``(cfg, layout)``; bundle a set.

    The config's type selects the family (:func:`family_of`). Raises
    ``TypeError`` for a config of no ported family and ``ValueError``
    for a layout the family does not tolerate (ADS is byte-only).
    """
    if layout not in ("byte", "packed"):
        raise ValueError(f"layout must be 'byte' or 'packed', got {layout!r}")
    fam = family_of(cfg)
    if layout not in fam.layouts:
        raise ValueError(
            f"sketch family {fam.name!r} supports layouts {fam.layouts}, "
            f"not {layout!r} (ADS inverse probabilities need full-width "
            f"registers)")
    return KernelSet(layout=layout, family=fam.name)
