"""Kernel set resolution: one capability-checked bundle per engine.

Port of the part of ``repro.kernels.registry`` that the ported queries
use. The JAX package registers ``(family, op, impl)`` entries and lets
engines pick ``ref`` or ``pallas``; the port has one implementation per
op, the CUDA kernel, whose wrapper takes the plain PyTorch version for
CPU tensors, so a :class:`KernelSet` is resolved from the config and the
layout alone. It carries the six HLL ops of the byte layout (accumulate,
propagate, estimate, union_estimate, intersection_stats, ertl_stats).
What is not ported yet — the packed layout, and the ADS family with its
``hip_delta`` kernel — fails here, up front, naming the ROADMAP item that
brings it.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.families import HLL

__all__ = ["KernelSet", "resolve", "family"]


def family(name: str):
    """The family object registered under ``name`` (only ``"hll"`` so far)."""
    if name == "hll":
        return HLL
    if name == "ads":
        raise ValueError("the ADS family is not ported yet "
                         "(ROADMAP Queue A item 12)")
    raise ValueError(f"unknown sketch family {name!r}")


@dataclass(frozen=True)
class KernelSet:
    """The main-path kernels for one (layout, family).

    The estimate kernel's ``(s, z)`` serve every estimator, so the set
    does not depend on ``cfg.estimator``.

    Attributes:
      layout: register-panel layout ("byte").
      family: sketch-family coordinate ("hll").
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


def resolve(cfg, layout: str = "byte") -> KernelSet:
    """Check that this slice serves ``(cfg, layout)``; bundle a set.

    The config's type selects the family, as ``registry.family_of`` does
    in the JAX package. Raises ``ValueError`` for the packed layout, which
    is not ported yet (ROADMAP Queue A item 10), and ``TypeError`` for a
    config of no ported family.
    """
    if layout == "packed":
        raise ValueError("the packed layout is not ported yet "
                         "(ROADMAP Queue A item 10)")
    if layout != "byte":
        raise ValueError(f"layout must be 'byte', got {layout!r}")
    fam = HLL
    if type(cfg) is not fam.config_cls:
        raise TypeError(f"config {type(cfg).__name__} belongs to no ported "
                        f"sketch family (have: {fam.name!r})")
    return KernelSet(layout=layout, family=fam.name)
