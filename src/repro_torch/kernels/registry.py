"""Kernel registry: the ``(family, op, impl)`` coordinates of the kernels,
resolved into checked sets (port of ``repro.kernels.registry``).

The dispatch itself is ``kernels.ops``: every op takes ``impl`` and the
impls are ``ops.IMPLS``, defined there once. This module only views it:
:func:`lookup` binds an op of ``kernels.ops`` to an impl (its error
names the impls the op has), :func:`impls` lists them, and engines
resolve a whole :class:`KernelSet` once, at open or load, through
:func:`resolve`, which fails before any work on an unknown impl.

* ``"cuda"``: the kernel wrappers, which launch the CUDA kernel on a
  CUDA tensor and run the kernel's plain PyTorch version on a CPU tensor;
* ``"ref"``: the plain versions (``kernels/ref.py``, each wrapper's
  ``plain``) on whichever device; they never launch a kernel.

The JAX package's impls are ``ref`` and ``pallas``, which its kernel
modules register into a table; its ``ref`` is the jnp oracles, the
port's the plain PyTorch versions. The port has no such table: its two
impls are branches of each op, so an impl is one name in ``ops.IMPLS``
wherever it is used (the engine's kernel set, the triangle and
functional paths, which call ``ops`` directly). An impl that fails to
build or launch raises: no impl falls back to another.

A set carries seven ops: accumulate, propagate and estimate for both
families, union_estimate, intersection_stats and ertl_stats for HLL, and
hip_delta for ADS; each HLL op has a kernel for the byte and for the
packed 4-bit layout (``kernels.packing``). The family comes from the
config's type (``family_of``). An ADS engine on the packed layout fails
here, up front, as in the JAX package. The estimate kernel's ``(s, z)``
serve every estimator, so a set does not depend on ``cfg.estimator``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

from repro_torch.core.families import ADS, HLL, SketchFamily
from repro_torch.kernels.packing import LAYOUTS

__all__ = ["OPS", "LAYOUTS", "KernelSet", "SketchFamily", "resolve",
           "lookup", "impls", "family", "families", "family_of"]

#: the ops a complete hll kernel set provides (the JAX package's
#: module-level tuple; each family carries its own, ``SketchFamily.ops``)
OPS = HLL.ops

#: the families, fixed: their ops are branches of ``kernels.ops``, so a
#: family added from outside could not bring its own kernels (the JAX
#: package's ``register_family`` has no counterpart here)
_FAMILIES = {fam.name: fam for fam in (HLL, ADS)}


def family(name: str):
    """The family object registered under ``name`` ("hll" or "ads")."""
    fam = _FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown sketch family {name!r}; known families: "
                         f"{sorted(_FAMILIES)}")
    return fam


def families() -> list[str]:
    """Sorted names of the sketch families ("ads", "hll")."""
    return sorted(_FAMILIES)


def family_of(cfg):
    """The family whose config class ``cfg`` is an instance of."""
    for fam in _FAMILIES.values():
        if type(cfg) is fam.config_cls:
            return fam
    raise TypeError(f"config {type(cfg).__name__} belongs to no ported "
                    f"sketch family (have: {sorted(_FAMILIES)})")


def _ops():
    """``kernels.ops``, imported on use: it imports the families'
    modules, which this module's importers may be loading."""
    from repro_torch.kernels import ops
    return ops


def impls(op: str, family: str = "hll") -> list[str]:
    """Sorted impl names serving ``op`` under ``family``: every impl of
    ``kernels.ops`` for an op of the family, none otherwise."""
    fam = _FAMILIES.get(family)
    return sorted(_ops().IMPLS) if fam and op in fam.ops else []


def lookup(op: str, impl: str, family: str = "hll"):
    """``kernels.ops.<op>`` bound to ``impl``; ``KeyError`` naming the
    impls of ``op`` when ``(family, op, impl)`` has none."""
    if impl not in impls(op, family):
        raise KeyError(
            f"no kernel for family={family!r} op={op!r} impl={impl!r}; "
            f"impls for {op!r}: {impls(op, family)}")
    return functools.partial(getattr(_ops(), op), impl=impl)


@dataclass(frozen=True)
class KernelSet:
    """The main-path kernels for one (impl, layout, family).

    Hashable and value-comparable; each method calls its op of
    ``kernels.ops`` with the set's impl and layout. The block arguments
    are the JAX ``OpSet``'s: ``None`` resolves through the autotune table
    (``kernels.autotune``), a value is the kernel's launch shape.

    Attributes:
      impl: kernel implementation ("cuda" or "ref").
      layout: register-panel layout ("byte" or "packed").
      family: sketch-family coordinate ("hll" or "ads").
    """

    impl: str = "cuda"
    layout: str = "byte"
    family: str = "hll"

    def _op(self, op: str):
        return functools.partial(getattr(_ops(), op), impl=self.impl,
                                 layout=self.layout)

    def accumulate(self, regs, rows, keys, cfg, mask=None, edge_block=None):
        """Algorithm 1 INSERT over an edge block, in place."""
        return self._op("accumulate")(regs, rows, keys, cfg, mask=mask,
                                      edge_block=edge_block)

    def propagate(self, regs, src, dst, edge_block=None):
        """One Algorithm 2 merge pass into a fresh panel."""
        return self._op("propagate")(regs, src, dst, edge_block=edge_block)

    def estimate_rows(self, regs, cfg):
        """Per-row cardinality estimates honoring ``cfg.estimator``."""
        return self._op("estimate")(regs, cfg)

    def ertl_stats(self, a, b, cfg, pair_block=None):
        """Eq. 19 pair statistics of gathered rows (``ops.ertl_stats``)."""
        return self._op("ertl_stats")(a, b, cfg, pair_block=pair_block)

    def union_estimate(self, regs, ids, mask, cfg, set_block=None):
        """Fused batched union estimates (``ops.union_estimate``).

        The kernel reduces each merged row to ``(s, z)``; the combination
        honors ``cfg.estimator`` outside it.
        """
        return self._op("union_estimate")(regs, ids, mask, cfg,
                                          set_block=set_block)

    def intersection_stats(self, regs, pairs, cfg, pair_block=None):
        """Fused per-pair T̃(xy) statistics ``(stats, sz)``."""
        return self._op("intersection_stats")(regs, pairs, cfg,
                                              pair_block=pair_block)

    def hip_delta(self, prev, cur, row_block=None):
        """Batch-HIP per-row increments between two hop panels (ADS)."""
        return self._op("hip_delta")(prev, cur, row_block=row_block)


def resolve(cfg, layout: str = "byte", impl: str = "cuda") -> KernelSet:
    """Check that ``impl`` serves ``(cfg, layout)``; bundle a set.

    The config's type selects the family (:func:`family_of`). Raises,
    before any work, ``ValueError`` for an impl not in ``ops.IMPLS``
    (naming those), ``TypeError`` for a config of no ported family and
    ``ValueError`` for a layout the family does not tolerate (ADS is
    byte-only).
    """
    if layout not in ("byte", "packed"):
        raise ValueError(f"layout must be 'byte' or 'packed', got {layout!r}")
    fam = family_of(cfg)
    if impl not in _ops().IMPLS:
        raise ValueError(
            f"impl {impl!r} is not a kernel implementation of kernels.ops; "
            f"known impls: {sorted(_ops().IMPLS)}")
    if layout not in fam.layouts:
        raise ValueError(
            f"sketch family {fam.name!r} supports layouts {fam.layouts}, "
            f"not {layout!r} (ADS inverse probabilities need full-width "
            f"registers)")
    return KernelSet(impl=impl, layout=layout, family=fam.name)
