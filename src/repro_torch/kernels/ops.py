"""Kernel glue: the padding and parking conventions of ``repro.kernels.ops``.

* accumulate: masked edges are skipped by the kernel and park on row 0
  with rho 0 in the plain version, ``ops.py:77-87``;
* propagate_into: the two-panel merge of the sharded schedules (the JAX
  package's ``packing.scatter_max_rows``) over a dst-sorted group, as
  the sharded plan builds it;
* propagate: masked slots are dropped before the launch, which equals
  the JAX package's parking of them on ``(0, 0)``, a self-merge no-op
  (``ops.py:178-180``); on the card a routing whose ``dst`` is not
  non-decreasing is sorted first (``hll_propagate.sort_routing``: the
  kernel pulls over dst-sorted edge runs) and a panel that is not 16-byte
  aligned is copied, so edges come in any order, as the reference takes
  them;
* estimate: the kernel's ``(s, z)`` are combined by the config's
  estimator (Flajolet, ``ops.py:208-224``, or LogLogBeta); an ADS
  config takes the Flajolet combination, its plain floor;
* intersection_stats: pair lanes ``(B, 2)`` split into the two endpoint
  vectors; padding pairs gather row 0 and the caller drops their answers;
* union_estimate: padding slots of the ``(B, L)`` set panel are masked
  and merge nothing; the kernel's ``(s, z)`` are combined by the config's
  estimator, ``ops.py:247-263``;
* ertl_stats: row pairs already gathered by the caller, ``ops.py:331``;
* hip_delta: two hop panels of one shape, byte layout only,
  ``ops.py:360-376``;
* intersection_newton: no JAX op (the reference's Newton steps are
  ``jax.grad`` / ``jax.hessian`` in a ``lax.scan``): every damped Newton
  step of the intersection MLE for a batch of pairs, from their start and
  Eq. 19 histograms, layout-free and untuned.

Every HLL op takes ``layout``: on "packed" each wrapper launches its
packed kernel (rows of r/2 bytes, two 4-bit registers a byte), where the
JAX package's plain versions unpack or merge nibble planes
(``ops.py:77-90, 152-160, 191-196, 229-234, 270-276, 313-317``).

Every op also takes ``impl``, the kernel implementation
(``kernels.registry``): "cuda" calls the wrapper, which launches the
kernel on a CUDA tensor and runs its plain version on a CPU tensor;
"ref" calls the plain version (``kernels/ref.py``, each wrapper's
``plain``) on whichever device, and never launches a kernel.

The CUDA kernels need no block padding (each masks its own ragged edge).
Each op but ``propagate_into`` takes the JAX package's block argument
(``edge_block``, ``row_block``, ``set_block``, ``pair_block``), which on
the card is its kernel's launch shape: ``None`` resolves through
``kernels.autotune`` (a swept winner for this card, ``p``, impl, layout
and the call's size class, else the fallback table), and ``p`` comes
from ``cfg.p`` or, for ``propagate`` and ``hip_delta``, from the panel's
width, as the JAX package's ``_panel_p`` takes it. The plain versions (``impl="ref"``, or a CPU tensor)
ignore it, as the JAX ``ref`` registrations do.
"""
from __future__ import annotations

import torch

from repro_torch.core import ads, hll
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import ertl_stats as _ertl
from repro_torch.kernels import hip_delta as _hip
from repro_torch.kernels import hll_accumulate as _acc
from repro_torch.kernels import hll_estimate as _est
from repro_torch.kernels import hll_propagate as _prop
from repro_torch.kernels import intersection_newton as _newton
from repro_torch.kernels import intersection_stats as _pair
from repro_torch.kernels import union_estimate as _union
from repro_torch.kernels.ertl_stats import ertl_stats as _ertl_stats
from repro_torch.kernels.hip_delta import hip_delta_rows
from repro_torch.kernels.hll_accumulate import hll_accumulate
from repro_torch.kernels.hll_estimate import hll_estimate_stats
from repro_torch.kernels.hll_propagate import (
    dst_sorted, hll_propagate, hll_propagate_into, sort_routing)
from repro_torch.kernels.intersection_stats import (
    intersection_stats as _intersection_stats)
from repro_torch.kernels.union_estimate import union_estimate_stats

__all__ = ["accumulate", "propagate", "propagate_into", "estimate",
           "union_estimate",
           "intersection_stats", "ertl_stats", "hip_delta",
           "intersection_newton", "IMPLS"]

#: the kernel implementations every op serves
IMPLS = ("cuda", "ref")


def _panel_p(regs: torch.Tensor, layout: str) -> int:
    """The precision of a panel from its row width (two registers a byte
    packed)."""
    r = regs.shape[1] * (2 if layout == "packed" else 1)
    return r.bit_length() - 1


def _plain(impl: str) -> bool:
    """True for ``impl="ref"`` (the plain version on any device), False
    for "cuda" (the wrapper); ``ValueError`` for any other name."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "ref"


def accumulate(regs: torch.Tensor, rows: torch.Tensor, keys: torch.Tensor,
               cfg: HLLConfig, mask: torch.Tensor | None = None,
               layout: str = "byte", impl: str = "cuda",
               edge_block: int | None = None) -> torch.Tensor:
    """Insert keys[e] into sketch regs[rows[e]] in place (Algorithm 1);
    ``mask=None`` inserts every edge (the kernel then reads no mask)."""
    if _plain(impl):
        return _acc.plain(regs, rows, keys, mask, p=cfg.p, seed=cfg.seed,
                          layout=layout)
    edge_block = autotune.resolve_block("accumulate", "edge_block",
                                        edge_block, p=cfg.p, impl=impl,
                                        layout=layout, size=rows.shape[0])
    return hll_accumulate(regs, rows, keys, mask, p=cfg.p, seed=cfg.seed,
                          layout=layout, edge_block=edge_block)


def propagate(regs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              mask: torch.Tensor | None = None,
              layout: str = "byte", impl: str = "cuda",
              edge_block: int | None = None) -> torch.Tensor:
    """One Algorithm 2 merge pass into a fresh panel, over edges in any
    order; ``mask`` (bool[E]) drops the slots where it is False. A
    dst-sorted routing, as the engine builds it, is launched as it is."""
    if mask is not None:
        _build.check_ids(mask, "mask", regs, src.shape[0], dtype=torch.bool)
        src, dst = src[mask], dst[mask]
    if _plain(impl):
        return _prop.plain(regs, src, dst, layout=layout)
    if _build.check_device(regs, "regs"):
        if not dst_sorted(dst):
            src, dst = sort_routing(src, dst)
        if regs.data_ptr() % 16:
            regs = regs.clone()
    edge_block = autotune.resolve_block("propagate", "edge_block", edge_block,
                                        p=_panel_p(regs, layout), impl=impl,
                                        layout=layout, size=src.shape[0])
    return hll_propagate(regs, src, dst, layout=layout, edge_block=edge_block)


def propagate_into(out: torch.Tensor, src_panel: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor,
                   layout: str = "byte", impl: str = "cuda") -> torch.Tensor:
    """``out[dst] max= src_panel[src]`` in place (``src`` rows of
    ``src_panel``, ``dst`` rows of ``out``); returns ``out``. ``dst``
    must be non-decreasing: the sharded plan builds its groups so, and
    the card's kernel takes that order unchecked (no host sync)."""
    if _plain(impl):
        return _prop.plain_into(out, src_panel, src, dst, layout=layout)
    return hll_propagate_into(out, src_panel, src, dst, layout=layout,
                              check_order=False)


def estimate(regs: torch.Tensor, cfg, layout: str = "byte",
             impl: str = "cuda", row_block: int | None = None) -> torch.Tensor:
    """Cardinality estimate per sketch row (uint8[N, w]) by ``cfg.estimator``;
    an ``ADSConfig`` gets the Flajolet combination (the HIP curve's
    plain floor)."""
    if _plain(impl):
        stats = _est.plain(regs, layout=layout)
    else:
        row_block = autotune.resolve_block("estimate", "row_block", row_block,
                                           p=cfg.p, impl=impl, layout=layout,
                                           size=regs.shape[0])
        stats = hll_estimate_stats(regs, layout=layout, row_block=row_block)
    if isinstance(cfg, ads.ADSConfig):
        cfg = ads._plain_cfg(cfg)
    return hll.estimate_from_stats(stats[:, 0], stats[:, 1], cfg)


def union_estimate(regs: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                   cfg: HLLConfig, layout: str = "byte",
                   impl: str = "cuda",
                   set_block: int | None = None) -> torch.Tensor:
    """|∪ N(x)| per row of a padded ``(ids int32[B, L], mask bool[B, L])``
    set panel, by ``cfg.estimator``; masked lanes merge nothing."""
    if _plain(impl):
        stats = _union.plain(regs, ids, mask, layout=layout)
    else:
        set_block = autotune.resolve_block("union_estimate", "set_block",
                                           set_block, p=cfg.p, impl=impl,
                                           layout=layout, size=ids.shape[0])
        stats = union_estimate_stats(regs, ids, mask, layout=layout,
                                     set_block=set_block)
    return hll.estimate_from_stats(stats[:, 0], stats[:, 1], cfg)


def intersection_stats(regs: torch.Tensor, pairs: torch.Tensor,
                       cfg: HLLConfig, layout: str = "byte",
                       impl: str = "cuda", pair_block: int | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused T̃(xy) pair statistics over ``(B, 2)`` int32 pair lanes."""
    pa, pb = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
    if _plain(impl):
        return _pair.plain(regs, pa, pb, cfg.q, layout=layout)
    pair_block = autotune.resolve_block("intersection_stats", "pair_block",
                                        pair_block, p=cfg.p, impl=impl,
                                        layout=layout, size=pairs.shape[0])
    return _intersection_stats(regs, pa, pb, cfg.q, layout=layout,
                               pair_block=pair_block)


def ertl_stats(a: torch.Tensor, b: torch.Tensor, cfg: HLLConfig,
               layout: str = "byte", impl: str = "cuda",
               pair_block: int | None = None) -> torch.Tensor:
    """Eq. 19 statistics float32[E, 5, q+2] for paired rows uint8[E, w]."""
    if _plain(impl):
        return _ertl.plain(a, b, cfg.q, layout=layout)
    pair_block = autotune.resolve_block("ertl_stats", "pair_block",
                                        pair_block, p=cfg.p, impl=impl,
                                        layout=layout, size=a.shape[0])
    return _ertl_stats(a, b, cfg.q, layout=layout, pair_block=pair_block)


def hip_delta(prev: torch.Tensor, cur: torch.Tensor,
              layout: str = "byte", impl: str = "cuda",
              row_block: int | None = None) -> torch.Tensor:
    """Batch-HIP per-row increments between hop panels uint8[N, r]:
    ``sum_j [cur_j > prev_j] * 2**prev_j`` (ADS family, byte layout only)."""
    if layout != "byte":
        raise ValueError(f"hip_delta requires byte layout, got {layout!r}")
    if _plain(impl):
        return _hip.plain(prev, cur, layout=layout)
    row_block = autotune.resolve_block("hip_delta", "row_block", row_block,
                                       p=_panel_p(prev, layout), impl=impl,
                                       layout=layout, size=prev.shape[0])
    return hip_delta_rows(prev, cur, layout=layout, row_block=row_block)


def intersection_newton(theta0: torch.Tensor, stats: torch.Tensor, q: int,
                        r: int, iters: int,
                        impl: str = "cuda") -> torch.Tensor:
    """``iters`` damped Newton steps of the intersection MLE per pair:
    theta0 float32[B, 3] and Eq. 19 stats float32[B, 5, q+2] ->
    float32[B, 3]."""
    if _plain(impl):
        return _newton.plain(theta0, stats, q, r, iters)
    return _newton.intersection_newton(theta0, stats, q, r, iters)
