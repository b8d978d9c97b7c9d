"""HyperLogLog sketches as dense register tensors (port of ``repro.core.hll``).

A table of sketches is ``uint8[n, r]`` with ``r = 2**p`` in the byte
layout, or ``uint8[n, r/2]`` with two 4-bit registers per byte in the
packed layout (``kernels.packing``); register value 0 means empty and
inserted values are rho in ``[1, q+1]``, ``q = 64 - p``. Estimators are
pure functions of the per-row harmonic statistics ``(s, z)`` = (sum of
2^-reg, number of zero registers), so the fused estimate kernels never
hand registers back.
All arithmetic is float32, as in the JAX package.

The functional API of the JAX package (``empty``, ``insert``,
``insert_table``, ``merge``, ``estimate*``, ``degree_estimates``) runs
through the ported kernels on the tensors' device: the inserts launch
``hll_accumulate``, the estimates ``hll_estimate_stats`` followed by the
named combination. The accumulate kernel writes in place, so the inserts
clone the caller's registers first and never change a tensor passed in.
``kernels.ops`` imports this module, so the kernels are imported inside
the functions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.inputs import resolve_device

__all__ = ["HLLConfig", "empty", "empty_table", "insert", "insert_table",
           "merge", "alpha", "estimate", "estimate_from_stats",
           "estimate_flajolet", "estimate_beta", "estimate_union",
           "degree_estimates", "rel_std"]


@dataclass(frozen=True)
class HLLConfig:
    """Static configuration of an HLL sketch family.

    Attributes:
      p: prefix size (number of bucket bits). r = 2**p registers.
      seed: hash seed; sketches merged or intersected together must
        share it.
      estimator: "flajolet" (harmonic mean + linear counting) or "beta"
        (LogLogBeta, Eq. 17, fitted coefficients).
    """
    p: int = 8
    seed: int = 0
    estimator: str = "flajolet"

    @property
    def r(self) -> int:
        """Registers per sketch, ``2**p``."""
        return 1 << self.p

    @property
    def q(self) -> int:
        """Bits of the rho window, ``64 - p``; registers reach ``q + 1``."""
        return 64 - self.p

    @property
    def max_register(self) -> int:
        """The largest value a register takes, ``q + 1``."""
        return self.q + 1


def rel_std(p: int) -> float:
    """HLL standard error ~= 1.04 / sqrt(r)  (Eq. 16)."""
    return 1.04 / float(1 << p) ** 0.5


def empty(cfg: HLLConfig, device=None) -> torch.Tensor:
    """One empty sketch ``uint8[r]`` on ``device`` (``None``: the card,
    which must be present)."""
    return torch.zeros((cfg.r,), dtype=torch.uint8,
                       device=resolve_device(device))


def empty_table(n: int, cfg: HLLConfig, layout: str = "byte",
                device: torch.device | str = "cpu") -> torch.Tensor:
    """Zeroed register table for ``n`` sketches under ``layout``, on
    ``device``.

    Row width is ``r`` bytes for the byte layout and ``r / 2`` for the
    packed 4-bit-lane layout (``kernels.packing``; the width is computed
    here so that ``core`` needs no kernels import). The all-zero row is
    the empty sketch in both layouts.
    """
    if layout == "packed":
        return torch.zeros((n, cfg.r // 2), dtype=torch.uint8, device=device)
    if layout != "byte":
        raise ValueError(f"layout must be 'byte' or 'packed', got {layout!r}")
    return torch.zeros((n, cfg.r), dtype=torch.uint8, device=device)


def alpha(r: int) -> float:
    """Bias correction alpha_r (Eq. 15, standard closed approximations)."""
    if r == 16:
        return 0.673
    if r == 32:
        return 0.697
    if r == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / r)


def _combine_flajolet(s: torch.Tensor, z: torch.Tensor,
                      cfg: HLLConfig) -> torch.Tensor:
    """Flajolet/linear-counting combination from harmonic statistics."""
    r = float(cfg.r)
    raw = alpha(cfg.r) * r * r / s
    lin = r * torch.log(r / torch.clamp(z, min=1.0))
    use_lin = (raw <= 2.5 * r) & (z > 0)
    return torch.where(use_lin, lin, raw)


def _combine_beta(s: torch.Tensor, z: torch.Tensor,
                  cfg: HLLConfig) -> torch.Tensor:
    """LogLogBeta combination (Eq. 17) from harmonic statistics."""
    from repro_torch.core._beta_coeffs import BETA_COEFFS
    if cfg.p not in BETA_COEFFS:
        raise ValueError(
            f"no fitted beta coefficients for p={cfg.p}; "
            f"have: {sorted(BETA_COEFFS)}")
    coeffs = torch.tensor(BETA_COEFFS[cfg.p], dtype=torch.float32,
                          device=s.device)
    r = float(cfg.r)
    zl = torch.log(z + 1.0)
    powers = torch.stack([z] + [zl ** k for k in range(1, 8)], dim=-1)
    beta = torch.einsum("...k,k->...", powers, coeffs)
    return alpha(cfg.r) * r * (r - z) / (beta + s)


def estimate_from_stats(s: torch.Tensor, z: torch.Tensor,
                        cfg: HLLConfig) -> torch.Tensor:
    """Cardinality estimate from precomputed (sum 2^-reg, zero count)."""
    if cfg.estimator == "flajolet":
        return _combine_flajolet(s, z, cfg)
    if cfg.estimator == "beta":
        return _combine_beta(s, z, cfg)
    raise ValueError(f"unknown estimator {cfg.estimator!r}")


def _as_keys(keys, device: torch.device) -> torch.Tensor:
    """Keys as a contiguous uint32[E] tensor on ``device``, reduced mod
    2^32 as the JAX package's ``uint32`` cast reduces them."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype != torch.uint32:
            keys = keys.reshape(-1).to(torch.int64) & 0xFFFFFFFF
            keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys)
            keys = keys.to(torch.int32).view(torch.uint32)
        return keys.reshape(-1).to(device).contiguous()
    arr = np.ascontiguousarray(np.asarray(keys).reshape(-1).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device).view(torch.uint32)


def _as_rows(rows, device: torch.device,
             dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Row ids or a mask (a tensor or an array) as a contiguous 1-D
    tensor of ``dtype`` on ``device``."""
    t = rows if isinstance(rows, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(rows))
    return t.reshape(-1).to(device=device, dtype=dtype).contiguous()


def insert(regs: torch.Tensor, keys, cfg: HLLConfig) -> torch.Tensor:
    """Insert a batch of keys into one sketch ``uint8[r]``; returns a new
    sketch (one ``hll_accumulate`` launch on a clone of ``regs``)."""
    out = regs.reshape(1, cfg.r).clone(memory_format=torch.contiguous_format)
    keys = _as_keys(keys, out.device)
    rows = torch.zeros(keys.shape, dtype=torch.int32, device=out.device)
    from repro_torch.kernels import ops
    return ops.accumulate(out, rows, keys, cfg).reshape(cfg.r)


def insert_table(regs: torch.Tensor, rows, keys, cfg: HLLConfig, *,
                 mask=None) -> torch.Tensor:
    """Insert ``keys[i]`` into sketch ``regs[rows[i]]`` (scatter-max);
    returns a new table, ``regs`` unchanged.

    Algorithm 1's INSERT(D[x], y) over an edge block: rows = vertices x,
    keys = neighbor ids y. ``mask=False`` entries are dropped. One
    ``hll_accumulate`` launch on a clone of ``regs``.
    """
    out = regs.clone(memory_format=torch.contiguous_format)
    rows = _as_rows(rows, out.device)
    keys = _as_keys(keys, out.device)
    if mask is not None:
        mask = _as_rows(mask, out.device, torch.bool)
    from repro_torch.kernels import ops
    return ops.accumulate(out, rows, keys, cfg, mask=mask)


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed union operator: element-wise register max (Algorithm 6
    MERGE), a new tensor."""
    return torch.maximum(a, b)


def _row_stats(regs: torch.Tensor, r: int,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s, z)`` of every sketch of ``regs`` (..., r) from one
    ``hll_estimate_stats`` launch, each shaped like the leading axes."""
    from repro_torch.kernels.hll_estimate import hll_estimate_stats
    lead = regs.shape[:-1]
    if regs.shape[-1] != r:
        raise ValueError(f"the last axis holds {regs.shape[-1]} registers, "
                         f"the config {r}")
    rows = regs.reshape(-1, r)
    if not rows.is_contiguous() or rows.data_ptr() % 8:
        rows = rows.clone(memory_format=torch.contiguous_format)
    stats = hll_estimate_stats(rows)
    return stats[:, 0].reshape(lead), stats[:, 1].reshape(lead)


def estimate_flajolet(regs: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Flajolet harmonic-mean estimator (Eq. 14) + linear counting, per
    sketch of ``regs`` (..., r), float32 of the leading shape. Ignores
    ``cfg.estimator``."""
    return _combine_flajolet(*_row_stats(regs, cfg.r), cfg)


def estimate_beta(regs: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """LogLogBeta estimator (Eq. 17) per sketch of ``regs`` (..., r),
    float32 of the leading shape. Ignores ``cfg.estimator``."""
    return _combine_beta(*_row_stats(regs, cfg.r), cfg)


def estimate(regs: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Cardinality estimate by ``cfg.estimator`` for sketch(es) (..., r);
    a single sketch ``(r,)`` gives a 0-d tensor."""
    if cfg.estimator == "flajolet":
        return estimate_flajolet(regs, cfg)
    if cfg.estimator == "beta":
        return estimate_beta(regs, cfg)
    raise ValueError(f"unknown estimator {cfg.estimator!r}")


def estimate_union(a: torch.Tensor, b: torch.Tensor,
                   cfg: HLLConfig) -> torch.Tensor:
    """|A ∪ B| via the closed union operator."""
    return estimate(merge(a, b), cfg)


def degree_estimates(table: torch.Tensor, cfg: HLLConfig) -> torch.Tensor:
    """Degree query over a sketch table ``uint8[n, r]``, float32[n]."""
    return estimate(table, cfg)
