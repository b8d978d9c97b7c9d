"""HyperLogLog sketches as dense register tensors (port of ``repro.core.hll``).

A table of sketches is ``uint8[n, r]`` with ``r = 2**p`` in the byte
layout, or ``uint8[n, r/2]`` with two 4-bit registers per byte in the
packed layout (``kernels.packing``); register value 0 means empty and
inserted values are rho in ``[1, q+1]``, ``q = 64 - p``. Estimators are
pure functions of the per-row harmonic statistics ``(s, z)`` = (sum of
2^-reg, number of zero registers), so the fused estimate kernels never
hand registers back.
All arithmetic is float32, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["HLLConfig", "empty_table", "alpha", "estimate_from_stats",
           "rel_std"]


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


def rel_std(p: int) -> float:
    """HLL standard error ~= 1.04 / sqrt(r)  (Eq. 16)."""
    return 1.04 / float(1 << p) ** 0.5


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
