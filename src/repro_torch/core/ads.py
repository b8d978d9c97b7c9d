"""All-Distances Sketches (ADS) with batch HIP estimators (port of
``repro.core.ads``).

An All-Distances Sketch (Cohen, arXiv:1306.3284) summarizes, for every
vertex ``v``, the distance-ordered stream of vertices reachable from
``v``. The k-partition (HLL-style) instantiation keeps one max-rho
register per bucket, so its rows have the shape and merge semantics of
the HLL tables: ``uint8[n, r]`` with ``r = 2**p``, scatter-max
accumulate, register-max merge. ADS queries read the whole hop sequence
``D^1[v] ⊆ D^2[v] ⊆ ...`` (the t-hop panels the engine already
materializes) through Historic Inverse Probability (HIP) estimates.

Batch HIP: under batch-synchronous hops only the panel before and after
each hop is seen, so a register going ``x -> y`` (``y > x``) contributes
``2**x``, its inverse change probability against the pre-hop state.
Updates coalesced inside one hop are undercounted, so the cumulative
curve is floored by the plain (Flajolet) estimate of the post-hop panel:

    C^1 = plain(D^1)
    C^t = max(C^{t-1} + hip_delta(D^{t-1}, D^t), plain(D^t))    t >= 2

The curve is monotone in ``t``, so the distance histogram
``h^t = C^t - C^{t-1}`` is non-negative.

ADS rows are byte layout only: packed 4-bit lanes saturate at 15 and
would cap every ``2**x`` weight at ``2**15``. ``hip_delta`` runs the
``hip_delta_rows`` kernel on a CUDA tensor and its plain version on a
CPU tensor; the curve functions below it are float64 numpy, as in the
JAX package, so both agree exactly on the same curve.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import hll

__all__ = ["ADSConfig", "hip_delta", "hip_curve", "distance_histogram",
           "closeness_from_curve", "effective_diameter_from_curve", "rel_std"]


@dataclass(frozen=True)
class ADSConfig:
    """Static configuration of a k-partition All-Distances Sketch family.

    Attributes:
      p: prefix size (number of bucket bits); r = 2**p registers per row,
        the register geometry of ``HLLConfig``.
      seed: hash seed; sketches merged together must share it.
      estimator: "hip", the batch HIP curve estimator. The plain per-row
        floor always uses the Flajolet combination.
    """
    p: int = 8
    seed: int = 0
    estimator: str = "hip"

    @property
    def r(self) -> int:
        """Registers per row (2**p), one byte each."""
        return 1 << self.p

    @property
    def q(self) -> int:
        """Hash suffix bits available for the rank (64 - p)."""
        return 64 - self.p

    @property
    def max_register(self) -> int:
        """Largest storable register value (q + 1, rank of all-zeros)."""
        return self.q + 1


def rel_std(p: int) -> float:
    """HIP standard error ~= 1 / sqrt(2r) per estimate (Cohen §3.3)."""
    return 1.0 / (2.0 * float(1 << p)) ** 0.5


def hip_delta(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Per-row batch-HIP increment between consecutive hop panels.

    ``prev``/``cur``: uint8[..., r] byte-layout register rows. Returns
    float32[...]: ``sum_j [cur_j > prev_j] * 2**prev_j``, the summed
    inverse change probabilities of every register the hop grew; a
    register that fell contributes nothing. Rows narrower than the
    kernel's (a power of two >= 8) are padded with unchanged zero lanes.
    """
    from repro_torch.kernels.hip_delta import hip_delta_rows
    r = prev.shape[-1]
    pad = max(8, 1 << (r - 1).bit_length()) - r
    rows = [x.reshape(-1, r) for x in (prev, cur)]
    if pad:
        rows = [torch.nn.functional.pad(x, (0, pad)) for x in rows]
    out = hip_delta_rows(*(x.contiguous() for x in rows))
    return out.reshape(prev.shape[:-1])


def _plain_cfg(cfg: ADSConfig) -> hll.HLLConfig:
    """The HLL view of an ADS config (same registers, Flajolet floor)."""
    return hll.HLLConfig(p=cfg.p, seed=cfg.seed, estimator="flajolet")


def hip_curve(panels, cfg: ADSConfig) -> np.ndarray:
    """Stabilized cumulative HIP curve over hop panels ``D^1..D^T``.

    ``panels``: sequence of byte-layout uint8[n, r] register panels (one
    per hop, monotone under register max), on one device. Returns
    float64[T, n] with ``C^t[v]`` the estimated neighborhood mass of
    ``v`` within ``t`` hops. The engine computes the same curve through
    its panel cache and caches it beside the panels.
    """
    from repro_torch.kernels import ops
    curve = []
    for t, panel in enumerate(panels):
        plain = ops.estimate(panel, cfg).cpu().numpy().astype(np.float64)
        if t == 0:
            c = plain
        else:
            delta = hip_delta(panels[t - 1], panel).cpu().numpy()
            c = np.maximum(curve[-1] + delta.astype(np.float64), plain)
        curve.append(c)
    return np.stack(curve, axis=0)


def distance_histogram(curve: np.ndarray) -> np.ndarray:
    """Per-distance mass ``h^t = C^t - C^{t-1}`` from a HIP curve.

    ``curve``: float64[T, n] monotone HIP curve. Returns float64[T, n]
    with ``h[0] = C^1`` (mass at distance 1) and non-negative rows.
    """
    return np.diff(curve, axis=0, prepend=np.zeros((1, curve.shape[1])))


def closeness_from_curve(curve: np.ndarray) -> np.ndarray:
    """Horizon-T closeness centralities from a HIP curve.

    ``closeness[v] = C^T[v] / sum_t t * h^t[v]``; vertices with no
    estimated reachable mass get 0. float64[n].
    """
    hist = distance_histogram(curve)
    t = np.arange(1, curve.shape[0] + 1, dtype=np.float64)
    total_dist = np.einsum("t,tn->n", t, hist)
    reach = curve[-1]
    return np.divide(reach, total_dist,
                     out=np.zeros_like(reach), where=total_dist > 0)


def effective_diameter_from_curve(glob: np.ndarray, q: float = 0.9) -> float:
    """Effective diameter: smallest (interpolated) ``t`` covering ``q``.

    ``glob``: float64[T] global curve ``g[t] = sum_v C^t[v]`` (monotone).
    Returns the linearly interpolated hop count at which the curve first
    reaches ``q * g[T]``, in ``[0, T]`` (``g[0] := 0`` anchors the
    interpolation below the first hop).
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"quantile q must be in (0, 1], got {q}")
    g = np.concatenate([[0.0], np.asarray(glob, np.float64)])
    target = q * g[-1]
    if g[-1] <= 0:
        return 0.0
    t = int(np.searchsorted(g, target))
    if t >= len(g):
        return float(len(g) - 1)
    if g[t] == g[t - 1]:
        return float(t)
    return float(t - 1) + float((target - g[t - 1]) / (g[t] - g[t - 1]))
