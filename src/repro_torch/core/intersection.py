"""HLL intersection estimation (paper §4.1; Ertl 2017), port of
``repro.core.intersection``.

Under Poissonization a register exposed to rate ``t`` has
``P(K <= k) = exp(-t u_k)`` with ``u_k = 2^-k`` (``u_{q+1} = 0``). For
sketches A, B split into disjoint rates (|A\\B|, |B\\A|, |A ∩ B|) the joint
register pmf is closed-form, and the log-likelihood depends on a register
pair only through the Eq. 19 count histograms that the
``intersection_stats`` kernel (pairs gathered from a panel) or the
``ertl_stats`` kernel (rows given, :func:`mle_cardinalities`) emits. The MLE maximizes it over
``theta = log(lambda)`` with a damped Newton iteration of fixed length.
The JAX package takes the gradient and 3x3 Hessian by ``jax.grad`` /
``jax.hessian`` under ``vmap`` inside a ``lax.scan``. Here the whole
iteration is the ``intersection_newton`` kernel (``ops.intersection_newton``,
one launch for all steps of all pairs), whose plain version, the CPU's
and ``impl="ref"``'s path, is an eager loop over the gradient and Hessian
derived by hand (``kernels.intersection_newton.grad_hess``, imported here
as :func:`_grad_hess`). ``torch.func`` on :func:`log_likelihood` gives
the same derivatives (the tests hold one against the other).

float32 throughout. The ``1e-38`` floor under each ``log`` is subnormal
in float32; PyTorch keeps subnormals on the CPU and on the card (its
kernels are not built with flush-to-zero), and so does the kernel
library, so the floor stays non-zero.
"""
from __future__ import annotations

import torch

from repro_torch.core import hll
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import ops, packing
from repro_torch.kernels.intersection_newton import TINY as _TINY
from repro_torch.kernels.intersection_newton import (
    grad_hess as _grad_hess, hessian_overflows as _hessian_overflows,
    survival_weights as _survival_weights)
from repro_torch.tracing import span

__all__ = ["ertl_stats", "log_likelihood", "mle_cardinalities",
           "mle_intersection", "inclusion_exclusion", "domination_flags",
           "mle_from_stats", "estimate_from_pair_stats",
           "hessian_overflow_share", "NEWTON_ITERS"]

#: Newton iterations when the caller passes none (``_NEWTON_ITERS`` in JAX)
NEWTON_ITERS = 50


def ertl_stats(a: torch.Tensor, b: torch.Tensor, cfg: HLLConfig,
               layout: str = "byte", impl: str = "cuda") -> torch.Tensor:
    """Eq. 19 count statistics of register rows a, b: ``uint8[E, w]``
    (w = r, or r/2 on the packed layout).

    Returns ``float32[E, 5, q+2]`` stacked as [c_a_lt, c_a_gt, c_b_lt,
    c_b_gt, c_eq], from the ``ertl_stats`` kernel (``impl="ref"``: its
    plain version).
    """
    return ops.ertl_stats(a.contiguous(), b.contiguous(), cfg, layout=layout,
                          impl=impl)


def _log_pmf(t: torch.Tensor, u: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """log P(K = k | rate t) over all k in [0, q+2); t scalar, result (q+2,)."""
    tiny = torch.full_like(d, _TINY)
    body = -t * u + torch.log(torch.maximum(-torch.expm1(-t * d), tiny))
    return torch.cat([(-t).reshape(1), body[1:]])


def _log_pmf_eq(ta, tb, tx, u, d) -> torch.Tensor:
    """log P(A = B = k) over k in [0, q+2)."""
    tsum = ta + tb + tx
    ew_a = -torch.expm1(-(ta + tx) * d)
    ew_b = -torch.expm1(-(tb + tx) * d)
    ew_x = -torch.expm1(-tx * d)
    bracket = ew_a * ew_b + torch.exp(-tsum * d) * ew_x
    tiny = torch.full_like(d, _TINY)
    body = -tsum * u + torch.log(torch.maximum(bracket, tiny))
    return torch.cat([(-tsum).reshape(1), body[1:]])


def log_likelihood(theta: torch.Tensor, stats: torch.Tensor,
                   u: torch.Tensor, d: torch.Tensor, r: int) -> torch.Tensor:
    """Poisson log-likelihood of theta = log [lambda_a, lambda_b, lambda_x].

    ``stats`` is one pair's (5, q+2) Eq. 19 histogram panel; ``u``/``d``
    come from :func:`_survival_weights`.
    """
    lam = torch.exp(theta)
    ta, tb, tx = lam[0] / r, lam[1] / r, lam[2] / r
    return (torch.dot(stats[0], _log_pmf(ta + tx, u, d))
            + torch.dot(stats[3], _log_pmf(tb, u, d))
            + torch.dot(stats[1], _log_pmf(ta, u, d))
            + torch.dot(stats[2], _log_pmf(tb + tx, u, d))
            + torch.dot(stats[4], _log_pmf_eq(ta, tb, tx, u, d)))


def _newton_solve(theta0: torch.Tensor, stats: torch.Tensor, q: int, r: int,
                  iters: int, impl: str = "cuda") -> torch.Tensor:
    """Damped Newton ascent, batched over pairs: theta0 [B, 3] -> [B, 3].

    ``ops.intersection_newton``: every step of every pair in one
    ``intersection_newton`` launch on a CUDA tensor, the plain eager loop
    on a CPU tensor or with ``impl="ref"``.
    """
    with span("intersection.newton"):
        return ops.intersection_newton(theta0.contiguous(), stats.contiguous(),
                                       q, r, iters, impl=impl)


def mle_from_stats(stats: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
                   eu: torch.Tensor, cfg: HLLConfig,
                   iters: int = NEWTON_ITERS, impl: str = "cuda",
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLE (|A\\B|, |B\\A|, |A ∩ B|) from Eq. 19 stats + HLL estimates.

    ``stats`` is float32[B, 5, q+2]; ``ea``/``eb``/``eu`` the per-pair
    |A| / |B| / |A ∪ B| estimates, used as the clipped
    inclusion-exclusion Newton initializer. ``impl="ref"`` runs the
    Newton kernel's plain version.
    """
    args = (_initial_theta(ea, eb, eu), stats, cfg.q, cfg.r, iters)
    # the default impl calls the solver with its five arguments alone, the
    # call that the benchmark's fault checks replace
    theta = (_newton_solve(*args) if impl == "cuda"
             else _newton_solve(*args, impl=impl))
    lam = torch.exp(theta)
    return lam[:, 0], lam[:, 1], lam[:, 2]


def _initial_theta(ea: torch.Tensor, eb: torch.Tensor,
                   eu: torch.Tensor) -> torch.Tensor:
    """Clipped inclusion-exclusion initializer log [a0, b0, x0], [B, 3]."""
    x0 = torch.clamp(ea + eb - eu, min=1.0)
    a0 = torch.clamp(ea - x0, min=1.0)
    b0 = torch.clamp(eb - x0, min=1.0)
    return torch.log(torch.stack([a0, b0, x0], dim=-1))


def mle_cardinalities(a: torch.Tensor, b: torch.Tensor, cfg: HLLConfig,
                      iters: int = NEWTON_ITERS, layout: str = "byte",
                      impl: str = "cuda",
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLE (|A\\B|, |B\\A|, |A ∩ B|) for register rows a, b: ``uint8[E, w]``.

    The Eq. 19 histograms come from the ``ertl_stats`` kernel; the
    initializer's |A|, |B| and |A ∪ B| from the estimate kernel's
    ``(s, z)`` over a, b and their register-wise max, as the JAX package
    takes ``hll.estimate`` of a, b and ``hll.merge(a, b)``. Packed rows
    merge nibble by nibble (``packing.merge_rows``); a byte-wise max of
    packed bytes would be wrong. ``impl="ref"`` runs the kernels' plain
    versions instead.
    """
    a, b = a.contiguous(), b.contiguous()
    ea, eb, eu = (ops.estimate(rows, cfg, layout=layout, impl=impl)
                  for rows in (a, b, packing.merge_rows(a, b, layout)))
    return mle_from_stats(ertl_stats(a, b, cfg, layout, impl), ea, eb, eu,
                          cfg, iters, impl)


def mle_intersection(a: torch.Tensor, b: torch.Tensor, cfg: HLLConfig,
                     iters: int = NEWTON_ITERS, layout: str = "byte",
                     impl: str = "cuda") -> torch.Tensor:
    """|A ∩ B| via the joint MLE, the paper's T̃(xy) primitive (Eq. 10)."""
    return mle_cardinalities(a, b, cfg, iters, layout, impl)[2]


def inclusion_exclusion(a: torch.Tensor, b: torch.Tensor,
                        cfg: HLLConfig) -> torch.Tensor:
    """|A ∩ B| ~= |A| + |B| - |A ∪ B| (Eq. 18, sign-corrected), per pair
    of sketches (..., r); can be < 0."""
    return (hll.estimate(a, cfg) + hll.estimate(b, cfg)
            - hll.estimate(hll.merge(a, b), cfg))


def domination_flags(a: torch.Tensor, b: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A dominates B, A strictly dominates B) per Appendix B, per pair of
    sketches (..., r): every register of A at least B's; and every
    register of A above B's or B's empty, with B not empty."""
    ai, bi = a.to(torch.int32), b.to(torch.int32)
    dom = (ai >= bi).all(dim=-1)
    strict = ((ai > bi) | (bi == 0)).all(dim=-1) & (bi > 0).any(dim=-1)
    return dom, strict


def hessian_overflow_share(stats: torch.Tensor, sz: torch.Tensor,
                           cfg: HLLConfig, iters: int = NEWTON_ITERS,
                           ) -> tuple[float, float]:
    """Share of pairs whose Newton step the overflow flag rejects.

    Returns the share flagged at the initializer (their first step is
    rejected) and at the final iterate (stuck there), for the pair
    statistics ``(stats, sz)`` that ``intersection_size`` would use.
    """
    ea, eb, eu = (hll.estimate_from_stats(sz[:, i, 0], sz[:, i, 1], cfg)
                  for i in range(3))
    theta0 = _initial_theta(ea, eb, eu)
    theta = _newton_solve(theta0, stats, cfg.q, cfg.r, iters)
    u, d = _survival_weights(cfg.q, stats.device)
    return tuple(float(_hessian_overflows(th, u, d, cfg.r).float().mean())
                 for th in (theta0, theta))


def estimate_from_pair_stats(stats: torch.Tensor, sz: torch.Tensor,
                             cfg: HLLConfig, method: str,
                             iters: int = NEWTON_ITERS,
                             impl: str = "cuda") -> torch.Tensor:
    """T̃(xy) per pair from fused pair statistics.

    ``sz`` is float32[B, 3, 2]: (s, z) of A, B and A ∪ B. ``method="mle"``
    runs Ertl's maximum-likelihood estimator seeded by
    inclusion-exclusion (its Newton steps by ``impl``); ``"ie"`` returns
    the Eq. 18 baseline.
    """
    ea = hll.estimate_from_stats(sz[:, 0, 0], sz[:, 0, 1], cfg)
    eb = hll.estimate_from_stats(sz[:, 1, 0], sz[:, 1, 1], cfg)
    eu = hll.estimate_from_stats(sz[:, 2, 0], sz[:, 2, 1], cfg)
    if method == "ie":
        return ea + eb - eu
    if method != "mle":
        raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
    return mle_from_stats(stats, ea, eb, eu, cfg, iters, impl)[2]
