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
``jax.hessian`` under ``vmap`` inside a ``lax.scan``; here they are
derived by hand (:func:`_grad_hess`) with the batch of pairs written out,
and the scan is a Python loop. ``torch.func`` on :func:`log_likelihood`
gives the same derivatives (the tests hold one against the other), but
its per-op dispatch made 50 iterations over 16,384 pairs take seconds on
the card.

float32 throughout. The ``1e-38`` floor under each ``log`` is subnormal
in float32; PyTorch keeps subnormals on the CPU and on the card (its
kernels are not built with flush-to-zero), so the floor stays non-zero.
"""
from __future__ import annotations

import torch

from repro_torch.core import hll
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels import ops, packing
from repro_torch.tracing import span

__all__ = ["ertl_stats", "log_likelihood", "mle_cardinalities",
           "mle_intersection", "inclusion_exclusion", "domination_flags",
           "mle_from_stats", "estimate_from_pair_stats",
           "hessian_overflow_share", "NEWTON_ITERS"]

#: Newton iterations when the caller passes none (``_NEWTON_ITERS`` in JAX)
NEWTON_ITERS = 50
_TINY = 1e-38


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


def _survival_weights(q: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """u_k = P(rho > k) and d_k = u_{k-1} - u_k for k in [0, q+1]."""
    ks = torch.arange(q + 2, dtype=torch.float32, device=device)
    u = torch.exp2(-ks)
    u[q + 1] = 0.0
    d = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                   torch.exp2(-ks[1:])])
    d[q + 1] = 2.0 ** (-q)
    return u, d


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


def _hessian_overflows(theta: torch.Tensor, u: torch.Tensor, d: torch.Tensor,
                       r: int) -> torch.Tensor:
    """Per pair: does the reference's float32 Hessian overflow at theta?

    ``jax.hessian`` runs forward-mode over the reverse pass, and the JVP
    of each log's cotangent ``g / y`` multiplies by ``y ** -2``, evaluated
    as ``1 / (y * y)``. XLA on the CPU and the TPU flushes subnormal
    results to zero, so where ``y * y`` is below float32's smallest normal
    (a rate below about 2 at the smallest ``d``) that factor is inf, the
    Hessian is non-finite (0 * inf in the empty histogram bins), and the
    finiteness guard rejects the Newton step. ``torch.func``
    differentiates division without the square and keeps subnormals, so
    it stays finite there; this flags the same pairs so that the port's
    iterates follow the reference's. theta [B, 3] -> bool[B].

    This is a defect of the reference kept for parity: a flagged pair
    keeps its iterate, so a pair whose initializer or iterate has a rate
    below about 2 never moves again (:func:`hessian_overflow_share`
    measures how many).
    """
    lam = torch.exp(theta)
    ta, tb, tx = (lam[:, i:i + 1] / r for i in range(3))
    tiny = torch.full_like(d, _TINY)
    args = [torch.maximum(-torch.expm1(-t * d), tiny)
            for t in (ta + tx, tb, ta, tb + tx)]
    tsum = ta + tb + tx
    bracket = (-torch.expm1(-(ta + tx) * d) * -torch.expm1(-(tb + tx) * d)
               + torch.exp(-tsum * d) * -torch.expm1(-tx * d))
    args.append(torch.maximum(bracket, tiny))
    y = torch.cat(args, dim=-1)
    return (y * y < torch.finfo(torch.float32).tiny).any(dim=-1)


def _log_terms(y_raw: torch.Tensor, y1: list, y2: dict, tiny: torch.Tensor):
    """First and second derivatives of ``log(max(y, tiny))`` from those of y.

    ``y1[i]`` is dy/dt_i and ``y2[(i, j)]`` d2y/dt_i dt_j (i <= j). Where
    y sits at the floor the derivative is 0, as ``jnp.maximum`` gives.
    """
    live = y_raw > tiny
    y = torch.maximum(y_raw, tiny)
    zero = torch.zeros_like(y)
    g = [torch.where(live, yi / y, zero) for yi in y1]
    h = {(i, j): torch.where(live, yij / y - g[i] * g[j], zero)
         for (i, j), yij in y2.items()}
    return g, h


def _grad_hess(theta: torch.Tensor, stats: torch.Tensor, u: torch.Tensor,
               d: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient [B, 3] and Hessian [B, 3, 3] of :func:`log_likelihood`.

    Derived by hand and batched over pairs. With ``t_i = exp(theta_i)/r``,
    a term ``L(t)`` contributes ``t_i dL/dt_i`` to the gradient and
    ``t_i t_j d2L/dt_i dt_j + [i == j] t_i dL/dt_i`` to the Hessian. The
    single-rate pmf ``log(1 - exp(-t d))`` and the equal-register pmf
    ``log(Ya Yb + W Yx)`` are differentiated in closed form; the k = 0
    entries are ``-t`` and ``-(ta + tb + tx)``.
    """
    t = torch.exp(theta) / r                                  # [B, 3]
    ta, tb, tx = (t[:, i:i + 1] for i in range(3))
    tiny = torch.full_like(d, _TINY)
    k0 = torch.zeros_like(d, dtype=torch.bool)
    k0[0] = True
    b = theta.shape[0]
    grad = torch.zeros((b, 3), dtype=theta.dtype, device=theta.device)
    hess = torch.zeros((b, 3, 3), dtype=theta.dtype, device=theta.device)

    def add(c, f1, f2, idx):
        """Fold sum_k c_k L'(s), L''(s) for s = sum of t over idx."""
        a1 = (c * f1).sum(-1)
        a2 = (c * f2).sum(-1)
        for i in idx:
            grad[:, i] += a1 * t[:, i]
            hess[:, i, i] += a1 * t[:, i]
            for j in idx:
                hess[:, i, j] += a2 * t[:, i] * t[:, j]

    for c, idx in ((stats[:, 0], (0, 2)), (stats[:, 3], (1,)),
                   (stats[:, 1], (0,)), (stats[:, 2], (1, 2))):
        s = sum(t[:, i:i + 1] for i in idx)
        w = torch.exp(-s * d)
        g, h = _log_terms(-torch.expm1(-s * d), [d * w], {(0, 0): -d * d * w},
                          tiny)
        f1 = torch.where(k0, -1.0, -u + g[0])
        f2 = torch.where(k0, 0.0, h[(0, 0)])
        add(c, f1, f2, idx)

    # equal registers: B = Ya Yb + W Yx over (ta, tb, tx)
    ea, eb, ex = (torch.exp(-z * d) for z in (ta + tx, tb + tx, tx))
    ya, yb, yx = (-torch.expm1(-z * d) for z in (ta + tx, tb + tx, tx))
    w = torch.exp(-(ta + tb + tx) * d)
    dd = d * d
    b1 = [d * ea * yb - d * w * yx,
          d * eb * ya - d * w * yx,
          d * ea * yb + d * eb * ya - d * w * yx + d * w * ex]
    cross = dd * ea * eb + dd * w * yx
    b2 = {(0, 0): -dd * ea * yb + dd * w * yx,
          (1, 1): -dd * eb * ya + dd * w * yx,
          (0, 1): cross,
          (0, 2): -dd * ea * yb + cross - dd * w * ex,
          (1, 2): -dd * eb * ya + cross - dd * w * ex,
          (2, 2): (-dd * ea * yb - dd * eb * ya + 2 * dd * ea * eb
                   + dd * w * yx - 3 * dd * w * ex)}
    g, h = _log_terms(ya * yb + w * yx, b1, b2, tiny)
    c = stats[:, 4]
    for i in range(3):
        a1 = (c * torch.where(k0, -1.0, -u + g[i])).sum(-1)
        grad[:, i] += a1 * t[:, i]
        hess[:, i, i] += a1 * t[:, i]
        for j in range(3):
            hij = h[(min(i, j), max(i, j))]
            a2 = (c * torch.where(k0, 0.0, hij)).sum(-1)
            hess[:, i, j] += a2 * t[:, i] * t[:, j]
    return grad, hess


def _newton_solve(theta0: torch.Tensor, stats: torch.Tensor, q: int, r: int,
                  iters: int) -> torch.Tensor:
    """Damped Newton ascent, batched over pairs: theta0 [B, 3] -> [B, 3]."""
    with span("intersection.newton"):
        u, d = _survival_weights(q, theta0.device)
        eye = torch.eye(3, dtype=theta0.dtype, device=theta0.device)
        theta = theta0
        for _ in range(iters):
            g, h = _grad_hess(theta, stats, u, d, r)
            h = torch.where(_hessian_overflows(theta, u, d, r)[:, None, None],
                            torch.full_like(h, float("nan")), h)
            # Maximization: solve (mu*I - H) delta = g; mu keeps it positive.
            mu = 1e-3 + 1e-3 * torch.diagonal(
                h, dim1=-2, dim2=-1).abs().amax(-1)
            a = mu[:, None, None] * eye - h
            # solve_ex: a singular system yields non-finite entries for that
            # pair (as jnp.linalg.solve does) instead of raising for the
            # batch
            delta = torch.linalg.solve_ex(a, g, check_errors=False)[0]
            delta = torch.clamp(delta, -1.5, 1.5)  # trust region in log space
            theta_new = theta + delta
            ok = torch.isfinite(theta_new).all(dim=-1, keepdim=True)
            theta = torch.where(ok, theta_new, theta)
        return theta


def mle_from_stats(stats: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor,
                   eu: torch.Tensor, cfg: HLLConfig,
                   iters: int = NEWTON_ITERS,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLE (|A\\B|, |B\\A|, |A ∩ B|) from Eq. 19 stats + HLL estimates.

    ``stats`` is float32[B, 5, q+2]; ``ea``/``eb``/``eu`` the per-pair
    |A| / |B| / |A ∪ B| estimates, used as the clipped
    inclusion-exclusion Newton initializer.
    """
    theta = _newton_solve(_initial_theta(ea, eb, eu), stats, cfg.q, cfg.r,
                          iters)
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
                          cfg, iters)


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
                             iters: int = NEWTON_ITERS) -> torch.Tensor:
    """T̃(xy) per pair from fused pair statistics.

    ``sz`` is float32[B, 3, 2]: (s, z) of A, B and A ∪ B. ``method="mle"``
    runs Ertl's maximum-likelihood estimator seeded by
    inclusion-exclusion; ``"ie"`` returns the Eq. 18 baseline.
    """
    ea = hll.estimate_from_stats(sz[:, 0, 0], sz[:, 0, 1], cfg)
    eb = hll.estimate_from_stats(sz[:, 1, 0], sz[:, 1, 1], cfg)
    eu = hll.estimate_from_stats(sz[:, 2, 0], sz[:, 2, 1], cfg)
    if method == "ie":
        return ea + eb - eu
    if method != "mle":
        raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
    return mle_from_stats(stats, ea, eb, eu, cfg, iters)[2]
