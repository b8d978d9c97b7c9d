"""Ertl's maximum-likelihood intersection estimate of two HLL sketches
(Ertl 2017; the paper's T̃(xy), Algorithms 4/5), written plainly.

Under Poissonization a register exposed to rate t has P(K <= k) =
exp(-t u_k), u_k = 2^-k (u_{q+1} = 0). Split two sketches A and B into
the disjoint rates (|A\\B|, |B\\A|, |A ∩ B|); the log-likelihood of a
pair depends on its registers only through five count histograms over
register values (Eq. 19): A's registers below B's, above B's, B's below
A's, above A's, and equal registers. The estimate maximizes it over
theta = log(lambda) by a damped Newton ascent of fixed length, started
from the clipped inclusion-exclusion estimate, with the gradient and
Hessian taken by ``torch.func``.

The estimator's stated semantics are kept: float32 throughout, a floor
of 1e-38 under each log, the damping ``mu = 1e-3 + 1e-3 max|H_ii|``, a
trust region of 1.5 in log space, a step kept only when finite, and a
step rejected when the Hessian's second-order factor ``y^-2`` of some
log argument ``y`` leaves float32's normal range (``y * y`` below the
smallest normal), which leaves a pair whose rate falls below about 2 at
its iterate. ``dtype`` runs the same arithmetic in another precision.
"""
from __future__ import annotations

import torch
from torch.func import grad, hessian, vmap

from sketchbench.reference.sketch import flajolet, row_stats

TINY = 1e-38
#: a pair has settled when its last Newton step moved theta by less
#: than this in log space
SETTLED = 1e-3


def histograms(a: torch.Tensor, b: torch.Tensor, q: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Eq. 19 histograms [B, 5, q+2] of register rows a, b uint8[B, r]:
    (A < B by A's value, A > B by A's value, B < A by B's value,
    B > A by B's value, A = B)."""
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    out = torch.zeros((a.shape[0], 5, q + 2), dtype=torch.float32,
                      device=a.device)
    lt, gt, eq = (a64 < b64), (a64 > b64), (a64 == b64)
    for i, (vals, hit) in enumerate(((a64, lt), (a64, gt), (b64, gt),
                                     (b64, lt), (a64, eq))):
        out[:, i].scatter_add_(1, vals, hit.to(torch.float32))
    return out.to(dtype)


def _weights(q: int, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    ks = torch.arange(q + 2, dtype=dtype, device=device)
    u = torch.exp2(-ks)
    u[q + 1] = 0.0
    d = torch.exp2(-ks)
    d[0] = 1.0
    d[q + 1] = 2.0 ** (-q)
    return u, d


def _log_pmf(t, u, d):
    body = -t * u + torch.log(torch.clamp(-torch.expm1(-t * d), min=TINY))
    return torch.cat([(-t).reshape(1), body[1:]])


def _log_pmf_eq(ta, tb, tx, u, d):
    tsum = ta + tb + tx
    both = (-torch.expm1(-(ta + tx) * d) * -torch.expm1(-(tb + tx) * d)
            + torch.exp(-tsum * d) * -torch.expm1(-tx * d))
    body = -tsum * u + torch.log(torch.clamp(both, min=TINY))
    return torch.cat([(-tsum).reshape(1), body[1:]])


def log_likelihood(theta, stats, u, d, r: int):
    """Log-likelihood of one pair's histograms [5, q+2] at theta [3]."""
    lam = torch.exp(theta)
    ta, tb, tx = lam[0] / r, lam[1] / r, lam[2] / r
    return ((stats[0] * _log_pmf(ta + tx, u, d)).sum()
            + (stats[1] * _log_pmf(ta, u, d)).sum()
            + (stats[2] * _log_pmf(tb + tx, u, d)).sum()
            + (stats[3] * _log_pmf(tb, u, d)).sum()
            + (stats[4] * _log_pmf_eq(ta, tb, tx, u, d)).sum())


def _overflows(theta, u, d, r: int) -> torch.Tensor:
    """Per pair: does some log argument y have y * y below the smallest
    normal of the dtype at theta?"""
    lam = torch.exp(theta)
    ta, tb, tx = (lam[:, i:i + 1] / r for i in range(3))
    args = [torch.clamp(-torch.expm1(-t * d), min=TINY)
            for t in (ta + tx, tb, ta, tb + tx)]
    both = (-torch.expm1(-(ta + tx) * d) * -torch.expm1(-(tb + tx) * d)
            + torch.exp(-(ta + tb + tx) * d) * -torch.expm1(-tx * d))
    args.append(torch.clamp(both, min=TINY))
    y = torch.cat(args, dim=-1)
    return (y * y < torch.finfo(theta.dtype).tiny).any(dim=-1)


def _solve3(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x with a x = g for a [B, 3, 3], g [B, 3], by Cramer's rule (no
    pivoting: a singular system gives non-finite entries)."""
    c0 = torch.linalg.cross(a[:, 1], a[:, 2])
    c1 = torch.linalg.cross(a[:, 2], a[:, 0])
    c2 = torch.linalg.cross(a[:, 0], a[:, 1])
    det = (a[:, 0] * c0).sum(-1)
    adj_t = torch.stack([c0, c1, c2], dim=-1)   # inverse = adj_t / det
    return (adj_t @ g[:, :, None])[:, :, 0] / det[:, None]


def newton(theta: torch.Tensor, stats: torch.Tensor, q: int, r: int,
           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped Newton ascent of the log-likelihood: theta [B, 3], and per
    pair whether it settled (its last step finite and under ``SETTLED``
    in log space, and no log argument out of the normal range at its last
    iterate)."""
    u, d = _weights(q, theta.dtype, theta.device)
    g_fn = vmap(grad(log_likelihood), in_dims=(0, 0, None, None, None))
    h_fn = vmap(hessian(log_likelihood), in_dims=(0, 0, None, None, None))
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    step = torch.full_like(theta[:, 0], float("inf"))
    for _ in range(iters):
        g = g_fn(theta, stats, u, d, r)
        h = h_fn(theta, stats, u, d, r)
        h = torch.where(_overflows(theta, u, d, r)[:, None, None],
                        torch.full_like(h, float("nan")), h)
        mu = 1e-3 + 1e-3 * torch.diagonal(h, dim1=-2, dim2=-1).abs().amax(-1)
        delta = torch.clamp(_solve3(mu[:, None, None] * eye - h, g), -1.5, 1.5)
        new = theta + delta
        ok = torch.isfinite(new).all(-1)
        theta = torch.where(ok[:, None], new, theta)
        step = torch.where(ok, delta.abs().amax(-1),
                           torch.full_like(step, float("inf")))
    return theta, (step < SETTLED) & ~_overflows(theta, u, d, r)


def intersection(a: torch.Tensor, b: torch.Tensor, q: int, iters: int,
                 dtype: torch.dtype = torch.float32,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T̃ = the MLE of |A ∩ B|, the estimate of |A ∪ B|, whether the
    ascent settled) for register rows a, b uint8[B, r], in ``dtype``."""
    r = a.shape[1]
    ea, eb, eu = (flajolet(*row_stats(x, dtype), r)
                  for x in (a, b, torch.maximum(a, b)))
    x0 = torch.clamp(ea + eb - eu, min=1.0)
    theta0 = torch.log(torch.stack([torch.clamp(ea - x0, min=1.0),
                                    torch.clamp(eb - x0, min=1.0), x0], -1))
    theta, settled = newton(theta0, histograms(a, b, q, dtype), q, r, iters)
    return torch.exp(theta[:, 2]), eu, settled
