"""The damped Newton ascent of Ertl's intersection MLE.

Wrapper of ``csrc/intersection_newton.cu``, which has no Pallas
counterpart: the JAX package takes the gradient and 3x3 Hessian of
``repro.core.intersection.log_likelihood`` by ``jax.grad`` /
``jax.hessian`` under ``vmap`` inside a ``lax.scan``. From each pair's
start ``theta0`` (``log`` of the rates |A\\B|, |B\\A|, |A ∩ B|) and its
Eq. 19 histograms ``float32[B, 5, q+2]`` it runs ``iters`` damped Newton
steps and returns the final ``theta`` ``float32[B, 3]``, all steps of
every pair in one launch.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the eager loop: the gradient and Hessian derived by hand
(:func:`grad_hess`) with the batch of pairs written out, and the pairs
whose reference Hessian would overflow (:func:`hessian_overflows`)
keeping their iterate. The kernel sums over the bins in another order,
so the two agree to float32 rounding, not bit for bit.

float32 throughout. The ``1e-38`` floor under each ``log`` is subnormal
in float32; PyTorch keeps subnormals on the CPU and on the card (its
kernels are not built with flush-to-zero), and so does the kernel
library, so the floor stays non-zero.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["intersection_newton", "plain", "survival_weights", "grad_hess",
           "hessian_overflows", "TINY", "MAX_Q"]

#: the floor under each ``log`` of the likelihood
TINY = 1e-38
#: the largest q the kernel takes: q + 2 bins, two a lane of a warp
MAX_Q = 62


def survival_weights(q: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """u_k = P(rho > k) and d_k = u_{k-1} - u_k for k in [0, q+1]."""
    ks = torch.arange(q + 2, dtype=torch.float32, device=device)
    u = torch.exp2(-ks)
    u[q + 1] = 0.0
    d = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                   torch.exp2(-ks[1:])])
    d[q + 1] = 2.0 ** (-q)
    return u, d


def hessian_overflows(theta: torch.Tensor, u: torch.Tensor, d: torch.Tensor,
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
    below about 2 never moves again
    (``core.intersection.hessian_overflow_share`` measures how many).
    """
    lam = torch.exp(theta)
    ta, tb, tx = (lam[:, i:i + 1] / r for i in range(3))
    tiny = torch.full_like(d, TINY)
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


def grad_hess(theta: torch.Tensor, stats: torch.Tensor, u: torch.Tensor,
              d: torch.Tensor, r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient [B, 3] and Hessian [B, 3, 3] of the log-likelihood
    (``core.intersection.log_likelihood``).

    Derived by hand and batched over pairs. With ``t_i = exp(theta_i)/r``,
    a term ``L(t)`` contributes ``t_i dL/dt_i`` to the gradient and
    ``t_i t_j d2L/dt_i dt_j + [i == j] t_i dL/dt_i`` to the Hessian. The
    single-rate pmf ``log(1 - exp(-t d))`` and the equal-register pmf
    ``log(Ya Yb + W Yx)`` are differentiated in closed form; the k = 0
    entries are ``-t`` and ``-(ta + tb + tx)``.
    """
    t = torch.exp(theta) / r                                  # [B, 3]
    ta, tb, tx = (t[:, i:i + 1] for i in range(3))
    tiny = torch.full_like(d, TINY)
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


def plain(theta0: torch.Tensor, stats: torch.Tensor, q: int, r: int,
          iters: int) -> torch.Tensor:
    """Plain PyTorch version: the eager loop, batched over pairs.
    theta0 [B, 3] -> [B, 3]."""
    u, d = survival_weights(q, theta0.device)
    eye = torch.eye(3, dtype=theta0.dtype, device=theta0.device)
    theta = theta0
    for _ in range(iters):
        g, h = grad_hess(theta, stats, u, d, r)
        h = torch.where(hessian_overflows(theta, u, d, r)[:, None, None],
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


def intersection_newton(theta0: torch.Tensor, stats: torch.Tensor, q: int,
                        r: int, iters: int) -> torch.Tensor:
    """theta0: float32[B, 3] contiguous; stats: float32[B, 5, q+2]
    contiguous, on theta0's device -> float32[B, 3], theta after
    ``iters`` damped Newton steps (r registers a sketch)."""
    on_card = _build.check_device(stats, "stats")
    if not 1 <= q <= MAX_Q:
        raise ValueError(f"q must be in [1, {MAX_Q}], got {q}")
    if r < 1 or iters < 0:
        raise ValueError(f"r must be >= 1 and iters >= 0, got r={r}, "
                         f"iters={iters}")
    b = theta0.shape[0] if theta0.dim() == 2 else -1
    for name, t, shape in (("theta0", theta0, (b, 3)),
                           ("stats", stats, (b, 5, q + 2))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32"
                             f"{list(shape)} tensor, got {t.dtype}"
                             f"{list(t.shape)}")
    if theta0.device != stats.device:
        raise ValueError(f"theta0 is on {theta0.device}, stats on "
                         f"{stats.device}")
    if not on_card:
        return plain(theta0, stats, q, r, iters)
    theta = torch.empty_like(theta0)
    _build.launch("intersection_newton", stats.device, theta0.data_ptr(),
                  stats.data_ptr(), theta.data_ptr(), b, r, q, iters,
                  _build.stream_of(stats))
    return theta
