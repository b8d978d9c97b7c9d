"""The intersection MLE's Newton tail: ``ops.intersection_newton``, its
plain version and the ``intersection_newton`` kernel.

On the CPU: the op and ``core.intersection._newton_solve`` send a CPU
tensor, and ``impl="ref"`` on any tensor, to the plain version and launch
nothing; the plain version equals the eager loop the port ran before the
kernel (kept below as it stood, ``_loop``) bit for bit; the wrapper's
checks; the launcher's signature; the planted singular system and NaN
step that the card tests give the kernel, as the plain version takes
them.

On the card (marked ``cuda``; each skips without one, decided inside the
fixture): the kernel against the plain version at p = 4-16, 1 to 2^18
pairs, 0, 1 and 50 steps, on byte and packed statistics. This file
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q --noconftest \\
        tests/test_torch_intersection_newton.py

Tolerances and why: the kernel sums each pair's bins in another order
than the plain version (a warp's shuffle tree against ``sum(-1)``) and
contracts products into fused multiply-adds, so one step agrees to float32
rounding of the gradient and Hessian, and 50 steps to where each pair's
ascent settles. Exact: 0 steps (theta0 comes back), the pairs the
overflow flag rejects (they keep theta0), the planted singular system and
the NaN step (both rejected). After 1 step: ``rtol=1e-5`` of theta's
largest entry (the step is at most 1.5, computed from sums with ~1e-7
relative rounding). After 50 steps: a pair's gap is the largest change of
a rate over the pair's union (``lambda_a + lambda_b + lambda_x`` of the
plain version), as the benchmark's pair check measures it; pairs whose
intersection is below the sketch's resolution (1.04 / sqrt(r) of the
union) sit on a flat likelihood where rounding moves the last iterate
far (the plain version on the CPU and on the card differ there too), so
the resolved pairs must agree to ``1e-5`` and all pairs but ``WIDE_SHARE``
of them to ``1e-3``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import intersection  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.kernels import _build, ops, packing  # noqa: E402
from repro_torch.kernels import intersection_newton as newton  # noqa: E402

#: after 50 steps, the share of all pairs whose gap may pass 1e-3
WIDE_SHARE = 0.005


# -------------------------------------------------- the loop before the kernel
# ``core/intersection.py`` as it stood before the kernel: the eager Newton
# loop and the derivatives it calls, unchanged (the span left out).
_TINY = 1e-38


def _survival_weights(q, device):
    ks = torch.arange(q + 2, dtype=torch.float32, device=device)
    u = torch.exp2(-ks)
    u[q + 1] = 0.0
    d = torch.cat([torch.ones(1, dtype=torch.float32, device=device),
                   torch.exp2(-ks[1:])])
    d[q + 1] = 2.0 ** (-q)
    return u, d


def _hessian_overflows(theta, u, d, r):
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


def _log_terms(y_raw, y1, y2, tiny):
    live = y_raw > tiny
    y = torch.maximum(y_raw, tiny)
    zero = torch.zeros_like(y)
    g = [torch.where(live, yi / y, zero) for yi in y1]
    h = {(i, j): torch.where(live, yij / y - g[i] * g[j], zero)
         for (i, j), yij in y2.items()}
    return g, h


def _grad_hess(theta, stats, u, d, r):
    t = torch.exp(theta) / r
    ta, tb, tx = (t[:, i:i + 1] for i in range(3))
    tiny = torch.full_like(d, _TINY)
    k0 = torch.zeros_like(d, dtype=torch.bool)
    k0[0] = True
    b = theta.shape[0]
    grad = torch.zeros((b, 3), dtype=theta.dtype, device=theta.device)
    hess = torch.zeros((b, 3, 3), dtype=theta.dtype, device=theta.device)

    def add(c, f1, f2, idx):
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


def _loop(theta0, stats, q, r, iters):
    u, d = _survival_weights(q, theta0.device)
    eye = torch.eye(3, dtype=theta0.dtype, device=theta0.device)
    theta = theta0
    for _ in range(iters):
        g, h = _grad_hess(theta, stats, u, d, r)
        h = torch.where(_hessian_overflows(theta, u, d, r)[:, None, None],
                        torch.full_like(h, float("nan")), h)
        mu = 1e-3 + 1e-3 * torch.diagonal(
            h, dim1=-2, dim2=-1).abs().amax(-1)
        a = mu[:, None, None] * eye - h
        delta = torch.linalg.solve_ex(a, g, check_errors=False)[0]
        delta = torch.clamp(delta, -1.5, 1.5)
        theta_new = theta + delta
        ok = torch.isfinite(theta_new).all(dim=-1, keepdim=True)
        theta = torch.where(ok, theta_new, theta)
    return theta


# ------------------------------------------------------------------- inputs
def _sketch(rng, lam, r, q):
    """Registers uint8[n, r] of n HLL sketches of lam[i] distinct keys
    (Poissonized: P(reg <= k) = exp(-lam / r * 2^-k), capped at q + 1)."""
    e = rng.standard_exponential((len(lam), r), dtype=np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # e = 0: tops out
        k = np.ceil(np.log2(np.maximum(lam[:, None] / r / e, 1e-30)))
    return np.where(lam[:, None] > 0, np.clip(k, 0, q + 1), 0).astype(np.uint8)


def _pair_inputs(seed, n_pairs, p, layout="byte", device="cpu", unique=None):
    """(theta0 float32[B, 3], stats float32[B, 5, q+2]) of B sketch pairs
    A = A\\B ∪ X, B = B\\A ∪ X, sizes log-uniform in [1, 2e5] and a fifth
    of the pairs with |X| = 0: the clipped inclusion-exclusion start as
    the engine takes it, and the Eq. 19 histograms of the layout's rows.
    ``unique`` pairs are drawn and repeated to B (a card test's 2^18
    pairs at p = 16 would take 32 GB of rows)."""
    rng = np.random.default_rng(seed)
    cfg = HLLConfig(p=p)
    m = n_pairs if unique is None else min(unique, n_pairs)
    lam = np.exp(rng.uniform(0.0, np.log(2e5), (3, m)))
    lam[2, rng.random(m) < 0.2] = 0.0
    ra, rb, rx = (_sketch(rng, lam[i], cfg.r, cfg.q) for i in range(3))
    a = torch.from_numpy(np.maximum(ra, rx)).to(device)
    b = torch.from_numpy(np.maximum(rb, rx)).to(device)
    if layout == "packed":
        a, b = packing.pack_rows(a), packing.pack_rows(b)
    ea, eb, eu = (ops.estimate(rows, cfg, layout=layout)
                  for rows in (a, b, packing.merge_rows(a, b, layout)))
    theta0 = intersection._initial_theta(ea, eb, eu)
    stats = ops.ertl_stats(a, b, cfg, layout=layout)
    if m < n_pairs:
        pick = torch.from_numpy(rng.integers(0, m, n_pairs)).to(device)
        theta0, stats = theta0[pick], stats[pick]
    return theta0.contiguous(), stats.contiguous()


def _flagged(theta, q, r):
    u, d = newton.survival_weights(q, theta.device)
    return newton.hessian_overflows(theta, u, d, r)


def _singular_plant(p, device):
    """theta0 [1, 3] and stats [1, 5, q+2] whose first Newton system is
    exactly singular: only c_eq at k = 0 is counted (-c), so H =
    diag(m, m, m) with m = -c t, t = exp(theta) / r the same for the three
    rates, and m is the float32 fixed point of mu = 1e-3 + 1e-3 m, so mu I
    - H = 0. The rate (about 4) keeps the overflow flag off."""
    q, r = 64 - p, 1 << p
    m = torch.tensor(1e-3, dtype=torch.float32, device=device)
    for _ in range(100):
        m = 1e-3 + 1e-3 * m
    assert bool(1e-3 + 1e-3 * m == m)
    theta0 = torch.log(torch.full((1, 3), 4.0 * r, device=device))
    t = torch.exp(theta0[0, 0]) / r
    c = -(m / t)
    for _ in range(64):  # the count whose product with t rounds to m
        prod = -c * t
        if bool(prod == m):
            break
        c = torch.nextafter(c, c + (prod - m) / t)
    assert bool(-c * t == m)
    stats = torch.zeros((1, 5, q + 2), dtype=torch.float32, device=device)
    stats[0, 4, 0] = c
    assert not bool(_flagged(theta0, q, r).any())
    return theta0, stats


def _nan_plant(p, device):
    """theta0 [2, 3] and stats of two pairs the overflow flag passes, the
    second with one NaN count: its gradient, Hessian and step are NaN,
    which a clamp that drops NaN (fminf / fmaxf) would turn into a step
    of +-1.5."""
    theta0, stats = _pair_inputs(3, 16, p, device=device)
    keep = torch.nonzero(~_flagged(theta0, 64 - p, 1 << p))[:2, 0]
    theta0, stats = theta0[keep].contiguous(), stats[keep].clone()
    stats[1, 2, 3] = float("nan")
    return theta0, stats


# ------------------------------------------------------------------ CPU tests
def test_cpu_and_ref_run_the_plain_version(monkeypatch):
    """A CPU tensor through the op (impl "cuda") and through
    ``_newton_solve``, and ``impl="ref"``, reach the plain version and
    never the launcher."""
    theta0, stats = _pair_inputs(0, 8, 8)
    calls = []
    real = newton.plain

    def spy(*args):
        calls.append(args[2:])
        return real(*args)

    def no_launch(*args):
        raise AssertionError("a CPU tensor reached the launcher")

    monkeypatch.setattr(newton, "plain", spy)
    monkeypatch.setattr(_build, "launch", no_launch)
    want = real(theta0, stats, 56, 256, 5)
    for impl in ("cuda", "ref"):
        got = ops.intersection_newton(theta0, stats, 56, 256, 5, impl=impl)
        assert torch.equal(got, want)
    got = intersection._newton_solve(theta0, stats, 56, 256, 5)
    assert torch.equal(got, want)
    got = intersection._newton_solve(theta0, stats, 56, 256, 5, impl="ref")
    assert torch.equal(got, want)
    assert calls == [(56, 256, 5)] * 4
    with pytest.raises(ValueError):
        ops.intersection_newton(theta0, stats, 56, 256, 5, impl="pallas")


@pytest.mark.parametrize("iters", [0, 1, 50])
@pytest.mark.parametrize("p", [4, 8, 12])
def test_plain_equals_the_loop_before_the_kernel(p, iters):
    """Bit for bit, on pairs the overflow flag rejects and pairs it does
    not."""
    theta0, stats = _pair_inputs(p, 96, p)
    q, r = 64 - p, 1 << p
    flags = _flagged(theta0, q, r)
    assert 0 < int(flags.sum()) < len(flags)
    got = newton.plain(theta0, stats, q, r, iters)
    want = _loop(theta0, stats, q, r, iters)
    assert torch.equal(got, want)
    assert torch.equal(got[flags], theta0[flags])
    if iters:
        assert not torch.equal(got[~flags], theta0[~flags])


def test_wrapper_rejects_bad_inputs():
    theta0, stats = _pair_inputs(1, 4, 8)
    q, r = 56, 256
    bad = [
        (theta0.double(), stats, q),                    # dtype
        (theta0, stats.double(), q),
        (theta0[:3], stats, q),                         # pair counts differ
        (theta0[:, :2].contiguous(), stats, q),         # shape
        (theta0, stats[:, :4].contiguous(), q),
        (theta0, stats, q + 1),                         # q + 2 bins differ
        (theta0, stats, 0),                             # q out of range
        (theta0[0], stats, q),
        (theta0.t().contiguous().t(), stats, q),        # not contiguous
        (theta0, stats.transpose(1, 2).contiguous().transpose(1, 2), q),
    ]
    assert not bad[-2][0].is_contiguous() and not bad[-1][1].is_contiguous()
    for th, st, qq in bad:
        with pytest.raises(ValueError):
            newton.intersection_newton(th, st, qq, r, 1)
    for rr, iters in ((0, 1), (r, -1)):
        with pytest.raises(ValueError):
            newton.intersection_newton(theta0, stats, q, rr, iters)
    big = torch.zeros((4, 5, 65), dtype=torch.float32)
    with pytest.raises(ValueError):  # q = 63: 65 bins, more than two a lane
        newton.intersection_newton(theta0, big, 63, 2, 1)


def test_kernel_table_has_the_launcher():
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert _build.KERNELS["intersection_newton"] == (p, p, p, i64, i32, i32,
                                                     i32, p)
    assert "intersection_newton" in _build.launch_counts()
    assert "intersection_newton" in ops.__all__


def test_plain_rejects_the_planted_singular_and_nan_steps():
    """The plants the card tests give the kernel, as the plain version
    takes them: the singular system and the NaN step keep theta0."""
    theta0, stats = _singular_plant(8, "cpu")
    u, d = newton.survival_weights(56, "cpu")
    g, h = newton.grad_hess(theta0, stats, u, d, 256)
    m = h[0, 0, 0]
    assert torch.equal(h[0], torch.diag(torch.stack([m, m, m])))
    assert bool((torch.isfinite(g) & (g != 0)).all())
    assert torch.equal(newton.plain(theta0, stats, 56, 256, 3), theta0)
    theta0, stats = _nan_plant(8, "cpu")
    got = newton.plain(theta0, stats, 56, 256, 3)
    assert torch.equal(got[1], theta0[1])
    assert not torch.equal(got[0], theta0[0])


# ------------------------------------------------------------- card tests
@pytest.fixture
def dev():
    """The card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run only on the card)")
    return torch.device("cuda")


def _launch(theta0, stats, q, r, iters):
    before = _build.launch_counts()["intersection_newton"]
    out = newton.intersection_newton(theta0, stats, q, r, iters)
    torch.cuda.synchronize()
    assert _build.launch_counts()["intersection_newton"] == before + 1
    return out


def _gaps(got, want):
    """Per pair: the largest change of a rate over the plain version's
    union, and the plain version's intersection over its union."""
    lg, lw = torch.exp(got.double()), torch.exp(want.double())
    union = lw.sum(-1)
    return (lg - lw).abs().amax(-1) / union, lw[:, 2] / union


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("iters", [0, 1, 50])
@pytest.mark.parametrize("n_pairs", [1, 31, 2016, 16384, 1 << 18])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_kernel_matches_plain(dev, p, n_pairs, iters, layout):
    q, r = 64 - p, 1 << p
    theta0, stats = _pair_inputs(p * 1000 + n_pairs, n_pairs, p, layout,
                                 dev, unique=2048 if p <= 12 else 256)
    got = _launch(theta0, stats, q, r, iters)
    want = newton.plain(theta0, stats, q, r, iters)
    flags = _flagged(theta0, q, r)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    assert torch.equal(got[flags], theta0[flags])  # rejected: kept exactly
    if iters == 0:
        assert torch.equal(got, theta0)
    elif iters == 1:
        scale = want.abs().amax(-1, keepdim=True)
        assert bool(((got - want).abs() <= 1e-5 * scale).all())
    else:
        gap, share = _gaps(got, want)
        resolved = share >= 1.04 / r ** 0.5
        assert not bool(resolved.any()) or float(gap[resolved].max()) <= 1e-5
        assert float((gap > 1e-3).double().mean()) <= WIDE_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("p", [4, 8, 16])
def test_kernel_rejects_a_singular_system(dev, p):
    q, r = 64 - p, 1 << p
    theta0, stats = _singular_plant(p, dev)
    assert torch.equal(newton.plain(theta0, stats, q, r, 3), theta0)
    assert torch.equal(_launch(theta0, stats, q, r, 3), theta0)


@pytest.mark.cuda
def test_kernel_rejects_a_nan_step(dev):
    theta0, stats = _nan_plant(8, dev)
    got = _launch(theta0, stats, 56, 256, 3)
    assert torch.equal(got[1], theta0[1])
    want = newton.plain(theta0, stats, 56, 256, 3)
    assert bool(((got[0] - want[0]).abs()
                 <= 1e-5 * want[0].abs().amax()).all())


@pytest.mark.cuda
def test_ref_on_the_card_launches_nothing(dev):
    theta0, stats = _pair_inputs(5, 64, 8, device=dev)
    before = _build.launch_counts()["intersection_newton"]
    got = ops.intersection_newton(theta0, stats, 56, 256, 10, impl="ref")
    assert _build.launch_counts()["intersection_newton"] == before
    assert torch.equal(got, newton.plain(theta0, stats, 56, 256, 10))
