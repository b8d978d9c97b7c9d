"""Port parity: the intersection estimator tail (``core.intersection``).

The same numpy ``(stats, sz)`` go through
``repro.core.intersection.estimate_from_pair_stats`` and the port's.
Tolerances and why:

* ``"ie"``: ``rtol=1e-5`` of the three estimates the difference is taken
  from, ``|ea| + |eb| + |eu|``. Each estimate matches to a few float32
  ulps, and ``ea + eb - eu`` keeps their absolute rounding error, so
  measured against a near-zero difference alone it would be unbounded.
* ``"mle"``: ``rtol=1e-4`` of the value alone, the tolerance
  ``tests/test_intersection.py:58`` uses: float32 Newton iterates in
  another summation order, started from that inclusion-exclusion point
  (measured worst on the CPU: 3.2e-5, p=8 seed 0).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jax_hashing  # noqa: E402
from repro.core import hll as jax_hll  # noqa: E402
from repro.core import intersection as jax_inter  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import hll, intersection  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402


def _pair_stats(p: int, seed: int, n_sets: int = 48, n_pairs: int = 64):
    """Eq. 19 stats of random overlapping sketches, via the JAX reference.

    Set i holds a random number of keys drawn from [0, 4000), so pairs
    range from disjoint-looking to heavily overlapping.
    """
    rng = np.random.default_rng(seed)
    cfg = jax_hll.HLLConfig(p=p)
    sizes = rng.integers(1, 2500, n_sets)
    keys = rng.integers(0, 4000, sizes.sum()).astype(np.uint32)
    owner = np.repeat(np.arange(n_sets), sizes)
    bucket, rho = (np.asarray(x) for x in
                   jax_hashing.bucket_rho(keys, cfg.p, cfg.seed))
    regs = np.zeros((n_sets, cfg.r), np.uint8)
    np.maximum.at(regs, (owner, bucket), rho)
    pa = rng.integers(0, n_sets, n_pairs).astype(np.int32)
    pb = rng.integers(0, n_sets, n_pairs).astype(np.int32)
    stats, sz = jax_ref.intersection_stats_ref(jnp.asarray(regs), pa, pb,
                                               cfg.q)
    return np.array(stats), np.array(sz), cfg


#: the JAX tail, compiled once per (cfg, method, iters)
_jax_tail = jax.jit(jax_inter.estimate_from_pair_stats,
                    static_argnames=("cfg", "method", "iters"))


def _scale(sz, cfg):
    est = np.asarray(jax_hll.estimate_from_stats(sz[..., 0], sz[..., 1], cfg))
    return np.abs(est).sum(axis=1)


@pytest.mark.parametrize("p,seed", [(8, 0), (8, 1), (10, 2)])
@pytest.mark.parametrize("method,rtol,iters", [
    ("ie", 1e-5, 10), ("mle", 1e-4, 3), ("mle", 1e-4, 10)])
def test_estimate_from_pair_stats_matches_jax(p, seed, method, rtol, iters):
    stats, sz, jcfg = _pair_stats(p, seed)
    want = np.asarray(_jax_tail(stats, sz, cfg=jcfg, method=method,
                                iters=iters))
    got = intersection.estimate_from_pair_stats(
        torch.from_numpy(stats), torch.from_numpy(sz), HLLConfig(p=p), method,
        iters=iters).numpy()
    scale = _scale(sz, jcfg) if method == "ie" else 0.0
    bound = rtol * (np.abs(want) + scale)
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want) / bound)


def test_log_likelihood_grad_and_hessian_match_jax():
    stats, _, jcfg = _pair_stats(8, 3, n_pairs=4)
    theta = np.array([3.0, 4.5, 2.0], np.float32)
    u, d = intersection._survival_weights(jcfg.q, "cpu")
    args = (torch.from_numpy(theta), torch.from_numpy(stats[0]), u, d, jcfg.r)
    jargs = (jnp.asarray(theta), jnp.asarray(stats[0]), jcfg.q, jcfg.r)
    jit = functools.partial(jax.jit, static_argnums=(2, 3))
    np.testing.assert_allclose(
        float(intersection.log_likelihood(*args)),
        float(jax_inter.log_likelihood(*jargs)), rtol=1e-6)
    np.testing.assert_allclose(
        torch.func.grad(intersection.log_likelihood)(*args).numpy(),
        np.asarray(jit(jax.grad(jax_inter.log_likelihood))(*jargs)),
        rtol=1e-5)
    np.testing.assert_allclose(
        torch.func.hessian(intersection.log_likelihood)(*args).numpy(),
        np.asarray(jit(jax.hessian(jax_inter.log_likelihood))(*jargs)),
        rtol=1e-4)


def test_survival_weights_match_jax():
    """The port's weights are exact powers of two; XLA's CPU ``exp2`` is
    approximate (about 1e-6 relative), hence the tolerance."""
    u_j, d_j = jax_inter._survival_weights(56)
    u, d = intersection._survival_weights(56, "cpu")
    ks = np.arange(58)
    np.testing.assert_array_equal(u.numpy()[:57], 2.0 ** -ks[:57])
    assert u[57] == 0 and d[0] == 1 and d[57] == 2.0 ** -56
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-5)


def test_hessian_overflow_flags_rates_below_two():
    """A rate under ~2 at the smallest d is where the reference's float32
    Hessian overflows; clearly larger rates never flag."""
    u, d = intersection._survival_weights(56, "cpu")
    theta = torch.log(torch.tensor([[100.0, 100.0, 1.0],
                                    [100.0, 100.0, 50.0],
                                    [1.5, 300.0, 40.0]]))
    flags = intersection._hessian_overflows(theta, u, d, 256)
    assert flags.tolist() == [True, False, True]


def test_hessian_overflow_share_counts_flagged_pairs():
    """The share is that of pairs flagged at the inclusion-exclusion
    initializer and at the MLE's final iterate."""
    stats, sz, _ = _pair_stats(8, 0)
    cfg = HLLConfig(p=8)
    st, s = torch.from_numpy(stats), torch.from_numpy(sz)
    start, end = intersection.hessian_overflow_share(st, s, cfg, iters=10)
    u, d = intersection._survival_weights(cfg.q, "cpu")
    ea, eb, eu = (hll.estimate_from_stats(s[:, i, 0], s[:, i, 1], cfg)
                  for i in range(3))
    lam = torch.stack(intersection.mle_from_stats(st, ea, eb, eu, cfg, 10),
                      dim=-1)
    for share, theta in ((start, intersection._initial_theta(ea, eb, eu)),
                         (end, torch.log(lam))):
        flags = intersection._hessian_overflows(theta, u, d, cfg.r)
        assert share == pytest.approx(float(flags.float().mean()))
    assert 0 < start < 1 and 0 < end < 1


def test_unknown_method_raises():
    stats, sz, _ = _pair_stats(8, 0, n_pairs=2)
    with pytest.raises(ValueError):
        intersection.estimate_from_pair_stats(
            torch.from_numpy(stats), torch.from_numpy(sz), HLLConfig(p=8),
            "exact")


def test_hand_derived_derivatives_match_torch_func():
    """``_grad_hess`` against ``torch.func`` on ``log_likelihood``, to 1e-5
    of each pair's largest entry (float32, other evaluation order)."""
    from torch.func import grad, hessian, vmap
    rng = np.random.default_rng(11)
    stats = torch.from_numpy(rng.integers(0, 6, (64, 5, 58)).astype(np.float32))
    theta = torch.from_numpy(
        np.log(rng.uniform(0.5, 3000, (64, 3))).astype(np.float32))
    u, d = intersection._survival_weights(56, "cpu")
    dims = (0, 0, None, None, None)
    g_ref = vmap(grad(intersection.log_likelihood), in_dims=dims)(
        theta, stats, u, d, 256)
    h_ref = vmap(hessian(intersection.log_likelihood), in_dims=dims)(
        theta, stats, u, d, 256)
    g, h = intersection._grad_hess(theta, stats, u, d, 256)
    g_scale = g_ref.abs().amax(1, keepdim=True)
    h_scale = h_ref.abs().amax((1, 2), keepdim=True)
    assert bool(((g - g_ref).abs() <= 1e-5 * g_scale).all())
    assert bool(((h - h_ref).abs() <= 1e-5 * h_scale).all())
