"""Port parity: the triangle path — the ``ertl_stats`` kernel's plain
version, the joint MLE on given rows (``mle_cardinalities``) and the
engine's ``triangle_heavy_hitters`` (Algorithms 4/5) — against the JAX
reference (``repro/kernels/ref.py``, the Pallas ``ertl_stats`` in
interpret mode, ``repro.core.intersection`` and engines with
``impl="ref"``).

Tolerances and why:

* Eq. 19 histograms exactly equal (integer counts);
* MLE cardinalities to ``1e-4`` of ``|x| + |A| + |B| + |A ∪ B|``, the
  scale ``tests/test_torch_engine.py`` holds intersections to: float32
  Newton iterates in another summation order, started from a difference
  of float32 estimates;
* triangle totals and top-k values to ``1e-4`` of the same scale summed
  over the edges they add up (a third of the sum for the total, half the
  incident edges' for a vertex); top-k ids are compared wherever the
  JAX values around a cut are further apart than twice that tolerance.

The JAX reference builds one-hot ``(block, r, q+2)`` panels, so the
engine cases stay at p <= 8; p = 12 is covered on a few pairs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jax_engine  # noqa: E402
from repro.core import degreesketch as jax_dsk  # noqa: E402
from repro.core import hashing as jax_hashing  # noqa: E402
from repro.core import intersection as jax_inter  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.graph import exact as jax_exact  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import degreesketch as dsk  # noqa: E402
from repro_torch.core import intersection  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import convert  # noqa: E402
from repro_torch.graph import exact, generators  # noqa: E402
from repro_torch.kernels import _build, ertl_stats  # noqa: E402

ITERS = 10
RTOL = 1e-4
CASES = [(8, 8, 0), (9, 8, 1), (9, 4, 2)]  # (rmat scale, p, seed)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes a plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _rows(rng, e, p, hi):
    return rng.integers(0, hi, (e, 1 << p)).astype(np.uint8)


@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("e", [1, 100, 300])
def test_ertl_stats_plain_matches_jax_ref(p, e):
    """Bytes up to 69 include values above q + 1, which count in no bin."""
    rng = np.random.default_rng(p * 31 + e)
    a, b = _rows(rng, e, p, 70), _rows(rng, e, p, 70)
    b[::4] = a[::4]  # equal rows: everything in c_eq
    q = 64 - p
    want = np.asarray(jax_ref.ertl_stats_ref(jnp.asarray(a), jnp.asarray(b),
                                             q))
    got = ertl_stats.ertl_stats(torch.from_numpy(a), torch.from_numpy(b), q)
    assert got.shape == (e, 5, q + 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [6, 8])
def test_ertl_stats_matches_jax_pallas_interpret(p):
    """The Pallas kernel itself, run in interpret mode (it still runs on
    this JAX), on a ragged pair count it pads internally."""
    rng = np.random.default_rng(p)
    a, b = _rows(rng, 150, p, 66), _rows(rng, 150, p, 66)
    cfg = JaxConfig(p=p)
    want = np.asarray(jax_ops.ertl_stats(jnp.asarray(a), jnp.asarray(b), cfg,
                                         impl="pallas"))
    got = intersection.ertl_stats(torch.from_numpy(a), torch.from_numpy(b),
                                  HLLConfig(p=p))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_inter.ertl_stats(jnp.asarray(a), jnp.asarray(b), cfg)))


def test_ertl_plain_chunks_agree(monkeypatch):
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(_rows(rng, 70, 6, 20)) for _ in range(2))
    whole = ertl_stats.plain(a, b, 58)
    monkeypatch.setattr(ref, "PAIR_CHUNK", 16)
    assert torch.equal(ertl_stats.plain(a, b, 58), whole)


def test_ertl_wrapper_checks_inputs():
    a = torch.zeros((4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ertl_stats.ertl_stats(a, a[:3], 60)
    with pytest.raises(ValueError):
        ertl_stats.ertl_stats(a, torch.zeros((4, 32), dtype=torch.uint8), 60)
    with pytest.raises(ValueError):
        ertl_stats.ertl_stats(a, a, 0)
    narrow = torch.zeros((4, 4), dtype=torch.uint8)  # packed r=8 < 16
    with pytest.raises(ValueError, match="packed"):
        ertl_stats.ertl_stats(narrow, narrow, 60, layout="packed")


def _sketch_rows(p, seed, n_sets=40, n_pairs=48):
    """Register rows of random overlapping key sets (the JAX hash), paired."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(p=p)
    sizes = rng.integers(1, 3000, n_sets)
    keys = rng.integers(0, 5000, sizes.sum()).astype(np.uint32)
    owner = np.repeat(np.arange(n_sets), sizes)
    bucket, rho = (np.asarray(x) for x in
                   jax_hashing.bucket_rho(keys, cfg.p, cfg.seed))
    regs = np.zeros((n_sets, cfg.r), np.uint8)
    np.maximum.at(regs, (owner, bucket), rho)
    pa = rng.integers(0, n_sets, n_pairs)
    pb = rng.integers(0, n_sets, n_pairs)
    return regs[pa], regs[pb], cfg


@pytest.mark.parametrize("p,seed", [(8, 0), (10, 1), (12, 2)])
def test_mle_cardinalities_match_jax(p, seed):
    a, b, jcfg = _sketch_rows(p, seed)
    want = [np.asarray(x) for x in jax_inter.mle_cardinalities(
        jnp.asarray(a), jnp.asarray(b), jcfg, ITERS)]
    got = [x.numpy() for x in intersection.mle_cardinalities(
        torch.from_numpy(a), torch.from_numpy(b), HLLConfig(p=p), ITERS)]
    ea, eb, eu = (np.asarray(jax_ops.estimate(jnp.asarray(x), jcfg,
                                              impl="ref"))
                  for x in (a, b, np.maximum(a, b)))
    scale = ea + eb + eu
    for g, w in zip(got, want):
        assert np.all(np.abs(g - w) <= RTOL * (np.abs(w) + scale))
    inter = intersection.mle_intersection(torch.from_numpy(a),
                                          torch.from_numpy(b), HLLConfig(p=p),
                                          ITERS)
    np.testing.assert_array_equal(inter.numpy(), got[2])


def test_degree_sketch_intersection_matches_jax():
    edges, n = generators.rmat(8, 8, seed=6), 1 << 8
    ref = jax_engine.build(edges, n, JaxConfig(p=8), impl="ref",
                           layout="byte", backend="local")
    regs = np.array(ref.regs)
    jsk = jax_dsk.DegreeSketch(regs=jnp.asarray(regs), n=n, cfg=ref.cfg)
    sk = dsk.DegreeSketch(regs=torch.from_numpy(regs), n=n, cfg=HLLConfig(p=8))
    deg = np.asarray(ref.degrees())
    for x, y in edges[:4]:
        want = float(jsk.intersection_size(int(x), int(y)))
        scale = deg[x] + deg[y] + float(ref.union_size(np.array([x, y])))
        got = float(sk.intersection_size(int(x), int(y)))
        assert abs(got - want) <= RTOL * (abs(want) + scale)


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"rmat{c[0]}-p{c[1]}")
def pair(request):
    """(JAX reference engine, port engine on the CPU from its numpy state,
    edges, n, per-edge JAX estimates, per-edge tolerance)."""
    scale, p, seed = request.param
    edges, n = generators.rmat(scale, 8, seed=seed), 1 << scale
    ref = jax_engine.build(edges, n, JaxConfig(p=p), impl="ref",
                           layout="byte", backend="local")
    cfg = ref.cfg
    port = convert.from_numpy_state(
        np.asarray(ref.regs), n,
        {"p": cfg.p, "seed": cfg.seed, "estimator": cfg.estimator}, edges,
        device="cpu")
    sketch = jax_dsk.DegreeSketch(regs=ref.regs, n=n, cfg=cfg)
    est = jax_dsk.edge_triangle_estimates(sketch, edges, iters=ITERS)
    deg = np.asarray(ref.degrees())
    union = np.asarray(ref.union_size([list(e) for e in edges]))
    tol = RTOL * (np.abs(est) + deg[edges[:, 0]] + deg[edges[:, 1]] + union)
    return ref, port, edges, n, est, tol


def test_edge_estimates_match_jax(pair):
    _, port, edges, n, want, tol = pair
    sketch = dsk.DegreeSketch(regs=port.regs, n=n, cfg=port.cfg)
    got = dsk.edge_triangle_estimates(sketch, edges, block=997, iters=ITERS)
    assert got.dtype == np.float64 and got.shape == (len(edges),)
    assert np.all(np.abs(got - want) <= tol)
    whole = dsk.edge_triangle_estimates(sketch, edges, iters=ITERS)
    np.testing.assert_array_equal(got, whole)  # blocks are independent


def _check_top(got_vals, got_ids, want_vals, want_ids, atol):
    """Values within atol; id sets equal at every well-separated cut."""
    assert np.all(np.diff(got_vals) <= 0)
    np.testing.assert_allclose(got_vals, want_vals, rtol=0, atol=atol)
    key = [tuple(np.atleast_1d(i)) for i in got_ids]
    want_key = [tuple(np.atleast_1d(i)) for i in want_ids]
    for j in range(1, len(want_vals)):
        if want_vals[j - 1] - want_vals[j] > 2 * atol:
            assert set(key[:j]) == set(want_key[:j])


@pytest.mark.parametrize("k", [1, 20])
def test_edge_heavy_hitters_match_jax(pair, k):
    ref, port, edges, _, est, tol = pair
    total, vals, top = port.triangle_heavy_hitters(k, iters=ITERS)
    w_total, w_vals, w_top = ref.triangle_heavy_hitters(k, iters=ITERS)
    assert abs(total - w_total) <= tol.sum() / 3
    assert vals.shape == (k,) and top.shape == (k, 2)
    _check_top(vals, top, w_vals, w_top, tol.max())
    real = {tuple(e) for e in edges}
    assert all(tuple(e) in real for e in top)


@pytest.mark.parametrize("k", [1, 20])
def test_vertex_heavy_hitters_match_jax(pair, k):
    ref, port, edges, n, est, tol = pair
    total, vals, top = port.triangle_heavy_hitters(k, mode="vertex",
                                                   iters=ITERS)
    w_total, w_vals, w_top = ref.triangle_heavy_hitters(k, mode="vertex",
                                                        iters=ITERS)
    assert abs(total - w_total) <= tol.sum() / 3
    vtol = np.zeros(n)
    np.add.at(vtol, edges[:, 0], tol)
    np.add.at(vtol, edges[:, 1], tol)
    _check_top(vals, top, w_vals, w_top, vtol.max() / 2)
    assert top.dtype.kind == "i" and (top < n).all()


def test_k_beyond_counts_returns_only_real_ids(pair):
    _, port, edges, n, *_ = pair
    total, vals, top = port.triangle_heavy_hitters(10 * len(edges),
                                                   iters=ITERS)
    assert len(vals) == len(top) == len(edges)
    assert {tuple(e) for e in top} == {tuple(e) for e in edges}
    _, vvals, vtop = port.triangle_heavy_hitters(10 * n, mode="vertex",
                                                 iters=ITERS)
    assert len(vvals) == n and sorted(vtop.tolist()) == list(range(n))
    assert np.isfinite(vals).all() and total > 0


def test_triangles_need_edges_and_a_mode():
    edges, n = generators.rmat(8, 8, seed=0), 1 << 8
    eng = convert.from_numpy_state(
        np.zeros((n, 64), np.uint8), n,
        {"p": 6, "seed": 0, "estimator": "flajolet"}, None, device="cpu")
    with pytest.raises(ValueError, match="without edges"):
        eng.triangle_heavy_hitters(5)
    full = convert.from_numpy_state(
        np.zeros((n, 64), np.uint8), n,
        {"p": 6, "seed": 0, "estimator": "flajolet"}, edges, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        full.triangle_heavy_hitters(5, mode="global")


def test_exact_triangles_match_jax():
    edges, n = generators.rmat(8, 8, seed=2), 1 << 8
    per_edge = exact.exact_edge_triangles(n, edges)
    np.testing.assert_array_equal(per_edge,
                                  jax_exact.exact_edge_triangles(n, edges))
    np.testing.assert_array_equal(exact.exact_vertex_triangles(n, edges),
                                  jax_exact.exact_vertex_triangles(n, edges))
    assert (exact.exact_global_triangles(n, edges)
            == jax_exact.exact_global_triangles(n, edges) > 0)
    adj, want = (exact.adjacency_lists(n, edges),
                 jax_exact.adjacency_lists(n, edges))
    assert all(np.array_equal(x, y) for x, y in zip(adj, want))
