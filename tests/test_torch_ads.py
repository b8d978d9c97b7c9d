"""Port parity: the ADS family (batch-HIP distance queries) on the CPU.

The port's ``hip_delta`` plain version, its curve functions and its ADS
engine against the JAX reference (``impl="ref"``, byte layout, local
backend) on the same numpy inputs. Tolerances and why:

* registers byte-identical (the HLL accumulate of the same hash);
* ``hip_delta`` to ``rtol=1e-6`` plus the reference's own ``exp2`` error:
  the port sums exact powers of two and rounds once, while the reference
  takes ``jnp.exp2`` of a float32, which XLA's CPU backend gets wrong by
  up to about 2e-6 of the value for integer arguments of 13 and more
  (measured by ``_jax_exp2_error``). Where every register is below 13 the
  reference's powers are exact and ``1e-6`` holds alone;
* the numpy curve functions exactly equal (the same float64 code);
* ``degrees``, ``neighborhood``, ``distance_histogram``, ``closeness`` to
  ``rtol=1e-5`` (float32 row estimates summed in another order), the
  effective diameter to ``1e-6`` hops;
* accuracy against the exact BFS ball sizes within the bounds of
  ``tests/test_ads.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jax_engine  # noqa: E402
from repro.core import ads as jax_ads  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import ads  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import convert  # noqa: E402
from repro_torch.engine.base import UnsupportedQuery  # noqa: E402
from repro_torch.graph import exact, generators  # noqa: E402
from repro_torch.kernels import _build, ops, ref, registry  # noqa: E402

T_MAX = 3
CASES = [(8, 8, 5), (9, 6, 1)]  # (rmat scale, p, seed)


def _jax_exp2_error(k_max: int) -> float:
    """Largest relative error of the reference's float32 ``jnp.exp2`` over
    the integers 0..k_max."""
    k = np.arange(k_max + 1, dtype=np.float32)
    got = np.asarray(jnp.exp2(k), np.float64)
    return float(np.max(np.abs(got / np.exp2(k.astype(np.float64)) - 1.0)))


def _hop_pair(rng, v, p, hi):
    """(prev, cur) uint8[v, 2^p] with registers in [0, hi]: lanes that
    grew, stayed and fell."""
    prev = rng.integers(0, hi + 1, (v, 1 << p))
    step = rng.integers(-3, 4, (v, 1 << p))
    cur = np.clip(prev + step, 0, hi)
    return prev.astype(np.uint8), cur.astype(np.uint8)


def _exact_rows(prev, cur):
    """float32 of the exact integer sum, rounded as the port rounds it."""
    out = []
    for a, b in zip(prev.astype(int), cur.astype(int)):
        out.append(np.float32(float(sum(1 << x for x, y in zip(a, b)
                                        if y > x))))
    return np.array(out, np.float32)


# ------------------------------------------------------- hip_delta math
@pytest.mark.parametrize("p", [4, 8, 12])
def test_hip_delta_ref_matches_jax(p):
    rng = np.random.default_rng(p)
    top = ADSConfig(p=p).max_register
    prev, cur = _hop_pair(rng, 97, p, top)
    got = ref.hip_delta_ref(torch.from_numpy(prev), torch.from_numpy(cur))
    assert got.dtype == torch.float32 and got.shape == (97,)
    rtol = 1e-6 + _jax_exp2_error(top)
    for want in (jax_ref.hip_delta_ref(prev, cur),
                 jax_ads.hip_delta(prev, cur)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                                   atol=0)
    core = ads.hip_delta(torch.from_numpy(prev), torch.from_numpy(cur))
    assert torch.equal(core, got)


@pytest.mark.parametrize("p", [4, 8, 12])
def test_hip_delta_ref_matches_jax_below_exp2_error(p):
    """Registers below 13, where the reference's powers are exact."""
    rng = np.random.default_rng(p + 100)
    prev, cur = _hop_pair(rng, 97, p, 12)
    assert _jax_exp2_error(12) == 0.0
    got = ref.hip_delta_ref(torch.from_numpy(prev), torch.from_numpy(cur))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_ref.hip_delta_ref(prev, cur)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [3, 8, 16])
def test_hip_delta_ref_is_the_exact_sum_rounded_once(p):
    rng = np.random.default_rng(p + 7)
    prev, cur = _hop_pair(rng, 9, p, ADSConfig(p=p).max_register)
    got = ref.hip_delta_ref(torch.from_numpy(prev), torch.from_numpy(cur))
    np.testing.assert_array_equal(got.numpy(), _exact_rows(prev, cur))


def test_hip_delta_matches_definition():
    """Register j rising x -> y contributes 2^x; a fallen one nothing
    (the case of ``tests/test_ads.py``)."""
    prev = np.array([[0, 3, 7], [2, 2, 2]], np.uint8)
    cur = np.array([[1, 3, 9], [2, 5, 1]], np.uint8)
    want = [2 ** 0 + 2 ** 7, 2 ** 2]
    assert np.asarray(jax_ads.hip_delta(prev, cur)).tolist() == want
    got = ads.hip_delta(torch.from_numpy(prev), torch.from_numpy(cur))
    assert got.tolist() == want
    # the wrapper's rows are 8 wide at least: pad with unchanged lanes
    wide = [np.pad(x, ((0, 0), (0, 5))) for x in (prev, cur)]
    assert ops.hip_delta(*map(torch.from_numpy, wide)).tolist() == want
    deep = [np.stack([x, x]) for x in (prev, cur)]  # leading dims kept
    got = ads.hip_delta(*map(torch.from_numpy, deep))
    assert got.tolist() == [want, want]


def test_hip_delta_rejects_packed_and_mismatched_panels():
    a = torch.zeros((4, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="byte"):
        ops.hip_delta(a, a, layout="packed")
    with pytest.raises(ValueError):
        ops.hip_delta(a, torch.zeros((5, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.hip_delta(a, a.to(torch.int32))


def test_hip_delta_ref_chunks_agree(monkeypatch):
    rng = np.random.default_rng(3)
    prev, cur = (torch.from_numpy(x) for x in _hop_pair(rng, 300, 6, 40))
    whole = ref.hip_delta_ref(prev, cur)
    monkeypatch.setattr(ref, "HIP_CHUNK_REGISTERS", 7 * 64)
    assert torch.equal(ref.hip_delta_ref(prev, cur), whole)


# ------------------------------------------------------ curve functions
def _curve(rng, t, n):
    return np.cumsum(rng.random((t, n)) * 5, axis=0)


@pytest.mark.parametrize("fn", ["distance_histogram", "closeness_from_curve"])
def test_curve_functions_equal_jax(fn):
    rng = np.random.default_rng(11)
    curve = _curve(rng, 5, 40)
    curve[:, 3] = 0.0  # no reachable mass: closeness 0
    got = getattr(ads, fn)(curve)
    want = getattr(jax_ads, fn)(curve)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("glob,q", [
    ([3.0, 7.0, 9.0, 10.0], 0.9),     # interpolated inside a hop
    ([3.0, 7.0, 9.0, 10.0], 1.0),     # the last hop
    ([3.0, 3.0, 3.0], 0.5),           # reached at the first hop
    ([0.0, 5.0, 5.0, 8.0], 0.625),    # the target on a flat segment
    ([0.0, 0.0], 0.9),                # g[-1] <= 0
    ([-1.0, -2.0], 0.5),              # g[-1] <= 0
    ([1.0, 2.0, float("nan")], 0.9),  # a NaN curve gives NaN in both
])
def test_effective_diameter_equals_jax(glob, q):
    """Every branch but ``t >= len(g)``, which no input reaches: for q in
    (0, 1], ``q * g[-1] <= g[-1]``, so the search stops at or before the
    last hop (the NaN case lands on it)."""
    got = ads.effective_diameter_from_curve(np.array(glob), q)
    want = jax_ads.effective_diameter_from_curve(np.array(glob), q)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("q", [0.0, -0.1, 1.5])
def test_effective_diameter_validates_q(q):
    with pytest.raises(ValueError, match="quantile"):
        ads.effective_diameter_from_curve(np.array([1.0, 2.0]), q)


def test_config_and_rel_std_match_jax():
    for p in (4, 8, 12):
        mine, theirs = ADSConfig(p=p), jax_ads.ADSConfig(p=p)
        assert (mine.r, mine.q, mine.max_register, mine.estimator) == (
            theirs.r, theirs.q, theirs.max_register, theirs.estimator)
        assert ads.rel_std(p) == jax_ads.rel_std(p)


# -------------------------------------------------------------- engines
@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"rmat{c[0]}-p{c[1]}")
def pair(request):
    """(JAX reference ADS engine, port ADS engine on the CPU, edges, n)."""
    scale, p, seed = request.param
    edges, n = generators.rmat(scale, 8, seed=seed), 1 << scale
    want = jax_engine.build(edges, n, jax_ads.ADSConfig(p=p), impl="ref",
                            layout="byte", backend="local", family="ads")
    got = engine.build(edges, n, ADSConfig(p=p), family="ads", device="cpu")
    return want, got, edges, n


@pytest.fixture
def counted(monkeypatch):
    """Counts the hip_delta wrapper's calls (the CPU launches no kernel)."""
    calls = []
    wrapper = ops.hip_delta_rows
    monkeypatch.setattr(ops, "hip_delta_rows",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    return calls


def test_ads_registers_match_jax(pair):
    want, got, *_ = pair
    assert got.family.name == "ads" and got.kernels.family == "ads"
    np.testing.assert_array_equal(got.regs.numpy(), np.asarray(want.regs))


def test_ads_degrees_and_neighborhood_match_jax(pair):
    want, got, *_ = pair
    np.testing.assert_allclose(got.degrees(), np.asarray(want.degrees()),
                               rtol=1e-5)
    for g, w in zip(got.neighborhood(T_MAX), want.neighborhood(T_MAX)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5)


def test_distance_histogram_matches_jax(pair):
    want, got, *_ = pair
    hist, glob = got.distance_histogram(T_MAX)
    w_hist, w_glob = want.distance_histogram(T_MAX)
    assert hist.shape == (T_MAX, got.n) and glob.shape == (T_MAX,)
    assert hist.dtype == np.float64
    # h^t = C^t - C^{t-1}: a difference keeps its terms' rounding error
    w_curve = np.cumsum(np.asarray(w_hist), axis=0)
    scale = np.concatenate([np.zeros((1, got.n)), w_curve[:-1]])
    assert np.all(np.abs(hist - w_hist) <= 1e-5 * (np.abs(w_hist) + scale))
    np.testing.assert_allclose(glob, np.asarray(w_glob), rtol=1e-5)
    assert (hist >= 0).all() and np.allclose(glob, hist.sum(axis=1))
    np.testing.assert_array_equal(hist[0], got.degrees())  # C^1 = plain


def test_closeness_matches_jax(pair):
    want, got, *_ = pair
    close = got.closeness(T_MAX)
    np.testing.assert_allclose(close, np.asarray(want.closeness(T_MAX)),
                               rtol=1e-5)
    curve = np.cumsum(got.distance_histogram(T_MAX)[0], axis=0)
    np.testing.assert_array_equal(close, ads.closeness_from_curve(curve))


@pytest.mark.parametrize("q", [0.5, 0.9, 1.0])
def test_effective_diameter_matches_jax(pair, q):
    want, got, *_ = pair
    eff = got.effective_diameter(T_MAX, q=q)
    assert isinstance(eff, float) and 0.0 <= eff <= T_MAX
    assert abs(eff - want.effective_diameter(T_MAX, q=q)) <= 1e-6


def test_hip_curve_matches_jax_and_engine(pair):
    """``core.ads.hip_curve`` over the engine's panels: the JAX package's
    reference curve on the same panels, and the engine's cached curve."""
    want, got, *_ = pair
    panels = got._panels_up_to(T_MAX)
    curve = ads.hip_curve(panels, got.cfg)
    np.testing.assert_array_equal(curve[:, : got.n], got._hip_curve(T_MAX))
    w = jax_ads.hip_curve([p.numpy() for p in panels], want.cfg)
    np.testing.assert_allclose(curve, w, rtol=1e-5)


def test_repeat_queries_run_no_kernel(pair, counted):
    _, got, *_ = pair
    fresh = engine.build(got.edges, got.n, got.cfg, device="cpu")
    h0, _ = fresh.distance_histogram(T_MAX)
    assert fresh.propagate_passes == T_MAX - 1 and len(counted) == T_MAX - 1
    h1, _ = fresh.distance_histogram(T_MAX)
    fresh.closeness(T_MAX)
    fresh.effective_diameter(T_MAX)
    fresh.distance_histogram(1)
    assert fresh.propagate_passes == T_MAX - 1 and len(counted) == T_MAX - 1
    np.testing.assert_array_equal(h0, h1)
    assert len(fresh._panel_set.aux["hip"]) == T_MAX


def test_deeper_query_extends_the_curve(counted):
    edges, n = generators.rmat(8, 8, seed=2), 1 << 8
    eng = engine.build(edges, n, ADSConfig(p=6), device="cpu")
    eng.distance_histogram(2)
    assert (eng.propagate_passes, len(counted)) == (1, 1)
    deep, _ = eng.distance_histogram(4)
    assert (eng.propagate_passes, len(counted)) == (3, 3)
    again = engine.build(edges, n, ADSConfig(p=6), device="cpu")
    np.testing.assert_array_equal(deep, again.distance_histogram(4)[0])


def test_rows_beyond_the_cache_bound_are_transient(monkeypatch, counted):
    edges, n = generators.rmat(7, 8, seed=3), 1 << 7
    eng = engine.build(edges, n, ADSConfig(p=5), device="cpu")
    monkeypatch.setattr(eng, "MAX_CACHED_PANELS", 2)
    h, _ = eng.distance_histogram(4)
    assert len(eng._panel_set.aux["hip"]) == 2
    ref_eng = engine.build(edges, n, ADSConfig(p=5), device="cpu")
    np.testing.assert_array_equal(h, ref_eng.distance_histogram(4)[0])


@pytest.mark.parametrize("mutation", ["ingest", "merge"])
def test_ingest_and_merge_drop_the_curve(mutation, counted):
    edges, n = generators.rmat(8, 8, seed=4), 1 << 8
    half = len(edges) // 2
    eng = engine.build(edges[:half], n, ADSConfig(p=6), device="cpu")
    eng.distance_histogram(2)
    if mutation == "ingest":
        eng.ingest(edges[half:])
    else:
        eng.merge(engine.build(edges[half:], n, ADSConfig(p=6),
                               device="cpu"))
    assert eng.panels_cached == 0
    h, _ = eng.distance_histogram(2)
    assert (eng.propagate_passes, len(counted)) == (2, 2)
    full = engine.build(edges, n, ADSConfig(p=6), device="cpu")
    np.testing.assert_array_equal(h, full.distance_histogram(2)[0])


def test_cross_family_queries_raise_typed(pair):
    _, ads_eng, edges, n = pair
    hll_eng = engine.build(edges, n, HLLConfig(p=6), device="cpu")
    for kind, call in (
            ("distance_histogram", lambda: hll_eng.distance_histogram(2)),
            ("closeness", lambda: hll_eng.closeness(2)),
            ("effective_diameter", lambda: hll_eng.effective_diameter(2))):
        with pytest.raises(UnsupportedQuery, match=f"{kind}.*'hll'"):
            call()
    for kind, call in (
            ("union", lambda: ads_eng.union_size([np.array([0, 1])])),
            ("intersection", lambda: ads_eng.intersection_size(edges[:2])),
            ("triangle", lambda: ads_eng.triangle_heavy_hitters(4)),
            ("union", lambda: ads_eng.query_batch(vertex_sets=[[0, 1]]))):
        with pytest.raises(UnsupportedQuery, match=f"{kind}.*'ads'"):
            call()


def test_distance_queries_validate_their_arguments(pair):
    _, eng, *_ = pair
    for call in (lambda: eng.distance_histogram(0),
                 lambda: eng.closeness(1.5),
                 lambda: eng.effective_diameter(2, schedule="bogus"),
                 lambda: eng.effective_diameter(2, q=1.5)):
        with pytest.raises(ValueError):
            call()
    bare = engine.LocalEngine.from_regs(eng.regs, eng.n, eng.cfg,
                                        device="cpu")
    with pytest.raises(ValueError, match="without edges"):
        bare.closeness(2)


@pytest.mark.parametrize("schedule", ["auto", "ring", "ring_overlap",
                                      "allgather"])
def test_distance_histogram_schedules_agree(pair, schedule):
    _, eng, *_ = pair
    want = eng.distance_histogram(T_MAX)[0]
    np.testing.assert_array_equal(
        eng.distance_histogram(T_MAX, schedule=schedule)[0], want)


def test_ads_rejects_packed_layout():
    with pytest.raises(ValueError, match="layout"):
        engine.build(np.array([[0, 1]]), 4, ADSConfig(p=4), layout="packed",
                     family="ads", device="cpu")
    with pytest.raises(ValueError, match="layouts"):
        registry.resolve(ADSConfig(p=4), layout="packed")
    with pytest.raises(ValueError, match="byte"):
        registry.family("ads").empty_table(4, ADSConfig(p=4), layout="packed")
    assert registry.family("ads").layouts == ("byte",)
    assert (registry.family("ads").query_kinds
            == jax_registry.family("ads").query_kinds)


def test_family_selection():
    eng = engine.open(16, family="ads", device="cpu")
    assert eng.cfg == ADSConfig() and eng.family.name == "ads"
    assert engine.open(16, device="cpu").family.name == "hll"
    assert registry.family_of(ADSConfig()) is registry.family("ads")
    with pytest.raises(TypeError, match="ads"):
        engine.open(16, HLLConfig(p=4), family="ads", device="cpu")
    with pytest.raises(TypeError):
        registry.resolve(object())
    with pytest.raises(ValueError, match="unknown"):
        registry.family("colored")


def test_numpy_state_carries_the_family(pair):
    want, got, edges, n = pair
    regs, n2, fields, edges2 = convert.to_numpy_state(got)
    assert fields == {"family": "ads", "layout": "byte", "p": got.cfg.p,
                      "seed": 0, "estimator": "hip"}
    moved = convert.from_numpy_state(np.asarray(want.regs), n, fields, edges,
                                     device="cpu")
    assert moved.family.name == "ads" and moved.cfg == got.cfg
    np.testing.assert_array_equal(moved.distance_histogram(2)[0],
                                  got.distance_histogram(2)[0])


def test_cpu_ads_engine_launches_no_kernel(pair):
    _, got, *_ = pair
    _build.reset_launch_counts()
    fresh = engine.build(got.edges, got.n, got.cfg, device="cpu")
    fresh.distance_histogram(2)
    fresh.effective_diameter(2)
    assert set(_build.launch_counts().values()) == {0}


# --------------------------------------------- accuracy vs the BFS oracle
def test_neighborhood_truth_matches_jax():
    from repro.graph import exact as jax_exact
    for scale, _, seed in CASES:
        edges, n = generators.rmat(scale, 8, seed=seed), 1 << scale
        np.testing.assert_array_equal(
            exact.neighborhood_truth(n, edges, T_MAX + 1),
            jax_exact.neighborhood_truth(n, edges, T_MAX + 1))


def test_hip_accuracy_within_documented_tolerance(pair):
    """Global curve MRE < 2·rel_std(p), per-vertex < 3·rel_std(p),
    effective diameter within half a hop of the exact curve's."""
    _, eng, edges, n = pair
    truth = exact.neighborhood_truth(n, edges, T_MAX)
    hist, glob = eng.distance_histogram(T_MAX)
    curve = np.cumsum(hist, axis=0)
    est_glob = np.cumsum(glob)
    truth_glob = truth.sum(axis=1).astype(np.float64)
    tol = ads.rel_std(eng.cfg.p)
    global_mre = np.mean(np.abs(est_glob - truth_glob)
                         / np.maximum(truth_glob, 1.0))
    assert global_mre < 2 * tol, global_mre
    mask = truth > 0
    pervertex = np.mean(np.abs(curve[mask] - truth[mask]) / truth[mask])
    assert pervertex < 3 * tol, pervertex
    eff = eng.effective_diameter(T_MAX, q=0.9)
    eff_exact = ads.effective_diameter_from_curve(truth_glob, q=0.9)
    assert abs(eff - eff_exact) < 0.5, (eff, eff_exact)
