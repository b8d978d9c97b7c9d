"""Port parity: the slice as a whole, ``repro_torch.engine`` on the CPU
against the JAX reference engine (``impl="ref"``, byte layout, local).

Tolerances and why:

* register tables byte-identical (integer scatter-max of the same hash);
* ``degrees`` and ``neighborhood`` to ``rtol=1e-5``: float32 estimates
  from harmonic sums taken in another order;
* ``intersection_size`` ``"ie"`` to ``1e-5`` of
  ``|x| + d̃(u) + d̃(v) + |N(u) ∪ N(v)|``: the estimate is a difference of
  float32 estimates and keeps their absolute rounding error (see
  ``tests/test_torch_intersection.py``); ``"mle"`` to ``1e-4`` of
  ``|x|`` alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import convert  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph.stream import EdgeStream  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ITERS = 10
CASES = [(8, 8, 0), (9, 8, 1), (8, 10, 2)]  # (rmat scale, p, seed)


def _graph(scale, seed):
    return generators.rmat(scale, 8, seed=seed), 1 << scale


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"rmat{c[0]}-p{c[1]}")
def pair(request):
    """(JAX reference engine, port engine on the CPU, edges, n, pairs)."""
    scale, p, seed = request.param
    edges, n = _graph(scale, seed)
    ref = jax_engine.build(edges, n, JaxConfig(p=p), impl="ref",
                           layout="byte", backend="local")
    port = engine.build(edges, n, HLLConfig(p=p), device="cpu")
    rng = np.random.default_rng(seed)
    pairs = edges[rng.choice(len(edges), 64, replace=False)]
    return ref, port, edges, n, pairs


def _close(got, want, rtol, scale=0.0):
    bound = rtol * (np.abs(want) + scale)
    assert np.all(np.abs(got - want) <= bound), np.max(
        np.abs(got - want) / np.maximum(bound, 1e-30))


def test_rmat_matches_jax_generator():
    from repro.graph import generators as jax_generators
    for scale, _, seed in CASES:
        np.testing.assert_array_equal(generators.rmat(scale, 8, seed=seed),
                                      jax_generators.rmat(scale, 8, seed=seed))
    np.testing.assert_array_equal(generators.erdos_renyi(300, 900, seed=4),
                                  jax_generators.erdos_renyi(300, 900, seed=4))


def test_build_registers_match_jax(pair):
    ref, port, *_ = pair
    assert port.regs.device.type == "cpu"
    np.testing.assert_array_equal(port.regs.numpy(), np.asarray(ref.regs))
    assert port.n_pad == ref.n_pad and port.m == ref.m


@pytest.mark.parametrize("block", [1, 97, 1000])
def test_ragged_ingest_matches_jax_build(pair, block):
    ref, _, edges, n, _ = pair
    p = ref.cfg.p
    eng = engine.open(n, HLLConfig(p=p), device="cpu")
    for s in range(0, len(edges), block * 7):
        eng.ingest(edges[s:s + block * 7])
    np.testing.assert_array_equal(eng.regs.numpy(), np.asarray(ref.regs))
    assert eng.m == len(edges)


def test_ingest_stream_matches_build(pair):
    ref, _, edges, n, _ = pair
    eng = engine.open(n, HLLConfig(p=ref.cfg.p), device="cpu")
    eng.ingest_stream(EdgeStream(edges, num_substreams=3, block=300))
    np.testing.assert_array_equal(eng.regs.numpy(), np.asarray(ref.regs))


def test_degrees_match_jax(pair):
    ref, port, *_ = pair
    got = port.degrees()
    assert got.dtype == np.float32 and got.shape == (port.n,)
    np.testing.assert_allclose(got, np.asarray(ref.degrees()), rtol=1e-5)


def test_beta_degrees_match_jax(monkeypatch):
    """LogLogBeta degrees combine the estimate kernel's (s, z), the same
    wrapper the Flajolet path takes (no plain per-register path)."""
    from repro_torch.kernels import ops
    edges, n = _graph(8, 3)
    ref = jax_engine.build(edges, n, JaxConfig(p=8, estimator="beta"),
                           impl="ref", layout="byte", backend="local")
    port = engine.build(edges, n, HLLConfig(p=8, estimator="beta"),
                        device="cpu")
    calls = []
    wrapper = ops.hll_estimate_stats
    monkeypatch.setattr(ops, "hll_estimate_stats",
                        lambda regs, **kw: calls.append(1) or wrapper(regs, **kw))
    np.testing.assert_allclose(port.degrees(), np.asarray(ref.degrees()),
                               rtol=1e-5)
    assert len(calls) == 1


def test_neighborhood_matches_jax_and_caches(pair):
    ref, port, *_ = pair
    want_l, want_g = ref.neighborhood(3)
    passes = port.propagate_passes
    got_l, got_g = port.neighborhood(3)
    assert got_l.shape == want_l.shape and got_g.shape == want_g.shape
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5)
    assert port.panels_cached == 3
    after = port.propagate_passes
    again_l, again_g = port.neighborhood(3)
    assert port.propagate_passes == after  # fully cached: zero passes
    assert after - passes <= 2
    np.testing.assert_array_equal(again_l, got_l)
    np.testing.assert_array_equal(again_g, got_g)
    np.testing.assert_array_equal(got_l[0], port.degrees())


@pytest.mark.parametrize("schedule", ["auto", "ring", "ring_overlap",
                                      "allgather"])
def test_neighborhood_schedules_match_jax(pair, schedule):
    """Every schedule name the JAX engine takes answers on the local
    backend, the same as the JAX local engine under that name and as the
    port's "auto", from one panel cache."""
    ref, port, *_ = pair
    want_l, want_g = ref.neighborhood(3, schedule=schedule)
    auto_l, auto_g = port.neighborhood(3)
    passes = port.propagate_passes
    got_l, got_g = port.neighborhood(3, schedule=schedule)
    assert port.propagate_passes == passes
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5)
    np.testing.assert_array_equal(got_l, auto_l)
    np.testing.assert_array_equal(got_g, auto_g)


def test_neighborhood_extends_and_invalidates():
    edges, n = _graph(8, 5)
    eng = engine.build(edges[: len(edges) // 2], n, HLLConfig(p=6),
                       device="cpu")
    eng.neighborhood(2)
    assert eng.propagate_passes == 1
    eng.neighborhood(4)  # runs exactly passes 3 and 4
    assert eng.propagate_passes == 3
    eng.ingest(edges[len(edges) // 2:])
    assert eng.panels_cached == 0
    loc, _ = eng.neighborhood(2)
    assert eng.propagate_passes == 4
    full = engine.build(edges, n, HLLConfig(p=6), device="cpu")
    np.testing.assert_array_equal(loc, full.neighborhood(2)[0])


@pytest.mark.parametrize("method,rtol", [("ie", 1e-5), ("mle", 1e-4)])
def test_intersection_matches_jax(pair, method, rtol):
    ref, port, _, _, pairs = pair
    want = np.asarray(ref.intersection_size(pairs, method=method,
                                            iters=ITERS))
    got = port.intersection_size(pairs, method=method, iters=ITERS)
    assert got.shape == (len(pairs),)
    deg = np.asarray(ref.degrees())
    union = np.asarray(ref.union_size([list(pr) for pr in pairs]))
    # "ie" is a difference of estimates: its error scales with them;
    # "mle" is held to its value alone (measured worst 2.1e-6)
    scale = deg[pairs[:, 0]] + deg[pairs[:, 1]] + union
    _close(got, want, rtol, scale if method == "ie" else 0.0)


def test_intersection_scalar_pair(pair):
    _, port, _, _, pairs = pair
    one = port.intersection_size(pairs[0], method="ie")
    assert isinstance(one, float)
    assert one == pytest.approx(port.intersection_size(pairs[:1],
                                                       method="ie")[0])


def test_from_numpy_state_answers_the_same(pair):
    ref, port, edges, n, pairs = pair
    cfg = ref.cfg
    fields = {"p": cfg.p, "seed": cfg.seed, "estimator": cfg.estimator}
    moved = convert.from_numpy_state(np.asarray(ref.regs), n, fields, edges,
                                     device="cpu")
    np.testing.assert_array_equal(moved.regs.numpy(), port.regs.numpy())
    np.testing.assert_array_equal(moved.degrees(), port.degrees())
    np.testing.assert_array_equal(
        moved.intersection_size(pairs, method="ie"),
        port.intersection_size(pairs, method="ie"))
    np.testing.assert_array_equal(moved.neighborhood(2)[0],
                                  port.neighborhood(2)[0])
    regs, n2, fields2, edges2 = convert.to_numpy_state(moved)
    np.testing.assert_array_equal(regs, np.asarray(ref.regs)[:n])
    assert n2 == n and fields2 == {"family": "hll", "layout": "byte",
                                   **fields}
    np.testing.assert_array_equal(edges2, edges)


def test_out_of_range_ids_raise():
    edges, n = _graph(8, 0)
    eng = engine.build(edges, n, HLLConfig(p=6), device="cpu")
    with pytest.raises(ValueError):
        eng.ingest(np.array([[0, n]]))
    with pytest.raises(ValueError):
        eng.ingest(np.array([[-1, 3]]))
    with pytest.raises(ValueError):
        eng.ingest(np.array([[0.5, 3.0]]))
    with pytest.raises(ValueError):
        eng.intersection_size(np.array([[0, n]]))
    with pytest.raises(ValueError):
        eng.intersection_size(np.array([[2 ** 40, 1]]))
    with pytest.raises(ValueError):
        engine.LocalEngine.from_regs(np.asarray(eng.regs), n, HLLConfig(p=6),
                                     edges=np.array([[0, n + 5]]),
                                     device="cpu")
    with pytest.raises(ValueError):
        eng.neighborhood(0)
    with pytest.raises(ValueError, match="schedule"):
        eng.neighborhood(2, schedule="bogus")


def test_unported_options_raise():
    from repro_torch.kernels import registry
    # the packed layout of HLL is ported: it resolves and opens half-width
    assert engine.open(16, HLLConfig(p=4), layout="packed",
                       device="cpu").regs.shape == (16, 8)
    assert registry.family("ads").name == "ads"  # ported since
    assert registry.resolve(HLLConfig(p=4), layout="packed").layout == "packed"
    with pytest.raises(ValueError, match="ADS"):  # ADS stays byte-only
        registry.resolve(ADSConfig(p=4), layout="packed")
    eng = engine.LocalEngine.from_regs(np.zeros((8, 16), np.uint8), 8,
                                       HLLConfig(p=4), device="cpu")
    with pytest.raises(ValueError, match="without edges"):
        eng.neighborhood(1)


def test_default_device_is_the_card(monkeypatch):
    """Without ``device=`` the entry points ask for the card and raise
    when there is none, instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.open(16, HLLConfig(p=4))
    with pytest.raises(RuntimeError):
        engine.build(np.array([[0, 1]]), 4, HLLConfig(p=4))
    with pytest.raises(RuntimeError):
        engine.default_device()
    with pytest.raises(RuntimeError):
        convert.from_numpy_state(np.zeros((4, 16), np.uint8), 4,
                                 {"p": 4, "seed": 0, "estimator": "flajolet"},
                                 None)


def test_cpu_engine_launches_no_kernel():
    _build.reset_launch_counts()
    edges, n = _graph(8, 1)
    eng = engine.build(edges, n, HLLConfig(p=6), device="cpu")
    eng.degrees()
    eng.neighborhood(2)
    eng.intersection_size(edges[:4], method="ie")
    eng.query_batch(degrees=True, vertex_sets=[edges[0]], pairs=edges[:2])
    eng.triangle_heavy_hitters(3, iters=2)
    assert set(_build.launch_counts().values()) == {0}
