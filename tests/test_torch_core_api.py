"""Port parity: the functional core API (``core.hll``, ``core.intersection``,
``core.degreesketch``) against the JAX package's.

The same numpy inputs, made from seeds, go through ``repro`` and
``repro_torch`` on the CPU, where each port function runs its kernels'
plain versions. Tolerances and why:

* registers (inserts, merges, accumulate, every D^t): byte-equal; register
  max is exact;
* estimates: each equal bit for bit to the port's combination of the
  exact statistics (``sum 2^-reg`` in float64, rounded once: the kernels
  and their plain versions sum exactly); against the JAX functions,
  ``rtol=1e-6`` for the Flajolet combination (measured: 1.1e-7) and
  ``1e-5`` for LogLogBeta, the tolerance of the beta degrees in
  ``tests/test_torch_engine.py``: its float32 polynomial in ``log(z+1)``
  cancels, so libraries that evaluate ``log``, the powers and the sum in
  another order differ by up to 6.2e-6 on these tables (p=6), from
  identical ``(s, z)``. Both add the reference's own error against the
  exact statistics, measured per case (XLA's CPU ``exp2`` is off by up to
  2.03e-6 at integer arguments of 13 and more, ``tests/test_torch_ads.py``;
  0 on these tables);
* ``inclusion_exclusion``: ``rtol=1e-5`` of ``|ea| + |eb| + |eu|``, the
  "ie" tolerance of ``tests/test_torch_intersection.py`` (a difference of
  estimates keeps their absolute rounding error);
* ``neighborhood_estimates``: ``rtol=1e-5`` against the JAX package (its
  ``glob`` sums float32 estimates), and bit for bit against the port
  engine's ``neighborhood``, which sums the same float32 estimates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import degreesketch as jax_dsk  # noqa: E402
from repro.core import hll as jax_hll  # noqa: E402
from repro.core import intersection as jax_inter  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import degreesketch as dsk  # noqa: E402
from repro_torch.core import hll, intersection  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.graph import generators  # noqa: E402


def _table(p: int, seed: int, rows: int = 24):
    """A seeded sketch table uint8[rows, r] of overlapping key sets, built
    by the JAX package, and its config."""
    rng = np.random.default_rng(seed)
    cfg = jax_hll.HLLConfig(p=p)
    sizes = rng.integers(0, 3000, rows)
    owner = np.repeat(np.arange(rows), sizes).astype(np.int32)
    keys = rng.integers(0, 5000, sizes.sum()).astype(np.uint32)
    regs = jax_hll.insert_table(jax_hll.empty_table(rows, cfg),
                                jnp.asarray(owner), jnp.asarray(keys), cfg)
    return np.array(regs), cfg


def _port(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def test_max_register_matches_jax():
    for p in (4, 8, 10, 16):
        assert HLLConfig(p=p).max_register == jax_hll.HLLConfig(p=p).max_register
        assert HLLConfig(p=p).max_register == 65 - p


@pytest.mark.parametrize("p", [4, 8, 10])
def test_insert_matches_jax_and_leaves_input(p):
    rng = np.random.default_rng(p)
    jcfg, cfg = jax_hll.HLLConfig(p=p), HLLConfig(p=p)
    base = np.array(jax_hll.insert(jax_hll.empty(jcfg), jnp.asarray(
        rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)), jcfg))
    keys = rng.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax_hll.insert(jnp.asarray(base), jnp.asarray(keys),
                                     jcfg))
    regs = _port(base)
    got = hll.insert(regs, keys, cfg)
    assert got.shape == (cfg.r,) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(regs.numpy(), base)
    # keys as a tensor, and an empty sketch from the port
    got2 = hll.insert(hll.empty(cfg, device="cpu"),
                      torch.from_numpy(keys.view(np.int32)), cfg)
    want2 = jax_hll.insert(jax_hll.empty(jcfg), jnp.asarray(keys), jcfg)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("p", [4, 8, 10])
def test_insert_table_matches_jax_and_leaves_input(p, masked):
    base, jcfg = _table(p, seed=p)
    rng = np.random.default_rng(100 + p)
    e = 5000
    rows = rng.integers(0, base.shape[0], e).astype(np.int32)
    keys = rng.integers(0, 2**32, e, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(e) < 0.6 if masked else None
    want = np.asarray(jax_hll.insert_table(
        jnp.asarray(base), jnp.asarray(rows), jnp.asarray(keys), jcfg,
        mask=None if mask is None else jnp.asarray(mask)))
    regs = _port(base)
    got = hll.insert_table(regs, rows, keys, HLLConfig(p=p), mask=mask)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(regs.numpy(), base)
    if masked:  # masked entries are dropped, not inserted
        assert not np.array_equal(want, np.asarray(jax_hll.insert_table(
            jnp.asarray(base), jnp.asarray(rows), jnp.asarray(keys), jcfg)))


def test_merge_matches_jax():
    tab, _ = _table(8, seed=3)
    a, b = tab[:12], tab[12:]
    ta, tb = _port(a), _port(b)
    got = hll.merge(ta, tb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_hll.merge(a, b)))
    np.testing.assert_array_equal(ta.numpy(), a)
    np.testing.assert_array_equal(tb.numpy(), b)


def _exact_stats(regs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(s, z)`` of every sketch of ``regs`` (..., r): ``sum 2^-reg`` in
    float64 rounded to float32 once, and the zero count."""
    s = np.exp2(-regs.astype(np.float64)).sum(-1).astype(np.float32)
    return s, (regs == 0).sum(-1).astype(np.float32)


@pytest.mark.parametrize("estimator", ["flajolet", "beta"])
@pytest.mark.parametrize("p", [6, 8, 10])
def test_estimates_match_jax(p, estimator):
    tab, _ = _table(p, seed=10 + p)
    jcfg = jax_hll.HLLConfig(p=p, estimator=estimator)
    cfg = HLLConfig(p=p, estimator=estimator)
    t = _port(tab)
    a, b = tab[:12], tab[12:]
    cube = tab.reshape(2, 12, -1)
    cases = [  # (port, JAX package, registers, combination)
        (hll.estimate(t, cfg), jax_hll.estimate(tab, jcfg), tab, estimator),
        (hll.estimate_flajolet(t, cfg), jax_hll.estimate_flajolet(tab, jcfg),
         tab, "flajolet"),
        (hll.estimate_beta(t, cfg), jax_hll.estimate_beta(tab, jcfg), tab,
         "beta"),
        (hll.degree_estimates(t, cfg), jax_hll.degree_estimates(tab, jcfg),
         tab, estimator),
        (hll.estimate_union(_port(a), _port(b), cfg),
         jax_hll.estimate_union(a, b, jcfg), np.maximum(a, b), estimator),
        # any leading shape: a single sketch gives a scalar
        (hll.estimate(t[5], cfg), jax_hll.estimate(tab[5], jcfg), tab[5],
         estimator),
        (hll.estimate(t.reshape(2, 12, -1), cfg),
         jax_hll.estimate(cube, jcfg), cube, estimator),
    ]
    for got, want, regs, combo in cases:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
        s, z = _exact_stats(regs)
        port_cfg = HLLConfig(p=p, estimator=combo)
        own = hll.estimate_from_stats(torch.from_numpy(np.asarray(s)),
                                      torch.from_numpy(np.asarray(z)),
                                      port_cfg)
        np.testing.assert_array_equal(got.numpy(), own.numpy())
        jax_own = np.asarray(jax_hll.estimate_from_stats(
            jnp.asarray(s), jnp.asarray(z),
            jax_hll.HLLConfig(p=p, estimator=combo)))
        ref_err = float(np.max(np.abs(want / jax_own - 1.0)))
        rtol = (1e-6 if combo == "flajolet" else 1e-5) + ref_err
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_array_equal(t.numpy(), tab)


def test_estimate_rejects_an_unknown_estimator():
    with pytest.raises(ValueError, match="estimator"):
        hll.estimate(torch.zeros(16, dtype=torch.uint8),
                     HLLConfig(p=4, estimator="hip"))


@pytest.mark.parametrize("p", [4, 8, 10])
def test_inclusion_exclusion_matches_jax(p):
    tab, jcfg = _table(p, seed=20 + p)
    a, b = tab[:12], tab[12:]
    want = np.asarray(jax_inter.inclusion_exclusion(a, b, jcfg))
    got = intersection.inclusion_exclusion(_port(a), _port(b),
                                           HLLConfig(p=p)).numpy()
    scale = sum(np.abs(np.asarray(jax_hll.estimate(x, jcfg)))
                for x in (a, b, np.maximum(a, b)))
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


def test_domination_flags_match_jax():
    tab, _ = _table(8, seed=4)
    a = np.maximum(tab[:12], tab[12:])  # dominates tab[12:]
    b = tab[12:].copy()
    b[::3] = 0                          # empty rows: never strictly
    pairs = [(a, b), (tab[:12], tab[12:]), (b, a), (a, a)]
    for x, y in pairs:
        want = jax_inter.domination_flags(x, y)
        got = intersection.domination_flags(_port(x), _port(y))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(got[0]).all()


@pytest.fixture(scope="module")
def graph():
    edges = generators.rmat(9, 8, seed=5)
    return edges, int(edges.max()) + 1


@pytest.mark.parametrize("p", [4, 8])
def test_accumulate_matches_jax_for_any_block(graph, p):
    edges, n = graph
    want = np.asarray(jax_dsk.accumulate(edges, n, jax_hll.HLLConfig(p=p)).regs)
    for block in (1 << 15, 1000, 333):
        ds = dsk.accumulate(edges, n, HLLConfig(p=p), block=block,
                            device="cpu")
        assert ds.n == n and ds.regs.shape == want.shape
        np.testing.assert_array_equal(ds.regs.numpy(), want)


def test_accumulate_counts_one_insert_per_block(graph, monkeypatch):
    from repro_torch.kernels import ops
    edges, n = graph
    calls = []
    wrapper = ops.hll_accumulate
    monkeypatch.setattr(ops, "hll_accumulate",
                        lambda *a, **kw: calls.append(a[1].shape[0])
                        or wrapper(*a, **kw))
    dsk.accumulate(edges, n, HLLConfig(p=8), block=1000, device="cpu")
    assert calls == [min(1000, 2 * len(edges) - s)
                     for s in range(0, 2 * len(edges), 1000)]


def test_neighborhood_pass_matches_jax(graph):
    edges, n = graph
    regs = np.asarray(jax_dsk.accumulate(edges, n, jax_hll.HLLConfig(p=8)).regs)
    rng = np.random.default_rng(6)
    order = rng.permutation(2 * len(edges))  # any order of the routing
    src = np.concatenate([edges[:, 0], edges[:, 1]])[order]
    dst = np.concatenate([edges[:, 1], edges[:, 0]])[order]
    want = np.asarray(jax_dsk.neighborhood_pass(jnp.asarray(regs),
                                                jnp.asarray(src),
                                                jnp.asarray(dst)))
    t = _port(regs)
    got = dsk.neighborhood_pass(t, src, dst)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.numpy(), regs)


@pytest.mark.parametrize("p", [4, 8, 10])
def test_neighborhood_estimates_match_jax_and_engine(graph, p):
    edges, n = graph
    jl, jg, jds = jax_dsk.neighborhood_estimates(edges, n,
                                                 jax_hll.HLLConfig(p=p), 3)
    cfg = HLLConfig(p=p)
    local, glob, ds = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                 device="cpu")
    assert local.dtype == np.float64 and local.shape == (3, n)
    assert glob.dtype == np.float64 and glob.shape == (3,)
    assert isinstance(ds, dsk.DegreeSketch) and ds.n == n
    np.testing.assert_array_equal(ds.regs.numpy(), np.asarray(jds.regs))
    np.testing.assert_allclose(local, jl, rtol=1e-5)
    np.testing.assert_allclose(glob, jg, rtol=1e-5)
    eng = engine.build(edges, n, cfg, device="cpu")
    e_local, e_glob = eng.neighborhood(3)
    np.testing.assert_array_equal(local, e_local)
    np.testing.assert_array_equal(glob, e_glob)
    np.testing.assert_array_equal(
        hll.degree_estimates(eng.regs, cfg).numpy()[:n], eng.degrees())


def test_neighborhood_estimates_from_a_sketch_sort_the_routing_once(
        graph, monkeypatch):
    """A given sketch is advanced over one routing: every pass reuses it."""
    edges, n = graph
    cfg = HLLConfig(p=8)
    ds = dsk.accumulate(edges, n, cfg, device="cpu")
    calls = []
    build = dsk.directed_routing
    monkeypatch.setattr(dsk, "directed_routing",
                        lambda *a: calls.append(1) or build(*a))
    before = ds.regs.clone()
    local, _, out = dsk.neighborhood_estimates(edges, n, cfg, 4, sketch=ds)
    assert calls == [1]
    assert torch.equal(ds.regs, before)  # the given sketch is unchanged
    want = jax_dsk.neighborhood_estimates(edges, n, jax_hll.HLLConfig(p=8), 4)
    np.testing.assert_array_equal(out.regs.numpy(), np.asarray(want[2].regs))
    np.testing.assert_allclose(local, want[0], rtol=1e-5)


@pytest.mark.parametrize("p", [4, 8])
def test_neighborhood_estimates_keep_a_packed_sketchs_layout(graph, p):
    """A packed sketch is advanced and estimated packed (a byte-wise max
    of nibble pairs would be wrong): equal to the packed engine's
    ``neighborhood`` bit for bit, and to the JAX package's packed engine
    (``impl="ref"``) at rtol 1e-5; the returned sketch stays packed."""
    from repro import engine as jax_engine
    from repro_torch.kernels import packing
    edges, n = graph
    cfg = HLLConfig(p=p)
    eng = engine.build(edges, n, cfg, layout="packed", device="cpu")
    ds = dsk.DegreeSketch(regs=eng.regs, n=n, cfg=cfg, layout="packed")
    local, glob, out = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                  sketch=ds)
    e_local, e_glob = eng.neighborhood(3)
    np.testing.assert_array_equal(local, e_local)
    np.testing.assert_array_equal(glob, e_glob)
    assert (out.layout, out.impl) == ("packed", "cuda")
    assert out.regs.shape == (eng.n_pad, cfg.r // 2)
    byte = dsk.neighborhood_estimates(edges, n, cfg, 3, device="cpu")[2]
    np.testing.assert_array_equal(
        out.regs.numpy(),
        packing.to_layout(byte.regs, "byte", "packed").numpy())
    jeng = jax_engine.build(edges, n, jax_hll.HLLConfig(p=p), impl="ref",
                            backend="local", layout="packed")
    jl, jg = jeng.neighborhood(3)
    np.testing.assert_allclose(local, np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(glob, np.asarray(jg), rtol=1e-5)


def test_neighborhood_estimates_keep_a_ref_sketchs_impl(graph,
                                                        monkeypatch):
    """An ``impl="ref"`` sketch runs only the plain versions: with every
    kernel wrapper made to fail, the passes and estimates still run, and
    equal the "cuda" sketch's on the CPU."""
    from repro_torch.kernels import ops
    edges, n = graph
    cfg = HLLConfig(p=8)
    ds = dsk.accumulate(edges, n, cfg, device="cpu")
    want = dsk.neighborhood_estimates(edges, n, cfg, 3, sketch=ds)

    def fail(*a, **kw):
        raise AssertionError("impl='ref' reached a kernel wrapper")
    for name in ("hll_propagate", "hll_estimate_stats"):
        monkeypatch.setattr(ops, name, fail)
    ref = dsk.DegreeSketch(regs=ds.regs, n=n, cfg=cfg, impl="ref")
    local, glob, out = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                  sketch=ref)
    assert (out.layout, out.impl) == ("byte", "ref")
    np.testing.assert_array_equal(local, want[0])
    np.testing.assert_array_equal(glob, want[1])
    assert torch.equal(out.regs, want[2].regs)


def test_ids_are_checked_before_any_kernel():
    """Edge and routing ids outside the table raise ``ValueError`` on the
    host (on the card they would address rows outside the panel)."""
    cfg = HLLConfig(p=4)
    edges = np.array([[0, 1], [2, 9]])
    with pytest.raises(ValueError, match="outside"):
        dsk.accumulate(edges, 8, cfg, device="cpu")  # n_pad = 8
    ds = dsk.accumulate(edges[:1], 8, cfg, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        dsk.neighborhood_estimates(edges, 8, cfg, 2, sketch=ds)
    for src, dst in (([0, 8], [1, 2]), ([0, -1], [1, 2])):
        with pytest.raises(ValueError, match="outside"):
            dsk.neighborhood_pass(ds.regs, src, dst)
    with pytest.raises(ValueError, match="length"):
        dsk.neighborhood_pass(ds.regs, [0, 1], [1])
