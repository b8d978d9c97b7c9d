"""Port parity: the packed 4-bit layout through the engine, on the CPU.

``repro_torch.engine`` with ``layout="packed"`` at ``device="cpu"`` (every
kernel's plain version) against the JAX package's engine at
``impl="ref", layout="packed"``, on seeded RMAT graphs at p <= 8 (the JAX
reference's triangle path builds one-hot ``(block, r, q+2)`` panels).

Tolerances, those of the byte tests and why:

* register panels byte-identical (integer nibble scatter-max of the same
  hash), checkpoints and merges too;
* ``degrees``, ``neighborhood`` and ``union_size`` to ``rtol=1e-5``
  (``tests/test_torch_engine.py``, ``tests/test_torch_union.py``): float32
  estimates, the port's harmonic sums exact, the reference's float32
  ``exp2`` sums in another order;
* ``intersection_size`` ``"ie"`` to ``1e-5`` of
  ``|x| + d(u) + d(v) + |N(u) ∪ N(v)|`` and ``"mle"`` to ``1e-4`` of
  ``|x|`` alone, and triangle totals and top-k values to ``1e-4`` of the
  ``"ie"`` scale summed over their edges
  (``tests/test_torch_triangles.py``). The reference unpacks the whole
  panel for the triangle queries; the port reads it packed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import convert  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import _build, packing  # noqa: E402

ITERS = 10
CASES = [(8, 8, 0), (9, 6, 1), (8, 4, 2)]  # (rmat scale, p, seed)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here runs on the CPU: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _jax(edges, n, p, layout="packed", **kw):
    return jax_engine.build(edges, n, JaxConfig(p=p, **kw), impl="ref",
                            layout=layout, backend="local")


def _port(edges, n, p, layout="packed", **kw):
    return engine.build(edges, n, HLLConfig(p=p, **kw), layout=layout,
                        device="cpu")


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"rmat{c[0]}-p{c[1]}")
def pair(request):
    """(JAX packed engine, port packed engine, edges, n, pairs, scale of
    each pair's intersection tolerance)."""
    scale, p, seed = request.param
    edges, n = generators.rmat(scale, 8, seed=seed), 1 << scale
    ref = _jax(edges, n, p)
    port = _port(edges, n, p)
    rng = np.random.default_rng(seed)
    pairs = edges[rng.choice(len(edges), 48, replace=False)]
    deg = np.asarray(ref.degrees())
    union = np.asarray(ref.union_size([list(pr) for pr in pairs]))
    scale = deg[pairs[:, 0]] + deg[pairs[:, 1]] + union
    return ref, port, edges, n, pairs, scale


def _close(got, want, rtol, scale=0.0):
    bound = rtol * (np.abs(want) + scale)
    assert np.all(np.abs(got - want) <= bound), np.max(
        np.abs(got - want) / np.maximum(bound, 1e-30))


# -------------------------------------------------------------- registers
def test_packed_registers_match_jax(pair):
    ref, port, edges, n, *_ = pair
    p = port.cfg.p
    assert port.layout == "packed" and port.regs.shape[1] == (1 << p) // 2
    np.testing.assert_array_equal(port.regs.numpy(), np.asarray(ref.regs))
    byte = _port(edges, n, p, layout="byte")
    np.testing.assert_array_equal(port.regs.numpy(),
                                  packing.pack_rows(byte.regs).numpy())


@pytest.mark.parametrize("block", [1, 97, 1000])
def test_packed_ragged_ingest_matches_build(pair, block):
    ref, port, edges, n, *_ = pair
    eng = engine.open(n, port.cfg, layout="packed", device="cpu")
    for s in range(0, len(edges), block * 7):
        eng.ingest(edges[s:s + block * 7])
    np.testing.assert_array_equal(eng.regs.numpy(), np.asarray(ref.regs))
    assert eng.m == len(edges)


# ---------------------------------------------------------------- queries
def test_packed_degrees_match_jax(pair):
    ref, port, *_ = pair
    got = port.degrees()
    assert got.dtype == np.float32 and got.shape == (port.n,)
    np.testing.assert_allclose(got, np.asarray(ref.degrees()), rtol=1e-5)


def test_packed_beta_degrees_match_jax():
    """LogLogBeta on packed rows: the JAX package takes its unpacking
    fallback, the port the packed estimate kernel's (s, z)."""
    edges, n = generators.rmat(8, 8, seed=3), 1 << 8
    got = _port(edges, n, 8, estimator="beta").degrees()
    want = np.asarray(_jax(edges, n, 8, estimator="beta").degrees())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_packed_neighborhood_matches_jax(pair):
    ref, port, *_ = pair
    want_l, want_g = ref.neighborhood(3)
    got_l, got_g = port.neighborhood(3)
    np.testing.assert_allclose(got_l, np.asarray(want_l), rtol=1e-5)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-5)
    passes = port.propagate_passes
    again, _ = port.neighborhood(3)
    assert port.propagate_passes == passes  # served from the panel cache
    np.testing.assert_array_equal(again, got_l)
    np.testing.assert_array_equal(got_l[0], port.degrees())


def test_packed_union_matches_jax(pair):
    ref, port, edges, n, *_ = pair
    rng = np.random.default_rng(n)
    sets = [rng.integers(0, n, rng.integers(1, 40)) for _ in range(30)]
    got = port.union_size(sets)
    np.testing.assert_allclose(got, np.asarray(ref.union_size(sets)),
                               rtol=1e-5)
    one = port.union_size(sets[0])
    assert isinstance(one, float) and one == got[0]


@pytest.mark.parametrize("method,rtol", [("ie", 1e-5), ("mle", 1e-4)])
def test_packed_intersection_matches_jax(pair, method, rtol):
    ref, port, _, _, pairs, scale = pair
    want = np.asarray(ref.intersection_size(pairs, method=method,
                                            iters=ITERS))
    got = port.intersection_size(pairs, method=method, iters=ITERS)
    # "mle" is held to its value alone (measured worst 1.6e-6)
    _close(got, want, rtol, scale if method == "ie" else 0.0)


def test_packed_query_batch_matches_per_kind_and_jax(pair):
    ref, port, edges, n, pairs, _ = pair
    sets = [edges[i:i + 3].ravel() for i in range(0, 60, 3)]
    got = port.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                           iters=ITERS)
    assert np.array_equal(got["degrees"], port.degrees())
    assert np.array_equal(got["union"], port.union_size(sets))
    assert np.array_equal(got["intersection"],
                          port.intersection_size(pairs, iters=ITERS))
    want = ref.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                           iters=ITERS)
    np.testing.assert_allclose(got["union"], np.asarray(want["union"]),
                               rtol=1e-5)
    _close(got["intersection"], np.asarray(want["intersection"]), 1e-4)


@pytest.fixture(scope="module")
def tri_tol(pair):
    """Per-edge triangle tolerance from the reference's per-edge estimates
    on the unpacked panel (its transient-unpack path)."""
    ref, _, edges, n, *_ = pair
    from repro.core import degreesketch as jax_dsk
    from repro.kernels import packing as jax_packing
    sketch = jax_dsk.DegreeSketch(regs=jax_packing.unpack_rows(ref.regs),
                                  n=n, cfg=ref.cfg)
    est = jax_dsk.edge_triangle_estimates(sketch, edges, iters=ITERS)
    deg = np.asarray(ref.degrees())
    union = np.asarray(ref.union_size([list(e) for e in edges]))
    return 1e-4 * (np.abs(est) + deg[edges[:, 0]] + deg[edges[:, 1]] + union)


@pytest.mark.parametrize("mode", ["edge", "vertex"])
def test_packed_triangles_match_jax(pair, tri_tol, mode):
    """The port reads packed rows block by block; the reference unpacks
    the whole panel first (``repro/core/families.py``)."""
    ref, port, edges, n, *_ = pair
    tol = tri_tol
    k = 10
    total, vals, top = port.triangle_heavy_hitters(k, mode=mode, iters=ITERS)
    w_total, w_vals, _ = ref.triangle_heavy_hitters(k, mode=mode,
                                                    iters=ITERS)
    assert abs(total - w_total) <= tol.sum() / 3
    if mode == "vertex":
        vtol = (np.bincount(edges[:, 0], tol, n)
                + np.bincount(edges[:, 1], tol, n)) / 2
        atol = vtol.max()
        assert top.dtype.kind == "i" and (top < n).all()
    else:
        atol = tol.max()
        real = {tuple(e) for e in edges}
        assert all(tuple(e) in real for e in top)
    assert np.all(np.diff(vals) <= 0)
    np.testing.assert_allclose(vals, np.asarray(w_vals), rtol=0, atol=atol)


def test_packed_answers_equal_byte_engine_on_clamped_panel(pair):
    """Every packed answer equals the byte engine's on the unpacked
    (clamped) panel, bit for bit: integer histograms, and harmonic sums
    that are exact in both layouts at p <= 9."""
    _, port, edges, n, pairs, _ = pair
    byte = engine.LocalEngine.from_regs(packing.unpack_rows(port.regs), n,
                                        port.cfg, edges=edges, device="cpu")
    sets = [edges[i:i + 4].ravel() for i in range(0, 80, 4)]
    np.testing.assert_array_equal(port.degrees(), byte.degrees())
    np.testing.assert_array_equal(port.neighborhood(2)[0],
                                  byte.neighborhood(2)[0])
    np.testing.assert_array_equal(port.union_size(sets), byte.union_size(sets))
    for method in ("ie", "mle"):
        np.testing.assert_array_equal(
            port.intersection_size(pairs, method=method, iters=ITERS),
            byte.intersection_size(pairs, method=method, iters=ITERS))
    got = port.triangle_heavy_hitters(5, iters=ITERS)
    want = byte.triangle_heavy_hitters(5, iters=ITERS)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


# ------------------------------------------------------------------ merge
def test_packed_merge_matches_one_shot_and_jax(pair):
    ref, port, edges, n, *_ = pair
    p = port.cfg.p
    left = _port(edges[0::2], n, p)
    left.merge(_port(edges[1::2], n, p))
    np.testing.assert_array_equal(left.regs.numpy(), port.regs.numpy())
    assert left.m == len(edges)
    w_left = _jax(edges[0::2], n, p)
    w_left.merge(_jax(edges[1::2], n, p))
    np.testing.assert_array_equal(left.regs.numpy(), np.asarray(w_left.regs))


@pytest.mark.parametrize("mine,theirs", [("packed", "byte"),
                                         ("byte", "packed")])
def test_cross_layout_merge_matches_jax(pair, mine, theirs):
    """``other``'s rows convert to this engine's layout first: byte ->
    packed saturates, packed -> byte is exact."""
    _, port, edges, n, *_ = pair
    p = port.cfg.p
    halves = (edges[0::2], edges[1::2])
    got = _port(halves[0], n, p, layout=mine)
    other = _port(halves[1], n, p, layout=theirs)
    before = other.regs.clone()
    got.merge(other)
    assert got.layout == mine and torch.equal(other.regs, before)
    want = _jax(halves[0], n, p, layout=mine)
    want.merge(_jax(halves[1], n, p, layout=theirs))
    np.testing.assert_array_equal(got.regs.numpy(), np.asarray(want.regs))
    if mine == "packed":
        np.testing.assert_array_equal(got.regs.numpy(), port.regs.numpy())


# ------------------------------------------------------------ checkpoints
def test_jax_packed_checkpoint_loads_in_port(pair, tmp_path):
    ref, port, *_ = pair
    ref.save(str(tmp_path))
    back = engine.load(str(tmp_path), device="cpu")
    assert back.layout == "packed"
    np.testing.assert_array_equal(back.regs.numpy(), port.regs.numpy())
    np.testing.assert_array_equal(back.edges, port.edges)
    np.testing.assert_array_equal(back.degrees(), port.degrees())


def test_port_packed_checkpoint_loads_in_jax(pair, tmp_path):
    ref, port, *_ = pair
    step = port.save(str(tmp_path))
    saved = np.load(f"{step}/regs.npy")
    assert saved.shape == (port.n, port.cfg.r // 2)  # the half-width panel
    back = jax_engine.load(str(tmp_path))
    assert back.layout == "packed"
    np.testing.assert_array_equal(np.asarray(back.regs), np.asarray(ref.regs))
    again = engine.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(again.regs.numpy(), port.regs.numpy())
    again.ingest(port.edges[:50])  # resumes: register max is idempotent
    np.testing.assert_array_equal(again.regs.numpy(), port.regs.numpy())


@pytest.mark.parametrize("saved,wanted", [("packed", "byte"),
                                          ("byte", "packed")])
def test_cross_layout_load_both_packages(pair, tmp_path, saved, wanted):
    """``load(layout=...)`` converts as the JAX package's does: packed ->
    byte exact, byte -> packed saturating, from either package's file."""
    _, port, edges, n, *_ = pair
    p = port.cfg.p
    src = _port(edges, n, p, layout=saved)
    src.save(str(tmp_path / "port"))
    _jax(edges, n, p, layout=saved).save(str(tmp_path / "jax"))
    want = np.asarray(jax_engine.load(str(tmp_path / "port"),
                                      layout=wanted).regs)
    for path in ("port", "jax"):
        got = engine.load(str(tmp_path / path), layout=wanted, device="cpu")
        assert got.layout == wanted
        np.testing.assert_array_equal(got.regs.numpy(), want)
    if wanted == "byte":  # packed -> byte is exact: the clamped byte panel
        np.testing.assert_array_equal(
            want, packing.unpack_rows(port.regs).numpy())
    else:
        np.testing.assert_array_equal(want, port.regs.numpy())


def test_packed_load_refuses_ads(tmp_path):
    from repro_torch.core.ads import ADSConfig
    edges = generators.rmat(6, 4, seed=1)
    engine.build(edges, 64, ADSConfig(p=4), device="cpu").save(str(tmp_path))
    with pytest.raises(ValueError, match="ADS"):
        engine.load(str(tmp_path), layout="packed", device="cpu")


# -------------------------------------------------------------- convert
def test_convert_carries_the_layout(pair):
    ref, port, edges, n, *_ = pair
    regs, n2, fields, edges2 = convert.to_numpy_state(port)
    assert fields["layout"] == "packed" and regs.shape[1] == port.cfg.r // 2
    moved = convert.from_numpy_state(np.asarray(ref.regs), n, fields, edges,
                                     device="cpu")
    assert moved.layout == "packed"
    np.testing.assert_array_equal(moved.regs.numpy(), port.regs.numpy())
    np.testing.assert_array_equal(moved.degrees(), port.degrees())
    no_layout = {k: v for k, v in fields.items() if k != "layout"}
    with pytest.raises(ValueError, match="width"):  # byte by default
        convert.from_numpy_state(regs, n2, no_layout, edges2, device="cpu")
