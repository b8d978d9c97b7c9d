"""Port parity: colored DegreeSketch (``core.colored``) against the JAX
package's, and against exact BFS as ``tests/test_colored.py`` holds it.

The same seeded graph and coloring go through ``repro.core.colored`` and
``repro_torch.core.colored`` on the CPU. Tolerances and why:

* planes byte-equal at t=1 and t=2 (register max is exact), and the max
  over the planes byte-equal to the uncolored panel (each insert lands in
  exactly one plane, and register max is associative);
* ``count``/``count_union``/``count_not``: ``rtol=1e-5``, float32
  estimates of the same registers (the degree tolerance of
  ``tests/test_torch_engine.py``);
* ``count_and``: ``rtol=1e-4`` of ``|want|``, the MLE tolerance of
  ``tests/test_torch_intersection.py`` (float32 Newton iterates in
  another summation order);
* accuracy against exact BFS: the bounds of ``tests/test_colored.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import colored as jax_colored  # noqa: E402
from repro.core import hll as jax_hll  # noqa: E402
from repro_torch.core import colored, degreesketch as dsk  # noqa: E402
from repro_torch.core.hll import HLLConfig, rel_std  # noqa: E402
from repro_torch.graph import exact, generators  # noqa: E402

P = 10


@pytest.fixture(scope="module")
def setup():
    edges = generators.rmat(8, 8, seed=11)
    n = int(edges.max()) + 1
    colors = np.random.default_rng(0).integers(0, 3, size=n)
    cfg = HLLConfig(p=P)
    sk1 = colored.colored_accumulate(edges, colors, n, cfg, device="cpu")
    sk2 = colored.colored_neighborhood(sk1, edges, t_max=2)
    jcfg = jax_hll.HLLConfig(p=P)
    j1 = jax_colored.colored_accumulate(edges, colors, n, jcfg)
    j2 = jax_colored.colored_neighborhood(j1, edges, t_max=2)
    adj = exact.adjacency_lists(n, edges)
    deg = np.array([len(a) for a in adj])
    return dict(edges=edges, n=n, colors=colors, cfg=cfg, sk1=sk1, sk2=sk2,
                j1=j1, j2=j2, adj=adj, deg=deg)


def test_planes_byte_equal_to_jax(setup):
    for t in ("1", "2"):
        got, want = setup["sk" + t], setup["j" + t]
        assert got.regs.shape == want.regs.shape
        assert got.regs.dtype == torch.uint8
        assert (got.n, got.num_colors) == (want.n, want.num_colors)
        np.testing.assert_array_equal(got.regs.numpy(), np.asarray(want.regs))


def test_plane_max_equals_the_plain_panel(setup):
    edges, n, cfg = setup["edges"], setup["n"], setup["cfg"]
    ds = dsk.accumulate(edges, n, cfg, device="cpu")
    assert torch.equal(setup["sk1"].regs.amax(dim=0), ds.regs)
    _, _, d2 = dsk.neighborhood_estimates(edges, n, cfg, 2, sketch=ds)
    assert torch.equal(setup["sk2"].regs.amax(dim=0), d2.regs)


def test_colored_pass_matches_jax_and_leaves_input(setup):
    edges, sk1 = setup["edges"], setup["sk1"]
    order = np.random.default_rng(1).permutation(2 * len(edges))
    src = np.concatenate([edges[:, 0], edges[:, 1]])[order]
    dst = np.concatenate([edges[:, 1], edges[:, 0]])[order]
    before = sk1.regs.clone()
    got = colored.colored_pass(sk1.regs, src, dst)
    want = jax_colored.colored_pass(jnp.asarray(sk1.regs.numpy()),
                                    jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(sk1.regs, before)


def test_counts_match_jax(setup):
    hubs = np.argsort(-setup["deg"])[:5]
    for t in ("1", "2"):
        got, want = setup["sk" + t], setup["j" + t]
        for x in map(int, hubs):
            for c in range(3):
                np.testing.assert_allclose(got.count(x, c), want.count(x, c),
                                           rtol=1e-5)
                np.testing.assert_allclose(got.count_not(x, c),
                                           want.count_not(x, c), rtol=1e-5)
            np.testing.assert_allclose(got.count_union(x, [0, 2]),
                                       want.count_union(x, [0, 2]), rtol=1e-5)
            for c1, c2 in ((0, 1), (1, 2)):
                a, b = got.count_and(x, c1, c2), want.count_and(x, c1, c2)
                assert abs(a - b) <= 1e-4 * abs(b), (x, c1, c2, a, b)


def test_accumulate_launches_once_per_ingest_chunk(setup, monkeypatch):
    """No loop over colors: one accumulate call per chunk of undirected
    edges, over the flattened planes."""
    from repro_torch.kernels import inputs, ops
    edges, n, colors, cfg = (setup[k] for k in ("edges", "n", "colors",
                                                "cfg"))
    monkeypatch.setattr(inputs, "INGEST_BLOCK", 700)
    calls = []
    wrapper = ops.hll_accumulate
    monkeypatch.setattr(ops, "hll_accumulate",
                        lambda regs, *a, **kw: calls.append(regs.shape)
                        or wrapper(regs, *a, **kw))
    sk = colored.colored_accumulate(edges, colors, n, cfg, device="cpu")
    assert len(calls) == -(-len(edges) // 700)
    assert set(calls) == {(3 * dsk.pad_vertices(n, 8), cfg.r)}
    assert torch.equal(sk.regs, setup["sk1"].regs)


def test_accumulate_rejects_bad_colors_and_int32_overflow():
    edges = np.array([[0, 1], [1, 2]])
    cfg = HLLConfig(p=4)
    with pytest.raises(ValueError, match="color"):
        colored.colored_accumulate(edges, np.array([0, 3, 1]), 3, cfg,
                                   num_colors=3, device="cpu")
    with pytest.raises(ValueError, match="color"):
        colored.colored_accumulate(edges, np.array([0, -1, 1]), 3, cfg,
                                   device="cpu")
    with pytest.raises(ValueError, match="int32"):
        colored.colored_accumulate(edges, np.array([0, 1, 1]), 3, cfg,
                                   num_colors=1 << 28, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        colored.colored_accumulate(np.array([[0, 3]]), np.array([0, 1, 1]),
                                   3, cfg, device="cpu")
    sk = colored.colored_accumulate(edges, np.array([0, 1, 1]), 3, cfg,
                                    device="cpu")
    with pytest.raises(ValueError, match="outside"):
        colored.colored_pass(sk.regs, [0, 8], [1, 2])


# ------------------------------------- accuracy, as tests/test_colored.py
def _truth_t1(adj, colors, x, c):
    return int(np.sum(colors[adj[x]] == c))


def test_color_count_t1(setup):
    adj, colors, sk1 = setup["adj"], setup["colors"], setup["sk1"]
    for x in np.argsort(-setup["deg"])[:5]:
        for c in range(3):
            true = _truth_t1(adj, colors, x, c)
            est = sk1.count(int(x), c)
            assert est == pytest.approx(true, rel=4 * rel_std(P), abs=3), \
                (x, c, true, est)


def test_color_planes_sum_to_plain_degree(setup):
    deg, sk1 = setup["deg"], setup["sk1"]
    for x in np.argsort(-deg)[:5]:
        total = sum(sk1.count(int(x), c) for c in range(3))
        assert total == pytest.approx(deg[x], rel=0.2)


def test_count_not_and_union(setup):
    adj, colors, deg, sk1 = (setup[k] for k in ("adj", "colors", "deg",
                                                "sk1"))
    x = int(np.argmax(deg))
    not_blue_true = int(np.sum(colors[adj[x]] != 2))
    assert sk1.count_not(x, 2) == pytest.approx(not_blue_true, rel=0.2, abs=3)
    assert sk1.count_union(x, [0, 1, 2]) == pytest.approx(deg[x], rel=0.2)


def test_colored_t2_matches_bfs(setup):
    adj, colors, deg, sk2 = (setup[k] for k in ("adj", "colors", "deg",
                                                "sk2"))
    for x in np.argsort(-deg)[:3]:
        ball = set(adj[x].tolist())
        for y in adj[x]:
            ball |= set(adj[y].tolist())  # includes x itself via neighbors
        for c in range(3):
            true = sum(1 for y in ball if colors[y] == c)
            est = sk2.count(int(x), c)
            assert est == pytest.approx(true, rel=5 * rel_std(P), abs=4), \
                (x, c, true, est)


def test_partition_intersection_near_zero(setup):
    """Partition coloring: red ∩ green adjacency sets are empty; the MLE
    returns a small value relative to the plane sizes."""
    deg, sk1 = setup["deg"], setup["sk1"]
    x = int(np.argmax(deg))
    inter = sk1.count_and(x, 0, 1)
    plane = max(sk1.count(x, 0), sk1.count(x, 1))
    assert inter < 0.35 * plane  # small vs plane size (App. B caveats)
