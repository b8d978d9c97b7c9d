"""Workload-aware placement on the port (local cases of
``tests/test_placement.py``), held against ``repro.engine.placement``.

(a) ``AccessStats``, ``PlacementPolicy``, ``remap_ids`` and
    ``gather_traffic`` give the JAX package's outputs on the same inputs
    (integer numpy code: exact);
(b) installing a replica set leaves every answer bit-identical, in both
    layouts: on one device the queries gather the owner rows, of which
    the replica rows are byte copies;
(c) replica rows refresh after a version bump and the id set survives
    ``save``/``load`` across both packages;
(d) both servers count accesses while they serve and apply ``replicate``
    without changing an answer.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.engine import placement as jax_placement  # noqa: E402
from repro_torch import engine, serve  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.core.intersection import NEWTON_ITERS  # noqa: E402
from repro_torch.engine import placement  # noqa: E402
from repro_torch.engine.base import SnapshotFrozen  # noqa: E402
from repro_torch.engine.placement import AccessStats, PlacementPolicy  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402

CFG = HLLConfig(p=8)
LAYOUTS = ["byte", "packed"]
WAIT = 60  # seconds any flush may take before the test fails


@pytest.fixture(scope="module")
def graph():
    edges = gen.rmat(8, 8, seed=5)
    return edges, int(edges.max()) + 1


def _build(edges, n, layout="byte"):
    return engine.build(edges, n, CFG, layout=layout, device="cpu")


# --------------------------------------------------------------- AccessStats
def test_access_stats_counts_and_topk():
    acc = AccessStats(10)
    acc.note_ids("union", [1, 1, 3])
    acc.note_ids("union", [1])
    acc.note_ids("intersection", [3, 5])
    acc.note_query("degrees")
    counts = acc.counts()
    assert counts[1] == 3 and counts[3] == 2 and counts[5] == 1
    assert counts.sum() == 6
    ids, cnt = acc.top_k(2)
    np.testing.assert_array_equal(ids, [1, 3])
    np.testing.assert_array_equal(cnt, [3, 2])
    assert acc.totals() == {"union": 4, "intersection": 2, "degrees": 1}
    assert acc.counts(kinds=("intersection",))[1] == 0


def test_access_stats_zero_counts_excluded_and_reset():
    acc = AccessStats(8)
    acc.note_ids("union", [2])
    ids, cnt = acc.top_k(5)
    np.testing.assert_array_equal(ids, [2])
    np.testing.assert_array_equal(cnt, [1])
    acc.reset()
    ids, cnt = acc.top_k(5)
    assert len(ids) == 0 and len(cnt) == 0
    assert acc.totals() == {}


def test_access_stats_out_of_range_ignored():
    acc = AccessStats(4)
    acc.note_ids("union", [-1, 0, 3, 4, 99])
    assert acc.counts().sum() == 2


def test_access_stats_snapshot_json_serializable():
    acc = AccessStats(6)
    acc.note_ids("union", np.arange(6))
    decoded = json.loads(json.dumps(acc.snapshot(top=3)))
    assert decoded["totals"]["union"] == 6
    assert len(decoded["top"]) == 3
    assert all(len(pair) == 2 for pair in decoded["top"])


def test_access_stats_reject_unknown_kinds():
    acc = AccessStats(8)
    for kind in placement.SCAN_KINDS:
        acc.note_query(kind)
    with pytest.raises(ValueError, match="unknown access kind"):
        acc.note_query("nope")
    with pytest.raises(ValueError, match="note_ids"):
        acc.note_query("union")
    with pytest.raises(ValueError, match="unknown id-carrying"):
        acc.note_ids("degrees", [1, 2])
    assert acc.totals() == {k: 1 for k in placement.SCAN_KINDS}


def test_registries_match_jax():
    assert placement.ID_KINDS == jax_placement.ID_KINDS
    assert placement.SCAN_KINDS == jax_placement.SCAN_KINDS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_access_stats_and_policy_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    mine, theirs = AccessStats(n), jax_placement.AccessStats(n)
    for _ in range(40):
        kind = placement.ID_KINDS[int(rng.integers(2))]
        ids = rng.zipf(1.3, int(rng.integers(1, 30))) - 1
        mine.note_ids(kind, ids)
        theirs.note_ids(kind, ids)
        scan = placement.SCAN_KINDS[int(rng.integers(len(
            placement.SCAN_KINDS)))]
        mine.note_query(scan)
        theirs.note_query(scan)
    np.testing.assert_array_equal(mine.counts(), theirs.counts())
    for k in (1, 8, 50):
        for got, want in zip(mine.top_k(k), theirs.top_k(k)):
            np.testing.assert_array_equal(got, want)
    assert mine.totals() == theirs.totals()
    assert mine.snapshot(top=10) == theirs.snapshot(top=10)
    for top_k, min_count in ((4, 1), (16, 3), (64, 1)):
        np.testing.assert_array_equal(
            PlacementPolicy(top_k=top_k, min_count=min_count)
            .hot_vertices(mine),
            jax_placement.PlacementPolicy(top_k=top_k, min_count=min_count)
            .hot_vertices(theirs))


# ----------------------------------------------------------- PlacementPolicy
def test_policy_hot_vertices_topk_and_min_count():
    acc = AccessStats(10)
    acc.note_ids("union", [7] * 5 + [2] * 3 + [9])
    np.testing.assert_array_equal(PlacementPolicy(top_k=2).hot_vertices(acc),
                                  [2, 7])
    np.testing.assert_array_equal(
        PlacementPolicy(top_k=8, min_count=2).hot_vertices(acc), [2, 7])
    assert len(PlacementPolicy().hot_vertices(AccessStats(10))) == 0


def test_remap_ids_matches_jax():
    hot = np.array([3, 8], dtype=np.int64)
    ids = np.array([0, 3, 7, 8], dtype=np.int64)
    out = placement.remap_ids(ids, hot, base=100)
    np.testing.assert_array_equal(out, [0, 100, 7, 101])
    assert out.dtype == ids.dtype
    rng = np.random.default_rng(4)
    big = rng.integers(0, 500, (64, 7)).astype(np.int32)
    hot = np.unique(rng.integers(0, 500, 40))
    np.testing.assert_array_equal(placement.remap_ids(big, hot, 512),
                                  jax_placement.remap_ids(big, hot, 512))


def test_gather_traffic_matches_jax():
    ids = np.array([0, 1, 5, 5, 5])
    np.testing.assert_array_equal(
        placement.gather_traffic(ids, n_pad=8, shards=2), [2, 3])
    np.testing.assert_array_equal(
        placement.gather_traffic(ids, n_pad=8, shards=2, hot_ids=[5]),
        [2, 0])
    with pytest.raises(ValueError, match="divisible"):
        placement.gather_traffic(ids, n_pad=7, shards=2)
    rng = np.random.default_rng(5)
    stream = rng.integers(0, 1024, 5000)
    hot = np.unique(rng.integers(0, 1024, 30))
    for shards in (1, 2, 4, 8):
        np.testing.assert_array_equal(
            placement.gather_traffic(stream, 1024, shards, hot_ids=hot),
            jax_placement.gather_traffic(stream, 1024, shards, hot_ids=hot))


# ------------------------------------------------------- engine replication
@pytest.mark.parametrize("layout", LAYOUTS)
def test_replicate_bit_identical_answers(graph, layout):
    edges, n = graph
    base = _build(edges, n, layout)
    eng = _build(edges, n, layout)
    hot = np.unique(edges[:64, 0].astype(np.int64))
    eng.replicate(hot)
    np.testing.assert_array_equal(eng.replicated_ids, np.unique(hot))
    sets = [np.array([0, 1, 2]), hot[:5], np.arange(20)]
    pairs = edges[:13]
    np.testing.assert_array_equal(eng.union_size(sets),
                                  base.union_size(sets))
    np.testing.assert_array_equal(eng.intersection_size(pairs),
                                  base.intersection_size(pairs))
    np.testing.assert_array_equal(eng.degrees(), base.degrees())
    got = eng.query_batch(vertex_sets=sets, pairs=pairs, degrees=True)
    want = base.query_batch(vertex_sets=sets, pairs=pairs, degrees=True)
    for key in ("degrees", "union", "intersection"):
        np.testing.assert_array_equal(got[key], want[key])
    for schedule in ("ring", "allgather"):
        l1, g1 = eng.neighborhood(2, schedule=schedule)
        l2, g2 = base.neighborhood(2, schedule=schedule)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(g1, g2)
    # a query never changes the installed set
    np.testing.assert_array_equal(eng.replicated_ids, np.unique(hot))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_replica_rows_refresh_after_ingest(graph, layout):
    edges, n = graph
    half = len(edges) // 2
    eng = _build(edges[:half], n, layout)
    hot = np.unique(edges[:32, 1].astype(np.int64))
    eng.replicate(hot)
    eng.ingest(edges[half:])
    base = _build(edges, n, layout)
    sets = [hot[:4], np.arange(8)]
    np.testing.assert_array_equal(eng.union_size(sets),
                                  base.union_size(sets))
    np.testing.assert_array_equal(eng.intersection_size(edges[:9]),
                                  base.intersection_size(edges[:9]))
    np.testing.assert_array_equal(eng.replicated_ids, hot)  # kept by ingest


def test_replicate_clear_and_validation(graph):
    edges, n = graph
    eng = _build(edges, n)
    eng.replicate([1, 2, 3])
    assert len(eng.replicated_ids) == 3
    eng.replicate([])
    assert eng.replicated_ids is None
    with pytest.raises(ValueError, match="integer"):
        eng.replicate(np.array([0.5, 1.5]))
    with pytest.raises(ValueError, match="universe"):
        eng.replicate([n + 7])
    with pytest.raises(ValueError, match="universe"):
        eng.replicate([-1])


def test_snapshot_carries_replicas_and_is_frozen(graph):
    edges, n = graph
    eng = _build(edges, n)
    eng.replicate([0, 1, 2])
    snap = eng.snapshot()
    np.testing.assert_array_equal(snap.replicated_ids, [0, 1, 2])
    with pytest.raises(SnapshotFrozen):
        snap.replicate([5])
    sets = [np.array([0, 1]), np.array([2])]
    want = eng.union_size(sets)
    eng.ingest(edges[:50])
    np.testing.assert_array_equal(snap.union_size(sets), want)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_replica_ids_survive_save_load(graph, layout, tmp_path):
    edges, n = graph
    eng = _build(edges, n, layout)
    eng.replicate([3, 1, 4, 1, 5])
    eng.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu")
    np.testing.assert_array_equal(back.replicated_ids, [1, 3, 4, 5])
    np.testing.assert_array_equal(back.union_size([[1, 3], [4]]),
                                  eng.union_size([[1, 3], [4]]))
    theirs = jax_engine.load(str(tmp_path / "ck"))  # the JAX package's load
    np.testing.assert_array_equal(theirs.replicated_ids, [1, 3, 4, 5])


def test_jax_replica_set_installs_on_port_load(graph, tmp_path):
    edges, n = graph
    ref = jax_engine.build(edges, n, JaxConfig(p=8), impl="ref",
                           backend="local")
    ref.replicate(np.array([11, 7]))
    ref.save(str(tmp_path / "j"))
    back = engine.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(back.replicated_ids, [7, 11])
    np.testing.assert_allclose(back.union_size([[7, 11], [7]]),
                               np.asarray(ref.union_size([[7, 11], [7]])),
                               rtol=1e-5)  # float32 sums in another order


def test_mixed_replica_batch_method_knobs(graph):
    edges, n = graph
    base = _build(edges, n)
    eng = _build(edges, n).replicate(np.arange(10))
    for method in ("mle", "ie"):
        got = eng.query_batch(pairs=edges[:6], vertex_sets=[np.arange(4)],
                              method=method, iters=NEWTON_ITERS)
        want = base.query_batch(pairs=edges[:6], vertex_sets=[np.arange(4)],
                                method=method, iters=NEWTON_ITERS)
        np.testing.assert_array_equal(got["intersection"],
                                      want["intersection"])
        np.testing.assert_array_equal(got["union"], want["union"])


# ------------------------------------------------------------------ serving
def test_query_server_access_stats_and_replicate(graph):
    edges, n = graph
    direct = _build(edges, n)
    with serve.QueryServer(_build(edges, n)) as srv:
        sets = [np.array([5, 6]), np.array([7])]
        pairs = edges[:4]
        u = srv.union_size(sets)
        i = srv.intersection_size(pairs)
        st = srv.stats()
        assert st["replicated"] == 0
        assert st["access"]["totals"]["union"] == 3
        assert st["access"]["totals"]["intersection"] == 8
        hot = [v for v, _ in st["access"]["top"]]
        assert set(hot) <= set([5, 6, 7] + edges[:4].ravel().tolist())
        installed = srv.replicate(policy=PlacementPolicy(top_k=4))
        assert 0 < len(installed) <= 4
        assert srv.stats()["replicated"] == len(installed)
        np.testing.assert_array_equal(srv.union_size(sets), u)
        np.testing.assert_array_equal(srv.intersection_size(pairs), i)
        np.testing.assert_array_equal(u, direct.union_size(sets))
        srv.replicate([1, 2])
        assert len(srv.replicate([])) == 0
        with pytest.raises(ValueError, match="exactly one"):
            srv.replicate([1], policy=PlacementPolicy())
        with pytest.raises(ValueError, match="exactly one"):
            srv.replicate()
        srv.reset_stats()
        assert srv.stats()["access"]["top"] == []


def test_continuous_server_replicate_publishes(graph):
    edges, n = graph
    direct = _build(edges, n)
    eng = engine.open(n, CFG, device="cpu")
    with serve.ContinuousServer(eng) as srv:
        srv.ingest(edges)
        srv.flush(timeout=WAIT)
        sets = [np.array([0, 1]), np.arange(6)]
        u = srv.union_size(sets)
        installed = srv.replicate(policy=PlacementPolicy(top_k=4))
        assert len(installed) > 0
        st = srv.stats()
        assert st["replicated"] == len(installed)
        assert st["access"]["totals"]["union"] == 8
        np.testing.assert_array_equal(srv.union_size(sets), u)
        np.testing.assert_array_equal(u, direct.union_size(sets))
        srv.ingest(edges[:64])
        srv.flush(timeout=WAIT)
        ref = _build(np.concatenate([edges, edges[:64]]), n)
        np.testing.assert_array_equal(srv.union_size(sets),
                                      ref.union_size(sets))
        np.testing.assert_array_equal(srv.degrees(), ref.degrees())
