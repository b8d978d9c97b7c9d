"""Port parity: the sharded routing plan against the JAX package's.

``repro_torch.distributed.sketch_dist.build_plan`` (built with stable
``torch.sort`` on the device, ragged groups) against
``repro.distributed.sketch_dist.build_plan`` (numpy on the host, groups
padded to the largest) at S in {1, 2, 3, 8}, with and without a replica
set: the same partition, and every accumulate, ring, all-gather, triangle
and replica group equal as a set of edges. The port's groups must also be
sorted by their local destination (the order the pull kernel reads) and
the triangle groups by ``u``; ``tri_idx`` must put each triangle edge
back at its row of the edge list. Exact integer comparisons throughout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import sketch_dist as jax_sd  # noqa: E402
from repro_torch.distributed import sketch_dist as sd  # noqa: E402
from repro_torch.distributed.topk import distributed_topk  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

SHARDS = [1, 2, 3, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: the parallel suite runs a whole
    file in one worker, and this file's many small tensor ops would
    otherwise oversubscribe the cores the other workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs():
    rng = np.random.default_rng(11)
    rmat = generators.rmat(8, 8, seed=4)
    # self loops, repeated edges and a hub spanning every shard
    odd = np.concatenate([
        np.array([[5, 5], [5, 5], [0, 0], [299, 299]]),
        np.stack([np.full(60, 7), rng.integers(0, 300, 60)], 1),
        rng.integers(0, 300, (200, 2))]).astype(np.int32)
    return {"rmat": (rmat, 1 << 8), "odd": (odd, 300)}


GRAPHS = _graphs()


def _pairs(a, b, mask=None):
    """Rows (a, b) as a sorted list of int pairs (mask selects)."""
    a, b = np.asarray(a), np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    return sorted(zip(a.tolist(), b.tolist()))


def _t(x):
    return x.cpu().numpy().astype(np.int64)


def _sorted(x):
    return bool(np.all(np.diff(_t(x)) >= 0))


@pytest.fixture(params=[(g, s, r) for g in GRAPHS for s in SHARDS
                        for r in (False, True)],
                ids=lambda c: f"{c[0]}-S{c[1]}-{'rep' if c[2] else 'norep'}")
def plans(request):
    name, shards, rep = request.param
    edges, n = GRAPHS[name]
    reps = None
    if rep:  # hot vertices: the top degrees plus an id of degree 0 or 1
        deg = np.bincount(edges.ravel(), minlength=n)
        reps = np.concatenate([np.argsort(-deg)[:6], [n - 1]])
    want = jax_sd.build_plan(edges, n, shards, replica_ids=reps)
    got = sd.build_plan(edges, n, shards, device="cpu", replica_ids=reps)
    return want, got, edges


def test_partition_matches_jax(plans):
    want, got, _ = plans
    assert (got.n, got.n_pad, got.v_loc, got.num_shards) == (
        want.n, want.n_pad, want.v_loc, want.num_shards)
    for n, s in [(1, 1), (7, 3), (1000, 8), (5, 8)]:
        assert sd.vertex_partition(n, s) == jax_sd.vertex_partition(n, s)


def test_accumulate_groups_match_jax(plans):
    want, got, _ = plans
    for s in range(got.num_shards):
        assert _pairs(_t(got.acc_dst[s]), _t(got.acc_key[s])) == _pairs(
            want.acc_dst_local[s], want.acc_key[s].astype(np.int64),
            want.acc_mask[s])
        assert _sorted(got.acc_dst[s])
        assert got.acc_key[s].dtype == torch.uint32


def test_ring_groups_match_jax(plans):
    want, got, _ = plans
    S = got.num_shards
    for s in range(S):
        assert got.ring_off[s][0] == 0
        assert got.ring_off[s][-1] == got.ring_src[s].shape[0]
        for b in range(S):
            src, dst = got.ring_group(s, b)
            assert _pairs(_t(dst), _t(src)) == _pairs(
                want.ring_dst_local[s, b], want.ring_src_local[s, b],
                want.ring_mask[s, b])
            assert _sorted(dst)


def test_allgather_groups_match_jax(plans):
    want, got, _ = plans
    for s in range(got.num_shards):
        assert _pairs(_t(got.flat_dst[s]), _t(got.flat_src[s])) == _pairs(
            want.flat_dst_local[s], want.flat_src[s], want.flat_mask[s])
        assert _sorted(got.flat_dst[s])


def test_triangle_groups_match_jax(plans):
    want, got, edges = plans
    for s in range(got.num_shards):
        assert _pairs(_t(got.tri_u[s]), _t(got.tri_v[s])) == _pairs(
            want.tri_u[s], want.tri_v[s], want.tri_mask[s])
        assert _sorted(got.tri_u[s])
        idx = _t(got.tri_idx[s])
        np.testing.assert_array_equal(edges[idx, 0], _t(got.tri_u[s]))
        np.testing.assert_array_equal(edges[idx, 1], _t(got.tri_v[s]))
    every = np.sort(np.concatenate([_t(i) for i in got.tri_idx]))
    np.testing.assert_array_equal(every, np.arange(len(edges)))


def test_replica_groups_match_jax(plans):
    want, got, _ = plans
    assert got.has_replicas == want.has_replicas
    if not want.has_replicas:
        assert got.rep_ids is None and got.rep_dst is None
        return
    np.testing.assert_array_equal(got.rep_ids, want.rep_ids)
    np.testing.assert_array_equal(_t(got.rep_gids),
                                  want.rep_gids[: len(want.rep_ids)])
    for s in range(got.num_shards):
        assert _pairs(_t(got.rep_dst[s]), _t(got.rep_slot[s])) == _pairs(
            want.rep_dst_local[s], want.rep_slot[s], want.rep_mask[s])
        assert _sorted(got.rep_dst[s])


def test_groups_cover_every_directed_edge(plans):
    """Replica and exchange groups split the accumulate groups exactly."""
    _, got, edges = plans
    total = 2 * len(edges)
    assert sum(int(a.numel()) for a in got.acc_dst) == total
    flat = sum(int(a.numel()) for a in got.flat_dst)
    ring = sum(int(a.numel()) for a in got.ring_dst)
    rep = sum(int(a.numel()) for a in got.rep_dst) if got.has_replicas else 0
    assert flat == ring and flat + rep == total


def test_shard_devices_on_the_cpu():
    cpu = torch.device("cpu")
    assert sd.shard_devices(cpu, 3) == [cpu] * 3


@pytest.mark.parametrize("k", [1, 5, 40])
def test_distributed_topk_matches_a_global_topk(k):
    """Exact: the top-k of the per-shard top-k candidates is the global
    top-k (values distinct), ids carried as integers beside them."""
    rng = np.random.default_rng(k)
    vals = rng.permutation(1000).astype(np.float64)[:30] + 0.5
    ids = np.arange(30, dtype=np.int64) + (1 << 40)  # beyond float32
    cuts = [0, 3, 3, 17, 30]  # one shard empty
    v = [torch.from_numpy(vals[a:b]) for a, b in zip(cuts, cuts[1:])]
    i = [torch.from_numpy(ids[a:b]) for a, b in zip(cuts, cuts[1:])]
    got_v, got_i = distributed_topk(v, i, k)
    order = np.argsort(-vals)[: min(k, 30)]
    np.testing.assert_array_equal(got_v.numpy(), vals[order])
    np.testing.assert_array_equal(got_i.numpy(), ids[order])
