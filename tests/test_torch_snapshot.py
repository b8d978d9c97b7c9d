"""Engine snapshots on the port: frozen semantics, the lease, cache handoff.

Mirrors ``tests/test_snapshot.py`` on the port's local backend, in both
register layouts (the port has no sharded backend):

(a) ``snapshot()`` is a read-only view frozen at the engine's version —
    its answers equal, bit for bit, those of an engine built from exactly
    the snapshot's edges, while the writer goes on ingesting and merging;
(b) the writer writes its panel in place, so a live snapshot *leases*
    the panel: the writer's next ingest or merge clones it first, once
    per snapshot-then-write cycle, and never while no snapshot of the
    panel is alive (counted by the ``"lease_clone"`` event);
(c) mutating calls on a snapshot raise ``SnapshotFrozen``;
(d) D^t panels and HIP curve rows cached at the snapshot's version hand
    off to it: its first hop query runs no propagate pass;
(e) a snapshot, and its writer after an ingest and a merge, answer like
    the JAX package's snapshot and writer (``impl="ref"``, local backend)
    taken and driven the same way.

Every comparison within the port is exact (``np.array_equal``/
``torch.equal``). Against the JAX package, as in
``tests/test_torch_serve.py``: degrees, unions and neighborhood sizes
``rtol=1e-5`` (the same register bytes, float32 sums taken in another
order), MLE intersections ``1e-4`` of ``|want|``, ``"ie"`` ``1e-5`` of
the terms it subtracts.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLL  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.engine.base import SnapshotFrozen  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.serve.snapshot import RotationPolicy, SnapshotSlot  # noqa: E402

CFG = HLLConfig(p=8)
LAYOUTS = ["byte", "packed"]


@pytest.fixture(scope="module")
def graph():
    edges = gen.rmat(8, 8, seed=5)
    return edges, int(edges.max()) + 1


def _build(edges, n, layout="byte"):
    return engine.build(edges, n, CFG, layout=layout, device="cpu")


def _clones():
    return plans.event_counts().get("lease_clone", 0)


def _answers(eng, edges):
    """Every HLL query the snapshot must keep answering."""
    local, glob = eng.neighborhood(2)
    return [eng.degrees(), eng.union_size([[0, 1, 2], [7, 9]]),
            eng.intersection_size(edges[:16]),
            eng.intersection_size(edges[:16], method="ie"), local, glob]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _close_to_jax(mine, theirs, edges):
    """``_answers`` of a port engine against those of a JAX engine."""
    got = _answers(mine, edges)
    want = [np.asarray(w) for w in _answers(theirs, edges)]
    deg, uni, mle, ie, local, glob = got
    np.testing.assert_allclose(deg, want[0], rtol=1e-5)
    np.testing.assert_allclose(uni, want[1], rtol=1e-5)
    assert np.all(np.abs(mle - want[2]) <= 1e-4 * np.abs(want[2]))
    pair_u = np.asarray(theirs.union_size([[int(a), int(b)]
                                           for a, b in edges[:16]]))
    scale = np.abs(want[3]) + 2 * np.abs(pair_u) + 1.0
    assert np.all(np.abs(ie - want[3]) <= 1e-5 * scale)
    np.testing.assert_allclose(local, want[4], rtol=1e-5)
    np.testing.assert_allclose(glob, want[5], rtol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS)
class TestSnapshotSemantics:
    def test_answers_frozen_at_version(self, graph, layout):
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        snap = eng.snapshot()
        want = _answers(_build(edges[:1000], n, layout), edges)
        eng.ingest(edges[1000:2000])  # the writer moves on; snap must not
        _same(_answers(snap, edges), want)
        eng.merge(_build(edges[2000:], n, layout))
        _same(_answers(snap, edges), want)
        assert torch.equal(snap.regs, _build(edges[:1000], n, layout).regs)

    def test_writer_correct_after_snapshot(self, graph, layout):
        """The lease clone: writer ingest after snapshot() stays exact."""
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        snap = eng.snapshot()
        eng.ingest(edges[1000:2000])
        ref = _build(edges[:2000], n, layout)
        assert torch.equal(eng.regs, ref.regs)
        np.testing.assert_array_equal(eng.degrees(), ref.degrees())
        assert snap.regs.data_ptr() != eng.regs.data_ptr()

    def test_versions(self, graph, layout):
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        v = eng.version
        snap = eng.snapshot()
        assert snap.version == v and snap.frozen
        eng.ingest(edges[1000:1500])
        assert eng.version > v and snap.version == v
        assert not eng.frozen

    def test_mutations_frozen(self, graph, layout):
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        snap = eng.snapshot()
        with pytest.raises(SnapshotFrozen):
            snap.ingest(edges[1000:1100])
        with pytest.raises(SnapshotFrozen):
            snap.merge(eng)
        with pytest.raises(SnapshotFrozen):
            snap.replicate([1, 2])
        assert torch.equal(snap.regs, eng.regs)  # nothing was written

    def test_edge_list_isolated(self, graph, layout):
        """Writer edge appends never leak into the snapshot's edge list."""
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        snap = eng.snapshot()
        eng.ingest(edges[1000:])
        assert len(snap.edges) == 1000
        assert len(eng.edges) == len(edges)

    def test_panel_cache_handoff(self, graph, layout):
        """A same-version snapshot serves neighborhood() from the writer's
        cached panels: zero propagate passes on its first query."""
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        eng.neighborhood(2)
        snap = eng.snapshot()
        plans.reset_event_counts()
        _, glob = snap.neighborhood(2)
        assert plans.event_counts().get("propagate_pass", 0) == 0
        _, glob_ref = _build(edges[:1000], n, layout).neighborhood(2)
        np.testing.assert_array_equal(glob, glob_ref)

    def test_snapshot_without_panels_recomputes(self, graph, layout):
        """No cached panels at snapshot time: the snapshot builds its own
        (and the writer's later ingest can't corrupt them)."""
        edges, n = graph
        eng = _build(edges[:1000], n, layout)
        snap = eng.snapshot()
        eng.ingest(edges[1000:2000])
        local, glob = snap.neighborhood(2)
        l_ref, g_ref = _build(edges[:1000], n, layout).neighborhood(2)
        np.testing.assert_array_equal(local, l_ref)
        np.testing.assert_array_equal(glob, g_ref)

    def test_repeated_rotation_never_observes_a_write(self, graph, layout):
        """Snapshot-then-ingest repeatedly: every snapshot stays equal to
        the reference at its version, one clone per cycle."""
        edges, n = graph
        bounds = [500, 750, 1000, len(edges)]
        eng = _build(edges[:bounds[0]], n, layout)
        snaps = []
        plans.reset_event_counts()
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            snaps.append((eng.snapshot(), lo))
            eng.ingest(edges[lo:hi])
        assert _clones() == len(snaps)
        for snap, cut in snaps:
            ref = _build(edges[:cut], n, layout)
            assert torch.equal(snap.regs, ref.regs), cut
            np.testing.assert_array_equal(snap.degrees(), ref.degrees())


@pytest.mark.parametrize("layout", LAYOUTS)
class TestLease:
    def test_one_clone_per_cycle(self, graph, layout):
        """Several snapshots at one version share one panel and one clone;
        later writes before the next snapshot write in place."""
        edges, n = graph
        eng = _build(edges[:600], n, layout)
        plans.reset_event_counts()
        snaps = [eng.snapshot() for _ in range(3)]
        assert eng.regs_leased
        assert all(s.regs.data_ptr() == eng.regs.data_ptr() for s in snaps)
        eng.ingest(edges[600:700])
        assert _clones() == 1 and not eng.regs_leased
        ptr = eng.regs.data_ptr()
        eng.ingest(edges[700:800])
        eng.merge(_build(edges[800:900], n, layout))
        assert _clones() == 1 and eng.regs.data_ptr() == ptr  # in place
        keep = eng.snapshot()
        eng.merge(_build(edges[900:], n, layout))  # merge clones as well
        assert _clones() == 2
        assert torch.equal(keep.regs, _build(edges[:900], n, layout).regs)
        assert torch.equal(eng.regs, _build(edges, n, layout).regs)

    def test_no_clone_without_a_live_snapshot(self, graph, layout):
        edges, n = graph
        eng = _build(edges[:600], n, layout)
        plans.reset_event_counts()
        eng.ingest(edges[600:700])
        eng.snapshot()  # dropped at once: no live snapshot
        gc.collect()
        assert not eng.regs_leased
        ptr = eng.regs.data_ptr()
        eng.ingest(edges[700:])
        assert _clones() == 0 and eng.regs.data_ptr() == ptr
        assert torch.equal(eng.regs, _build(edges, n, layout).regs)

    def test_snapshot_merged_elsewhere_stays_put(self, graph, layout):
        """A merge reads its source's rows when it runs: the source's later
        ingests reach neither the merged engine nor the snapshot."""
        edges, n = graph
        other = _build(edges[:500], n, layout)
        snap = other.snapshot()
        eng = _build(edges[500:1000], n, layout)
        eng.merge(snap)
        other.ingest(edges[1000:])
        want = _build(edges[:1000], n, layout)
        assert torch.equal(eng.regs, want.regs)
        assert torch.equal(snap.regs, _build(edges[:500], n, layout).regs)
        eng.merge(other)  # the writer's own rows, now including the rest
        assert torch.equal(eng.regs, _build(edges, n, layout).regs)

    def test_writer_merges_its_own_snapshot(self, graph, layout):
        edges, n = graph
        eng = _build(edges[:700], n, layout)
        snap = eng.snapshot()
        eng.ingest(edges[700:])
        eng.merge(snap)  # register max with an older self: no change
        assert torch.equal(eng.regs, _build(edges, n, layout).regs)
        assert torch.equal(snap.regs, _build(edges[:700], n, layout).regs)

    def test_regs_handle_follows_the_lease(self, graph, layout):
        """A ``regs`` handle sees in-place writes while no snapshot lives,
        and keeps the old registers once a snapshot forced a clone."""
        edges, n = graph
        eng = _build(edges[:600], n, layout)
        handle = eng.regs
        eng.ingest(edges[600:700])
        assert torch.equal(handle, eng.regs)  # written in place
        snap = eng.snapshot()
        eng.ingest(edges[700:])
        assert torch.equal(handle, snap.regs)
        assert not torch.equal(handle, eng.regs)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_snapshot_matches_the_jax_snapshot(graph, layout):
    """Both packages take a snapshot, then ingest and merge into the
    writer: the snapshots agree, and so do the writers."""
    edges, n = graph
    ref = jax_engine.build(edges[:700], n, JaxHLL(p=8), impl="ref",
                           layout=layout, backend="local")
    eng = _build(edges[:700], n, layout)
    theirs, mine = ref.snapshot(), eng.snapshot()
    ref.ingest(edges[700:1000])
    eng.ingest(edges[700:1000])
    ref.merge(jax_engine.build(edges[1000:], n, JaxHLL(p=8), impl="ref",
                               layout=layout, backend="local"))
    eng.merge(_build(edges[1000:], n, layout))
    _close_to_jax(mine, theirs, edges)
    _close_to_jax(eng, ref, edges)
    assert not np.array_equal(mine.degrees(), eng.degrees())


def test_replicas_ride_the_snapshot(graph):
    edges, n = graph
    eng = _build(edges[:1000], n)
    eng.replicate([5, 1, 3])
    snap = eng.snapshot()
    np.testing.assert_array_equal(snap.replicated_ids, [1, 3, 5])
    eng.ingest(edges[1000:])
    eng.replicate([2])
    np.testing.assert_array_equal(snap.replicated_ids, [1, 3, 5])  # frozen
    # the writer's set rides the next snapshot
    np.testing.assert_array_equal(eng.snapshot().replicated_ids, [2])


def test_hip_curve_handoff_runs_no_kernel():
    """ADS: panels and HIP curve rows hand off; the snapshot's distance
    queries equal the writer's, with no propagate pass and no
    ``hip_delta`` call."""
    edges = gen.rmat(8, 8, seed=2)
    n = int(edges.max()) + 1
    eng = engine.build(edges[:900], n, ADSConfig(p=8), family="ads",
                       device="cpu")
    hist, glob = eng.distance_histogram(4)
    close = eng.closeness(4)
    snap = eng.snapshot()
    plans.reset_event_counts()
    passes = snap.propagate_passes
    h2, g2 = snap.distance_histogram(4)
    assert plans.event_counts().get("propagate_pass", 0) == 0
    assert snap.propagate_passes == passes
    np.testing.assert_array_equal(h2, hist)
    np.testing.assert_array_equal(g2, glob)
    np.testing.assert_array_equal(snap.closeness(4), close)
    eng.ingest(edges[900:])
    np.testing.assert_array_equal(snap.distance_histogram(4)[0], hist)


class TestRotationPolicy:
    def test_validation(self):
        with pytest.raises(ValueError):
            RotationPolicy(every_blocks=0)
        with pytest.raises(ValueError):
            RotationPolicy(max_staleness=0.0)

    def test_due_by_blocks(self):
        pol = RotationPolicy(every_blocks=3)
        assert not pol.due(0, 999.0)
        assert not pol.due(2, 999.0)
        assert pol.due(3, 0.0)

    def test_due_by_staleness(self):
        pol = RotationPolicy(every_blocks=100, max_staleness=0.5)
        assert not pol.due(1, 0.1)
        assert pol.due(1, 0.5)
        assert not pol.due(0, 99.0)

    def test_timeout(self):
        pol = RotationPolicy(every_blocks=100, max_staleness=1.0)
        assert pol.timeout(0, 0.0) is None
        assert pol.timeout(1, 0.25) == pytest.approx(0.75)
        assert pol.timeout(1, 2.0) == 0.0
        assert RotationPolicy().timeout(1, 5.0) is None


class TestSnapshotSlot:
    def test_swap_and_stats(self, graph):
        edges, n = graph
        eng = _build(edges[:1000], n)
        slot = SnapshotSlot(eng.snapshot())
        assert slot.rotations == 0
        first = slot.get()
        eng.ingest(edges[1000:1500])
        old = slot.swap(eng.snapshot())
        assert old is first and slot.get() is not first
        assert slot.rotations == 1
        st = slot.stats(writer_version=eng.version)
        assert st["version"] == eng.version
        assert st["version_lag"] == 0
        assert st["age_seconds"] >= 0.0
