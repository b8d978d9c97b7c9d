"""ContinuousServer on the port: writer/reader split, rotation, admission,
deadlines, and the failover-aware writer.

Mirrors ``tests/test_continuous.py`` and ``TestContinuousServerFailover``
of ``tests/test_failover.py`` on the port's local backend, in both
register layouts where answers are compared:

(a) queries served during concurrent ingest equal direct engine calls at
    some published prefix of the stream, bit for bit;
(b) the rotation policy governs publication and ``flush()`` forces the
    tail out; each rotation that the writer's next ingest follows costs
    exactly one lease clone of the panel;
(c) admission control sheds with ``Overloaded`` past the watermark;
    expired deadlines fail fast with ``DeadlineExceeded``;
(d) shutdown — clean or after a thread crash — never leaves a client
    hanging;
(e) with ``ft=``/``faults=``, a writer killed mid-stream recovers from
    its newest checkpoint and replays exactly: registers and edge count
    equal the run without faults;
(f) the same stream through the JAX package's ``ContinuousServer``
    (``impl="ref"``, local backend) serves the same answers, before the
    stream and after ``flush``, in both layouts and for the ADS kinds.

Served against direct is exact. Against the JAX server, as in
``tests/test_torch_serve.py``: degrees, unions, neighborhood sizes and
ADS histograms and closeness ``rtol=1e-5`` (the same register bytes,
float32 sums taken in another order), MLE intersections ``1e-4`` of
``|want|``. Every wait is bounded (``_bounded``).
"""
import faulthandler
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro import serve as jax_serve  # noqa: E402
from repro.core.ads import ADSConfig as JaxADS  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLL  # noqa: E402
from repro.serve import server as jax_server_mod  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.runtime.faults import FaultInjector, KillHost  # noqa: E402
from repro_torch.runtime.ft import FTConfig  # noqa: E402
from repro_torch.serve import (ContinuousServer, DeadlineExceeded,  # noqa: E402
                               Overloaded, RotationPolicy, ServerClosed)
from repro_torch.serve import server as server_mod  # noqa: E402

CFG = HLLConfig(p=8)
LAYOUTS = ["byte", "packed"]
WAIT = 120  # seconds a client call or a flush may block


@pytest.fixture(autouse=True)
def _bounded(monkeypatch):
    """Bound every client wait; dump stacks and stop the process if a test
    outlives five minutes (a join inside ``close`` cannot time out)."""
    def wait(self):
        if not self.done.wait(timeout=WAIT):
            raise TimeoutError(f"{self.kind} request not served in {WAIT} s")
        if self.error is not None:
            raise self.error
        return self.result
    monkeypatch.setattr(server_mod._Request, "wait", wait)
    monkeypatch.setattr(jax_server_mod._Request, "wait", wait)
    for cls in (ContinuousServer, jax_serve.ContinuousServer):
        monkeypatch.setattr(cls, "flush", lambda self, timeout=WAIT,
                            _flush=cls.flush: _flush(self, timeout))
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def graph():
    edges = gen.rmat(8, 8, seed=5)
    return edges, int(edges.max()) + 1


def _build(edges, n, layout="byte"):
    return engine.build(edges, n, CFG, layout=layout, device="cpu")


def _until(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _hold_reader(srv):
    """Block the reader on a request until the returned event is set."""
    gate = threading.Event()
    entered = threading.Event()
    orig = srv._serve

    def slow(snap, batch):
        entered.set()
        gate.wait(timeout=30)
        srv._serve = orig
        orig(snap, batch)

    srv._serve = slow  # patch BEFORE submitting: the reader must block
    req = srv._submit("degrees", (), None)
    assert entered.wait(timeout=30)
    return gate, req


@pytest.mark.parametrize("layout", LAYOUTS)
class TestContinuousBitIdentity:
    def test_queries_during_concurrent_ingest(self, graph, layout):
        edges, n = graph
        cuts = [800, 1000, len(edges)]
        refs = {c: _build(edges[:c], n, layout).degrees() for c in cuts}
        with ContinuousServer(_build(edges[:800], n, layout)) as srv:
            stop = threading.Event()
            seen = []

            def reader():
                while not stop.is_set():
                    seen.append(srv.degrees())

            t = threading.Thread(target=reader, daemon=True)
            t.start()
            srv.ingest(edges[800:1000])
            srv.ingest(edges[1000:])
            srv.flush()
            stop.set()
            t.join(timeout=WAIT)
            assert not t.is_alive()
            final = srv.degrees()
        np.testing.assert_array_equal(final, refs[len(edges)])
        for d in seen:
            assert any(np.array_equal(d, r) for r in refs.values()), \
                "served answer matches no published snapshot state"

    def test_flush_publishes_everything(self, graph, layout):
        edges, n = graph
        with ContinuousServer(_build(edges[:1000], n, layout),
                              rotation=RotationPolicy(every_blocks=100)) \
                as srv:
            srv.ingest(edges[1000:])
            v = srv.flush()
            assert srv.snapshot_version == v
            assert srv.stats()["snapshot"]["version_lag"] == 0
            ref = _build(edges, n, layout)
            np.testing.assert_array_equal(srv.degrees(), ref.degrees())
            assert torch.equal(srv._slot.get().regs, ref.regs)

    def test_old_snapshot_answers_as_before_throughout(self, graph, layout):
        """A snapshot taken before the stream keeps its answers while the
        writer ingests and rotates; one lease clone per rotation."""
        edges, n = graph
        eng = _build(edges[:600], n, layout)
        first = eng.snapshot()
        sets = [np.arange(6), np.array([3, 9])]
        want = (first.degrees(), first.union_size(sets),
                first.intersection_size(edges[:20]))
        plans.reset_event_counts()
        with ContinuousServer(eng, rotation=RotationPolicy(every_blocks=2)) \
                as srv:
            for blk in np.array_split(edges[600:], 8):
                srv.ingest(blk)
            srv.flush()
            rotations = srv.stats()["snapshot"]["rotations"]
            got = (first.degrees(), first.union_size(sets),
                   first.intersection_size(edges[:20]))
            assert torch.equal(srv._slot.get().regs,
                               _build(edges, n, layout).regs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # the first published snapshot and every rotation but the last
        # (flush's) are followed by an ingest: one clone each
        assert rotations >= 1
        assert plans.event_counts().get("lease_clone", 0) == rotations
        assert first.regs.data_ptr() != eng.regs.data_ptr()


class TestRotationBehavior:
    def test_every_blocks_holds_back(self, graph):
        edges, n = graph
        with ContinuousServer(_build(edges[:1000], n),
                              rotation=RotationPolicy(every_blocks=100)) \
                as srv:
            v0 = srv.snapshot_version
            srv.ingest(edges[1000:1100])
            _until(lambda: srv.stats()["ingest_blocks_applied"] >= 1,
                   "the block to apply")
            assert srv.stats()["ingest_blocks_applied"] == 1
            assert srv.snapshot_version == v0
            assert srv.stats()["snapshot"]["version_lag"] == 1

    def test_max_staleness_forces_publication(self, graph):
        edges, n = graph
        pol = RotationPolicy(every_blocks=100, max_staleness=0.05)
        with ContinuousServer(_build(edges[:1000], n), rotation=pol) as srv:
            v0 = srv.snapshot_version
            srv.ingest(edges[1000:1100])
            _until(lambda: srv.snapshot_version > v0, "the staleness timer")

    def test_close_publishes_tail(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n),
                               rotation=RotationPolicy(every_blocks=100))
        srv.ingest(edges[1000:])
        srv.close()
        np.testing.assert_array_equal(srv._slot.get().degrees(),
                                      _build(edges, n).degrees())


class TestAdmissionAndDeadlines:
    def test_overloaded_past_watermark(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n), shed_watermark=2)
        try:
            gate, held = _hold_reader(srv)
            q1 = srv._submit("degrees", (), None)
            q2 = srv._submit("degrees", (), None)
            with pytest.raises(Overloaded):
                srv.degrees()
            st = srv.stats()
            assert st["shed_total"] == 1
            assert st["queue_depth"] == 2
            gate.set()
            for r in (held, q1, q2):
                r.wait()
        finally:
            srv.close()

    def test_deadline_expired_fails_fast(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n))
        try:
            gate, held = _hold_reader(srv)
            doomed = srv._submit("degrees", (), 0.001)
            ok = srv._submit("degrees", (), 60.0)
            time.sleep(0.05)
            gate.set()
            with pytest.raises(DeadlineExceeded):
                doomed.wait()
            ok.wait()
            held.wait()
            assert srv.stats()["deadline_misses"] == 1
        finally:
            srv.close()

    def test_deadline_validation(self, graph):
        edges, n = graph
        with ContinuousServer(_build(edges[:1000], n)) as srv:
            with pytest.raises(ValueError):
                srv.degrees(deadline=-1.0)


class TestShutdown:
    def test_close_fails_pending_and_rejects_new(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n))
        srv.close()
        with pytest.raises(ServerClosed):
            srv.degrees()
        with pytest.raises(ServerClosed):
            srv.ingest(edges[:10])
        srv.close()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_reader_crash_fails_pending(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n))
        try:
            def boom(snap, batch):
                raise SystemExit("reader crash")
            srv._serve = boom
            r = srv._submit("degrees", (), None)
            with pytest.raises(BaseException):
                r.wait()
            _until(lambda: srv._reader_dead, "the reader to die")
            with pytest.raises(ServerClosed):
                srv.degrees()
        finally:
            srv.close()

    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_writer_crash_fails_flush(self, graph):
        edges, n = graph
        srv = ContinuousServer(_build(edges[:1000], n))
        try:
            def boom(block):
                raise RuntimeError("writer crash")
            srv._eng.ingest = boom
            srv.ingest(edges[1000:1100])
            with pytest.raises(ServerClosed):
                srv.flush(timeout=10)
            _until(lambda: srv._writer_dead, "the writer to die")
            with pytest.raises(ServerClosed):
                srv.ingest(edges[:10])
            assert srv.degrees().shape == (n,)  # readers keep serving
        finally:
            srv.close()


class TestStatsSurface:
    def test_schema_superset_of_queryserver(self, graph):
        edges, n = graph
        with ContinuousServer(_build(edges[:1000], n)) as srv:
            srv.degrees()
            srv.union_size([[0, 1, 2]])
            srv.ingest(edges[1000:1100])
            srv.flush()
            st = srv.stats()
        for key in ("epoch", "queue_depth", "requests_total",
                    "requests_per_sec", "fused_batches", "shed_total",
                    "deadline_misses", "plan_traces", "plan_cache",
                    "ingest_queue_depth", "ingest_blocks_applied",
                    "snapshot", "runtime", "access", "replicated",
                    "family"):
            assert key in st, key
        for key in ("heartbeats_seen", "evictions", "recoveries",
                    "last_recovery_ms", "checkpoints_written"):
            assert key in st["runtime"], key
        for key in ("version", "rotations", "age_seconds",
                    "writer_version", "version_lag"):
            assert key in st["snapshot"], key
        for kind in ("degrees", "union"):
            for key in ("requests", "batches", "max_coalesced", "p50_ms",
                        "p99_ms", "p999_ms", "histogram_ms"):
                assert key in st[kind], (kind, key)
            assert sum(c for _, c in st[kind]["histogram_ms"]) \
                == st[kind]["requests"]

    def test_reset_stats(self, graph):
        edges, n = graph
        with ContinuousServer(_build(edges[:1000], n)) as srv:
            srv.degrees()
            srv.reset_stats()
            st = srv.stats()
            assert st["requests_total"] == 0
            assert "degrees" not in st

    def test_ingest_validation_kwargs(self):
        with pytest.raises(ValueError):
            ContinuousServer(object(), max_ingest_queue=0)
        with pytest.raises(ValueError):
            ContinuousServer(object(), shed_watermark=0)


# ------------------------------------------------- failover-aware writer
class TestContinuousServerFailover:
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_writer_recovers_and_serves_bit_identical(self, graph, layout,
                                                      tmp_path):
        edges, n = graph
        blocks = np.array_split(edges, 8)
        ft = FTConfig(ckpt_dir=os.path.join(tmp_path, "ckpt"), ckpt_every=2)
        inj = FaultInjector(faults=(KillHost(host=0, at_block=5),))
        with ContinuousServer(engine.open(n, CFG, layout=layout,
                                          device="cpu"),
                              ft=ft, faults=inj) as srv:
            for b in blocks:
                srv.ingest(b)
            srv.replicate([1, 2, 3])
            srv.flush()
            deg = srv.degrees()
            st = srv.stats()
            m_final = srv.engine.m
            regs = srv._slot.get().regs
            replicated = srv._slot.get().replicated_ids
        rt = st["runtime"]
        assert rt["recoveries"] == 1
        assert rt["last_recovery_ms"] is not None
        assert rt["checkpoints_written"] >= 2
        assert rt["heartbeats_seen"] >= 1
        assert m_final == len(edges)  # exact replay: no duplicated rows
        ref = _build(edges, n, layout)
        np.testing.assert_array_equal(deg, ref.degrees())
        assert torch.equal(regs, ref.regs)
        np.testing.assert_array_equal(replicated, [1, 2, 3])
        assert inj.fired == [KillHost(host=0, at_block=5)]

    def test_writer_double_failure_during_replay(self, graph, tmp_path):
        edges, n = graph
        blocks = np.array_split(edges[:1024], 8)
        ft = FTConfig(ckpt_dir=os.path.join(tmp_path, "ckpt"), ckpt_every=3)
        inj = FaultInjector(faults=(
            KillHost(host=0, at_block=6),
            KillHost(host=0, at_block=4, at_visit=2),
        ))
        with ContinuousServer(engine.open(n, CFG, device="cpu"), ft=ft,
                              faults=inj) as srv:
            for b in blocks:
                srv.ingest(b)
            srv.flush()
            st = srv.stats()
            m_final = srv.engine.m
            regs = srv._slot.get().regs
        assert st["runtime"]["recoveries"] >= 2
        assert m_final == 1024
        assert torch.equal(regs, _build(edges[:1024], n).regs)

    def test_without_ft_config_counters_stay_zero(self, graph):
        edges, n = graph
        with ContinuousServer(_build(edges[:256], n)) as srv:
            srv.degrees()
            rt = srv.stats()["runtime"]
        assert rt["recoveries"] == 0 and rt["checkpoints_written"] == 0
        assert rt["last_recovery_ms"] is None


# ------------------------------------------------- against the JAX server
def _stream_answers(srv, blocks, ask):
    """``ask(srv)`` before the stream, then after every block is ingested
    and ``flush`` has published it."""
    before = ask(srv)
    for blk in blocks:
        srv.ingest(blk)
    srv.flush()
    return before, ask(srv)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_served_answers_match_the_jax_continuous_server(graph, layout):
    """The same engine state and ingest blocks through both packages'
    ContinuousServers: the answers served from the handed-over snapshot
    and those served after the flushed stream agree."""
    edges, n = graph
    blocks = np.array_split(edges[800:], 4)
    sets = [np.array([0, 1, 2]), np.array([n - 1]), np.arange(20)]
    pairs = edges[:40]

    def ask(srv):
        local, glob = srv.neighborhood(3)
        return (np.asarray(srv.degrees()), np.asarray(srv.union_size(sets)),
                np.asarray(srv.intersection_size(pairs)),
                np.asarray(local), np.asarray(glob))

    ref = jax_engine.build(edges[:800], n, JaxHLL(p=8), impl="ref",
                           layout=layout, backend="local")
    with jax_serve.ContinuousServer(ref) as theirs:
        want = _stream_answers(theirs, blocks, ask)
    with ContinuousServer(_build(edges[:800], n, layout)) as mine:
        got = _stream_answers(mine, blocks, ask)
    for g, w in zip(got, want):
        deg, uni, mle, loc, glob = g
        np.testing.assert_allclose(deg, w[0], rtol=1e-5)
        np.testing.assert_allclose(uni, w[1], rtol=1e-5)
        assert np.all(np.abs(mle - w[2]) <= 1e-4 * np.abs(w[2]))
        np.testing.assert_allclose(loc, w[3], rtol=1e-5)
        np.testing.assert_allclose(glob, w[4], rtol=1e-5)
    # the stream moved the answers: the comparison is not of one state
    assert not np.array_equal(got[0][0], got[1][0])


def test_served_ads_kinds_match_the_jax_continuous_server():
    edges = gen.rmat(8, 8, seed=2)
    n = int(edges.max()) + 1
    blocks = np.array_split(edges[700:], 3)

    def ask(srv):
        hist, glob = srv.distance_histogram(4)
        return (np.asarray(hist), np.asarray(glob),
                np.asarray(srv.closeness(4)),
                float(srv.effective_diameter(4, q=0.9)))

    ref = jax_engine.build(edges[:700], n, JaxADS(p=8), impl="ref",
                           family="ads", backend="local")
    with jax_serve.ContinuousServer(ref) as theirs:
        want = _stream_answers(theirs, blocks, ask)
    mine_eng = engine.build(edges[:700], n, ADSConfig(p=8), family="ads",
                            device="cpu")
    with ContinuousServer(mine_eng) as mine:
        got = _stream_answers(mine, blocks, ask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=1e-5)
        np.testing.assert_allclose(g[1], w[1], rtol=1e-5)
        np.testing.assert_allclose(g[2], w[2], rtol=1e-5)
        assert abs(g[3] - w[3]) <= 1e-6
    assert not np.array_equal(got[0][0], got[1][0])
