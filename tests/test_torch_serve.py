"""QueryServer on the port: coalescing, bit identity, ingest epochs.

Mirrors ``tests/test_serve.py`` on the port's local backend, in both
register layouts and for the ADS distance kinds, and holds the port's
served answers against the JAX package's ``QueryServer``
(``impl="ref"``, local backend) on the same graph and requests:

(a) N concurrent mixed-size clients are served with O(log N) plans per
    kind (the plan layer's trace counters), and a mixed segment by one;
(b) served answers equal direct engine calls bit for bit, whatever batch
    a request was coalesced into;
(c) queries interleaved with ingest blocks see exactly the panel of
    their epoch.

Tolerances against the JAX server, and why: degrees, unions and
neighborhood sizes ``rtol=1e-5`` (the same register bytes, float32
harmonic sums taken in another order: about one ulp apart, as in
``tests/test_torch_union.py``); MLE
intersections ``rtol=1e-4`` of ``|want|`` and ``"ie"`` ``1e-5`` of the
terms it subtracts (``tests/test_torch_engine.py``); ADS histograms and
closeness ``rtol=1e-5`` (``tests/test_torch_ads.py``). Served against
direct is always exact.

Every client call runs under a bounded wait (``_bounded`` below), so a
deadlocked server fails its test instead of hanging the suite.
"""
import faulthandler
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro import serve as jax_serve  # noqa: E402
from repro.core.ads import ADSConfig as JaxADS  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLL  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import _build as kbuild  # noqa: E402
from repro_torch.launch import sketch_serve  # noqa: E402
from repro_torch.serve import QueryServer, ServerClosed  # noqa: E402
from repro_torch.serve import server as server_mod  # noqa: E402

CFG = HLLConfig(p=8)
LAYOUTS = ["byte", "packed"]
WAIT = 120  # seconds a client call may block before its test fails


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
    faulthandler.dump_traceback_later(300, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def graph():
    edges = gen.rmat(8, 8, seed=5)
    return edges, int(edges.max()) + 1


def _build(edges, n, layout="byte"):
    return engine.build(edges, n, CFG, layout=layout, device="cpu")


def _join_all(threads):
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a client thread did not finish"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_served_answers_bit_identical_to_direct(graph, layout):
    edges, n = graph
    direct = _build(edges, n, layout)
    with QueryServer(_build(edges, n, layout)) as srv:
        np.testing.assert_array_equal(srv.degrees(), direct.degrees())
        sets = [np.array([0, 1, 2]), np.array([n - 1]), np.arange(20)]
        np.testing.assert_array_equal(srv.union_size(sets),
                                      direct.union_size(sets))
        assert srv.union_size(np.array([4, 5])) == \
            direct.union_size(np.array([4, 5]))
        pairs = edges[:13]
        np.testing.assert_array_equal(srv.intersection_size(pairs),
                                      direct.intersection_size(pairs))
        t_s = srv.triangle_heavy_hitters(k=5)
        t_d = direct.triangle_heavy_hitters(k=5)
        assert t_s[0] == t_d[0]
        np.testing.assert_array_equal(t_s[1], t_d[1])
        np.testing.assert_array_equal(t_s[2], t_d[2])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_served_answers_match_the_jax_server(graph, layout):
    """The same requests through both packages' servers."""
    edges, n = graph
    ref = jax_engine.build(edges, n, JaxHLL(p=8), impl="ref", layout=layout,
                           backend="local")
    sets = [np.array([0, 1, 2]), np.array([n - 1]), np.arange(20)]
    pairs = edges[:40]
    with jax_serve.QueryServer(ref) as theirs:
        w_deg = np.asarray(theirs.degrees())
        w_uni = np.asarray(theirs.union_size(sets))
        w_mle = np.asarray(theirs.intersection_size(pairs))
        w_ie = np.asarray(theirs.intersection_size(pairs, method="ie"))
        w_loc, w_glob = theirs.neighborhood(3)
        w_deg_u = np.asarray(theirs.union_size([[int(a), int(b)]
                                                for a, b in pairs]))
    with QueryServer(_build(edges, n, layout)) as mine:
        deg = mine.degrees()
        uni = mine.union_size(sets)
        mle = mine.intersection_size(pairs)
        ie = mine.intersection_size(pairs, method="ie")
        loc, glob = mine.neighborhood(3)
        deg_u = mine.union_size([[int(a), int(b)] for a, b in pairs])
    np.testing.assert_allclose(uni, w_uni, rtol=1e-5)
    np.testing.assert_allclose(deg, w_deg, rtol=1e-5)
    np.testing.assert_allclose(loc, np.asarray(w_loc), rtol=1e-5)
    np.testing.assert_allclose(glob, np.asarray(w_glob), rtol=1e-5)
    assert np.all(np.abs(mle - w_mle) <= 1e-4 * np.abs(w_mle))
    scale = np.abs(w_ie) + 2 * np.abs(w_deg_u) + 1.0
    assert np.all(np.abs(ie - w_ie) <= 1e-5 * scale)
    np.testing.assert_allclose(deg_u, w_deg_u, rtol=1e-5)


def test_coalesced_batch_bit_identical_per_request(graph):
    """Requests fused into one micro-batch answer exactly like solo calls."""
    edges, n = graph
    direct = _build(edges, n)
    with QueryServer(_build(edges, n)) as srv:
        srv.pause()
        sets_a = [np.arange(5), np.array([n - 1])]
        sets_b = [np.arange(30)]
        ra = srv._submit("union", plans.split_sets(sets_a, n))
        rb = srv._submit("union", plans.split_sets(sets_b, n))
        pa = edges[:3].astype(np.int64)
        pb = edges[3:20].astype(np.int64)
        ia = srv._submit("intersection", (pa, False, "mle", 50))
        ib = srv._submit("intersection", (pb, False, "mle", 50))
        srv.resume()
        np.testing.assert_array_equal(ra.wait(), direct.union_size(sets_a))
        np.testing.assert_array_equal(rb.wait(), direct.union_size(sets_b))
        np.testing.assert_array_equal(ia.wait(),
                                      direct.intersection_size(pa, iters=50))
        np.testing.assert_array_equal(ib.wait(),
                                      direct.intersection_size(pb, iters=50))
        stats = srv.stats()
    assert stats["union"]["batches"] == 1
    assert stats["union"]["max_coalesced"] == 2
    assert stats["intersection"]["batches"] == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_concurrent_mixed_clients_log_bound_plans(graph, layout):
    """N clients with jittering batches: O(log N) plans per kind, every
    answer equal to a direct call (8 Newton iterations keep the CPU's
    eager MLE tail short; the bound does not depend on them)."""
    edges, n = graph
    eng = _build(edges, n, layout)
    eng._plan_cache = plans.PlanCache(maxsize=64)  # isolate the counting
    plans.reset_trace_counts()
    n_clients, per_client = 8, 6
    errors: list = []
    direct = _build(edges, n, layout)

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(per_client):
                size = int(rng.integers(1, 33))
                idx = rng.integers(0, len(edges), size=size)
                np.testing.assert_array_equal(
                    srv.intersection_size(edges[idx], iters=8),
                    direct.intersection_size(edges[idx], iters=8))
                sets = [rng.integers(0, n, size=3) for _ in range(size)]
                np.testing.assert_array_equal(srv.union_size(sets),
                                              direct.union_size(sets))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with QueryServer(eng) as srv:
        threads = [threading.Thread(target=client, args=(100 + i,),
                                    daemon=True) for i in range(n_clients)]
        for t in threads:
            t.start()
        _join_all(threads)
        stats = srv.stats()
    assert not errors, errors
    traces = plans.trace_counts()
    bound = int(np.log2(n_clients * 32)) + 2
    assert traces.get("intersection", 0) <= bound, traces
    assert traces.get("union", 0) <= bound, traces
    assert stats["requests_total"] == n_clients * per_client * 2
    assert stats["plan_traces"] == {k: v for k, v in traces.items() if v}


def test_mixed_kind_segment_fused_into_one_plan(graph):
    """Coalesced degrees+union+intersection ride ONE mixed plan and stay
    bit-identical to direct per-kind engine calls."""
    edges, n = graph
    direct = _build(edges, n)
    eng = _build(edges, n)
    eng._plan_cache = plans.PlanCache(maxsize=32)
    sets = [np.arange(5), np.array([n - 1])]
    pa = edges[:6].astype(np.int64)
    want_u = direct.union_size(sets)
    want_d = direct.degrees()
    want_i = direct.intersection_size(pa, iters=50)
    with QueryServer(eng) as srv:
        srv.pause()
        ru = srv._submit("union", plans.split_sets(sets, n))
        rd = srv._submit("degrees", ())
        ri = srv._submit("intersection", (pa, False, "mle", 50))
        plans.reset_trace_counts()
        srv.resume()
        np.testing.assert_array_equal(ru.wait(), want_u)
        np.testing.assert_array_equal(rd.wait(), want_d)
        np.testing.assert_array_equal(ri.wait(), want_i)
        traces = plans.trace_counts()
        stats = srv.stats()
    assert traces == {"mixed": 1}, traces
    assert stats["fused_batches"] == 1
    for kind in ("union", "degrees", "intersection"):
        assert stats[kind]["batches"] == 1


def test_mixed_segment_extra_intersection_group_served_unfused(graph):
    edges, n = graph
    direct = _build(edges, n)
    with QueryServer(_build(edges, n)) as srv:
        srv.pause()
        rd = srv._submit("degrees", ())
        pa = edges[:3].astype(np.int64)
        pb = edges[3:8].astype(np.int64)
        ra = srv._submit("intersection", (pa, False, "mle", 50))
        rb = srv._submit("intersection", (pb, False, "ie", 50))
        srv.resume()
        np.testing.assert_array_equal(rd.wait(), direct.degrees())
        np.testing.assert_array_equal(ra.wait(),
                                      direct.intersection_size(pa, iters=50))
        np.testing.assert_array_equal(
            rb.wait(), direct.intersection_size(pb, method="ie"))


def test_reset_stats_clears_the_window(graph):
    edges, n = graph
    with QueryServer(_build(edges, n)) as srv:
        srv.degrees()
        assert srv.stats()["requests_total"] == 1
        srv.reset_stats()
        stats = srv.stats()
        assert stats["requests_total"] == 0
        assert stats["fused_batches"] == 0
        assert stats["plan_traces"] == {}
        srv.degrees()
        assert srv.stats()["requests_total"] == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_queries_interleaved_with_ingest(graph, layout):
    """Clients query while blocks stream in: no error, and after the last
    barrier the answers equal the full build's."""
    edges, n = graph
    srv_eng = _build(edges[: len(edges) // 4], n, layout)
    full = _build(edges, n, layout)
    errors: list = []
    stop = threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                srv.degrees()
                idx = rng.integers(0, len(edges), size=int(rng.integers(1, 9)))
                srv.intersection_size(edges[idx])
                srv.union_size([rng.integers(0, n, size=4)])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with QueryServer(srv_eng) as srv:
        threads = [threading.Thread(target=client, args=(7 + i,),
                                    daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        rest = edges[len(edges) // 4:]
        step = max(1, len(rest) // 6)
        for s in range(0, len(rest), step):
            srv.ingest(rest[s:s + step])
        stop.set()
        _join_all(threads)
        assert not errors, errors
        assert srv.epoch >= 6
        np.testing.assert_array_equal(srv.degrees(), full.degrees())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_served_neighborhood_bit_identical_to_direct(graph, layout):
    edges, n = graph
    l_d, g_d = _build(edges, n, layout).neighborhood(3)
    with QueryServer(_build(edges, n, layout)) as srv:
        for _ in range(2):  # the repeat rides the cached panels
            l_s, g_s = srv.neighborhood(3)
            np.testing.assert_array_equal(l_s, l_d)
            np.testing.assert_array_equal(g_s, g_d)


def test_served_neighborhood_coalesces_per_schedule(graph):
    edges, n = graph
    l_d, g_d = _build(edges, n).neighborhood(3)
    with QueryServer(_build(edges, n)) as srv:
        srv.pause()
        key = srv.engine._canonical_schedule("auto")
        r2 = srv._submit("neighborhood", (2, "auto", key))
        r3 = srv._submit("neighborhood", (3, "ring", key))
        srv.resume()
        l2, g2 = r2.wait()
        l3, g3 = r3.wait()
        np.testing.assert_array_equal(l3, l_d)
        np.testing.assert_array_equal(g3, g_d)
        np.testing.assert_array_equal(l2, l_d[:2])
        np.testing.assert_array_equal(g2, g_d[:2])
        stats = srv.stats()
    assert stats["neighborhood"]["requests"] == 2
    assert stats["neighborhood"]["batches"] == 1
    assert stats["neighborhood"]["max_coalesced"] == 2


def test_served_neighborhood_panel_cache_hit_asserted(graph):
    """A repeat: no propagate pass, no plan built, no kernel
    (the CPU wrappers launch nothing; their counters stay put)."""
    edges, n = graph
    eng = _build(edges, n)
    eng._plan_cache = plans.PlanCache(maxsize=32)
    with QueryServer(eng) as srv:
        srv.neighborhood(3)
        plans.reset_trace_counts()
        plans.reset_event_counts()
        before = kbuild.launch_counts()
        srv.neighborhood(3)
        assert plans.event_counts().get("propagate_pass", 0) == 0
        assert plans.trace_counts() == {}
        assert kbuild.launch_counts() == before


@pytest.mark.parametrize("layout", LAYOUTS)
def test_served_neighborhood_ingest_invalidates(graph, layout):
    edges, n = graph
    half = len(edges) // 2
    full_l, _ = _build(edges, n, layout).neighborhood(2)
    with QueryServer(_build(edges[:half], n, layout)) as srv:
        before_l, _ = srv.neighborhood(2)
        epoch = srv.ingest(edges[half:])
        after_l, _ = srv.neighborhood(2)
        assert epoch == 1
        np.testing.assert_array_equal(after_l, full_l)
        assert not np.array_equal(before_l, after_l)


def test_served_neighborhood_validates_on_client_thread(graph):
    edges, n = graph
    with QueryServer(_build(edges, n)) as srv:
        with pytest.raises(ValueError, match="t_max"):
            srv.neighborhood(0)
        with pytest.raises(ValueError, match="schedule"):
            srv.neighborhood(2, schedule="nope")
        local, glob = srv.neighborhood(2)
        assert local.shape == (2, n) and glob.shape == (2,)


def test_epoch_barrier_orders_reads(graph):
    edges, n = graph
    half = len(edges) // 2
    half_eng = _build(edges[:half], n)
    full_eng = _build(edges, n)
    with QueryServer(_build(edges[:half], n)) as srv:
        srv.pause()
        before = srv._submit("degrees", ())
        barrier = srv._submit("ingest", (edges[half:],))
        after = srv._submit("degrees", ())
        srv.resume()
        np.testing.assert_array_equal(before.wait(), half_eng.degrees())
        assert barrier.wait() == 1
        np.testing.assert_array_equal(after.wait(), full_eng.degrees())
    assert before.epoch == 0 and after.epoch == 1


def test_request_errors_propagate_to_caller_only(graph):
    edges, n = graph
    with QueryServer(_build(edges, n)) as srv:
        with pytest.raises(ValueError, match="universe"):
            srv.union_size([np.array([n + 5])])
        with pytest.raises(ValueError, match="universe"):
            srv.ingest(np.array([[0, n]]))
        with pytest.raises(ValueError, match="method"):
            srv.intersection_size(edges[:2], method="nope")
        assert srv.degrees().shape == (n,)


def test_worker_side_error_does_not_poison_batch(graph):
    edges, n = graph
    built = _build(edges, n)
    bare = engine.LocalEngine.from_regs(built.regs[:n], n, CFG,
                                        device="cpu")
    with QueryServer(bare) as srv:
        srv.pause()
        tri = srv._submit("triangle", (5, "edge", 30))
        deg = srv._submit("degrees", ())
        srv.resume()
        with pytest.raises(ValueError, match="edge stream"):
            tri.wait()
        np.testing.assert_array_equal(deg.wait(), built.degrees())


def test_closed_server_rejects_requests(graph):
    edges, n = graph
    srv = QueryServer(_build(edges[:50], n))
    assert srv.degrees().shape == (n,)
    srv.close()
    with pytest.raises(ServerClosed):
        srv.degrees()
    srv.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_fails_pending_with_server_closed(graph):
    edges, n = graph
    srv = QueryServer(_build(edges[:200], n))
    try:
        srv.pause()
        r1 = srv._submit("degrees", ())
        r2 = srv._submit("union", ([np.array([0, 1])], False))

        def boom(batch):
            raise SystemExit("worker crash")
        srv._serve = boom
        srv.resume()
        for r in (r1, r2):
            with pytest.raises(BaseException):
                r.wait()
        srv._worker.join(timeout=30)
        assert srv._dead
        with pytest.raises(ServerClosed):
            srv.degrees()
    finally:
        srv.close()


def test_shutdown_alias_and_stats_schema(graph):
    edges, n = graph
    srv = QueryServer(_build(edges[:200], n))
    srv.degrees()
    srv.union_size([[0, 1, 2]])
    st = srv.stats()
    for key in ("epoch", "queue_depth", "requests_total", "fused_batches",
                "shed_total", "deadline_misses", "plan_traces",
                "plan_cache", "runtime", "access", "family", "replicated"):
        assert key in st, key
    assert st["queue_depth"] == 0
    assert st["shed_total"] == 0 and st["deadline_misses"] == 0
    for key in ("heartbeats_seen", "evictions", "recoveries",
                "last_recovery_ms", "checkpoints_written"):
        assert key in st["runtime"], key
    assert st["runtime"]["heartbeats_seen"] >= 1
    for kind in ("degrees", "union"):
        s = st[kind]
        for key in ("requests", "batches", "max_coalesced", "p50_ms",
                    "p99_ms", "p999_ms", "histogram_ms"):
            assert key in s, (kind, key)
        assert sum(c for _, c in s["histogram_ms"]) == s["requests"]
    srv.shutdown()
    with pytest.raises(ServerClosed):
        srv.degrees()
    srv.shutdown()


def test_queue_depth_reported_while_paused(graph):
    edges, n = graph
    with QueryServer(_build(edges[:200], n)) as srv:
        srv.pause()
        a = srv._submit("degrees", ())
        b = srv._submit("degrees", ())
        assert srv.stats()["queue_depth"] == 2
        srv.resume()
        a.wait()
        b.wait()
        assert srv.stats()["queue_depth"] == 0


# ------------------------------------------------------------- ADS kinds
@pytest.fixture(scope="module")
def ads_pair():
    edges = gen.rmat(8, 8, seed=2)
    n = int(edges.max()) + 1
    ref = jax_engine.build(edges, n, JaxADS(p=8), impl="ref", family="ads",
                           backend="local")
    return edges, n, ref


def _ads(edges, n):
    return engine.build(edges, n, ADSConfig(p=8), family="ads", device="cpu")


def test_served_ads_kinds_bit_identical_and_match_jax(ads_pair):
    edges, n, ref = ads_pair
    direct = _ads(edges, n)
    want_h, want_g = direct.distance_histogram(4)
    with QueryServer(_ads(edges, n)) as srv:
        srv.pause()
        key = srv.engine._canonical_schedule("auto")
        r4 = srv._submit("distance_histogram", (4, "auto", key))
        r2 = srv._submit("distance_histogram", (2, "ring", key))
        rc = srv._submit("closeness", (4, "auto", key))
        re = srv._submit("effective_diameter", (4, 0.9, "auto", key))
        srv.resume()
        h4, g4 = r4.wait()
        h2, g2 = r2.wait()
        close, eff = rc.wait(), re.wait()
        stats = srv.stats()
        with pytest.raises(Exception, match="not served"):
            srv.union_size([[0, 1]])
    np.testing.assert_array_equal(h4, want_h)
    np.testing.assert_array_equal(g4, want_g)
    np.testing.assert_array_equal(h2, want_h[:2])
    np.testing.assert_array_equal(g2, want_g[:2])
    np.testing.assert_array_equal(close, direct.closeness(4))
    assert eff == direct.effective_diameter(4, q=0.9)
    assert stats["distance_histogram"]["batches"] == 1
    assert stats["access"]["totals"]["distance_histogram"] == 2
    with jax_serve.QueryServer(ref) as theirs:
        w_h, _ = theirs.distance_histogram(4)
        w_c = theirs.closeness(4)
        w_e = theirs.effective_diameter(4, q=0.9)
    np.testing.assert_allclose(h4, np.asarray(w_h), rtol=1e-5)
    np.testing.assert_allclose(close, np.asarray(w_c), rtol=1e-5)
    assert abs(eff - float(w_e)) <= 1e-6


def test_served_ads_repeat_runs_no_pass_on_an_unchanged_engine(ads_pair):
    edges, n, _ = ads_pair
    with QueryServer(_ads(edges, n)) as srv:
        first, _ = srv.distance_histogram(5)
        plans.reset_event_counts()
        plans.reset_trace_counts()
        again, _ = srv.distance_histogram(5)
        assert plans.event_counts() == {}
        assert plans.trace_counts() == {}
    np.testing.assert_array_equal(first, again)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("extra", [[], ["--continuous", "--stats"],
                                   ["--zipf", "1.3", "--replicate", "8"],
                                   ["--family", "ads"]],
                         ids=["epoch", "continuous", "replicate", "ads"])
def test_sketch_serve_smoke_on_cpu(extra, capsys):
    sketch_serve.main(["--smoke", "--device", "cpu", *extra])
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert "OK: plan count within the O(log batch) bound" in out
    if "--continuous" in extra:
        assert "OK: served answers bit-identical to direct engine calls" \
            in out
        assert '"snapshot"' in out  # the --stats dump
    if "--replicate" in extra:
        assert "served answers bit-identical pre/post" in out


def test_sketch_serve_impl_flag(capsys):
    """``--impl ref`` serves from the plain versions; an unknown impl is
    refused by the argument parser before any work."""
    sketch_serve.main(["--smoke", "--device", "cpu", "--impl", "ref"])
    out = capsys.readouterr().out
    assert "impl=ref" in out
    assert "OK: plan count within the O(log batch) bound" in out
    with pytest.raises(SystemExit) as exc:
        sketch_serve.main(["--smoke", "--device", "cpu", "--impl", "pallas"])
    assert exc.value.code == 2
    assert "invalid choice: 'pallas'" in capsys.readouterr().err


def test_sketch_serve_refuses_a_sharded_request(capsys):
    """A sharding request the launcher cannot honour fails before any work,
    as the JAX launcher's flags do: ``--shards`` without ``--backend
    sharded``, and a backend that does not exist. (``--backend sharded``
    itself is served: ``tests/test_torch_sharded.py``.)"""
    for argv, msg in (
            (["--smoke", "--device", "cpu", "--shards", "2"],
             "--shards only applies to --backend sharded"),
            (["--smoke", "--device", "cpu", "--backend", "mesh"],
             "invalid choice")):
        with pytest.raises(SystemExit) as exc:
            sketch_serve.main(argv)
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err
