"""Load generators on the port (``repro_torch.serve.loadgen``): outcome
classification, determinism, report math — the cases of
``tests/test_loadgen.py`` — and the samplers' draws equal to
``repro.serve.loadgen``'s for the same seed (exact: the same numpy code
on the same generator). Every generator run here joins its threads
before it returns; the thunks never block.
"""
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve import loadgen as jax_loadgen  # noqa: E402
from repro_torch.serve.frontend import DeadlineExceeded, Overloaded  # noqa: E402
from repro_torch.serve.loadgen import (LoadReport, ZipfSampler,  # noqa: E402
                                       closed_loop, open_loop, request_mix,
                                       sample_vertices)


def test_closed_loop_counts_and_determinism():
    calls = []
    mix = [("a", lambda: calls.append("a")), ("b", lambda: calls.append("b"))]
    rep1 = closed_loop(mix, clients=3, requests_per_client=10, seed=7)
    assert len(rep1.records) == 30
    assert all(s == "ok" for _, s, _ in rep1.records)
    # same seed -> same per-client kind sequences (arrival order may vary)
    rep2 = closed_loop(mix, clients=3, requests_per_client=10, seed=7)
    assert (sorted(k for k, _, _ in rep1.records)
            == sorted(k for k, _, _ in rep2.records))


def test_outcome_classification():
    def shed():
        raise Overloaded("full")

    def late():
        raise DeadlineExceeded("late")

    def broken():
        raise ValueError("bad request")

    mix = [("shed", shed), ("late", late), ("broken", broken),
           ("ok", lambda: None)]
    rep = closed_loop(mix, clients=2, requests_per_client=20, seed=0)
    s = rep.summary()
    assert s["requests"] == 40
    by = {}
    for kind, status, _ in rep.records:
        by.setdefault(kind, set()).add(status)
    assert by["shed"] == {"shed"} and by["late"] == {"deadline"}
    assert by["broken"] == {"error"} and by["ok"] == {"ok"}
    assert s["served"] + s["shed"] + s["deadline_misses"] + s["errors"] == 40
    assert s["shed_rate"] == pytest.approx(s["shed"] / 40)


def test_open_loop_offered_rate():
    mix = [("noop", lambda: None)]
    rep = open_loop(mix, rate=200.0, duration=0.5, seed=1)
    s = rep.summary()
    # Poisson arrivals at 200/s over 0.5s: ~100 requests, generously
    # bounded (the assertion is about the arrival process running at
    # all, not its exact realization)
    assert 30 <= s["requests"] <= 300
    assert s["offered_qps"] == pytest.approx(
        s["requests"] / rep.span_seconds)


def test_summary_percentile_math():
    rep = LoadReport()
    for ms in (1.0, 2.0, 3.0, 4.0, 100.0):
        rep._note("k", "ok", ms / 1e3)
    rep.span_seconds = 1.0
    s = rep.summary()
    assert s["p50_ms"] == pytest.approx(3.0)
    assert s["p999_ms"] <= 100.0 + 1e-6
    assert s["achieved_qps"] == pytest.approx(5.0)
    assert s["mean_ms"] == pytest.approx(22.0)


def test_summary_excludes_failures_from_percentiles():
    rep = LoadReport()
    rep._note("k", "ok", 0.001)
    rep._note("k", "shed", 10.0)  # must NOT pollute the percentiles
    rep.span_seconds = 1.0
    s = rep.summary()
    assert s["p99_ms"] == pytest.approx(1.0)
    assert s["shed"] == 1 and s["served"] == 1


def test_validation():
    with pytest.raises(ValueError):
        closed_loop([], clients=1, requests_per_client=1)
    with pytest.raises(ValueError):
        open_loop([("a", lambda: None)], rate=0.0, duration=1.0)
    with pytest.raises(ValueError):
        open_loop([("a", lambda: None)], rate=1.0, duration=0.0)
    with pytest.raises(ValueError):
        open_loop([], rate=1.0, duration=1.0)


def test_latency_is_measured():
    mix = [("sleepy", lambda: time.sleep(0.01))]
    rep = closed_loop(mix, clients=1, requests_per_client=3)
    assert all(lat >= 0.01 for _, _, lat in rep.records)
    assert rep.summary()["p50_ms"] >= 10.0


# ----------------------------------------------------- Zipfian key sampling
def test_zipf_sampler_range_skew_determinism():
    n = 1000
    zs = ZipfSampler(n, s=1.2)
    ids = zs.sample(np.random.default_rng(0), 20000)
    assert ids.dtype == np.int64
    assert ids.min() >= 0 and ids.max() < n
    counts = np.bincount(ids, minlength=n)
    # hot ranks dominate: the top 1% of ids outweigh the bottom half
    assert counts[: n // 100].sum() > counts[n // 2:].sum()
    # rank order: id 0 is the hottest
    assert counts[0] == counts.max()
    # deterministic given the caller's RNG
    again = zs.sample(np.random.default_rng(0), 20000)
    np.testing.assert_array_equal(ids, again)
    with pytest.raises(ValueError):
        ZipfSampler(0)
    with pytest.raises(ValueError):
        ZipfSampler(10, s=0.0)


def test_sample_vertices_dispatch():
    rng = np.random.default_rng(3)
    u = sample_vertices(rng, 50, (4, 2))
    assert u.shape == (4, 2) and u.min() >= 0 and u.max() < 50
    z1 = sample_vertices(np.random.default_rng(3), 50, 100, dist="zipf", s=2.0)
    z2 = sample_vertices(np.random.default_rng(3), 50, 100, dist="zipf", s=2.0)
    np.testing.assert_array_equal(z1, z2)
    with pytest.raises(ValueError):
        sample_vertices(rng, 50, 3, dist="pareto")


class _RecordingServer:
    """Captures the ids each thunk submits (no engine behind it)."""

    def __init__(self):
        self.union_calls = []
        self.pair_calls = []
        self.degree_calls = 0

    def union_size(self, sets):
        self.union_calls.append(np.asarray(sets))

    def intersection_size(self, pairs):
        self.pair_calls.append(np.asarray(pairs))

    def degrees(self):
        self.degree_calls += 1


def test_request_mix_shapes_and_distribution():
    srv = _RecordingServer()
    mix = request_mix(srv, 200, batch=4, set_size=3, dist="zipf", s=1.5,
                      seed=1, kinds=("union", "intersection", "degrees"))
    assert [k for k, _ in mix] == ["union", "intersection", "degrees"]
    for _, thunk in mix:
        for _ in range(20):
            thunk()
    assert all(c.shape == (4, 3) for c in srv.union_calls)
    assert all(c.shape == (4, 2) for c in srv.pair_calls)
    assert srv.degree_calls == 20
    ids = np.concatenate([c.ravel() for c in srv.union_calls])
    assert ids.min() >= 0 and ids.max() < 200
    counts = np.bincount(ids, minlength=200)
    assert counts[:10].sum() > counts[100:].sum()  # skew reached the wire
    with pytest.raises(ValueError, match="unknown mix kinds"):
        request_mix(srv, 200, kinds=("union", "triangle"))
    with pytest.raises(ValueError, match="dist"):
        request_mix(srv, 200, dist="normal")


def test_request_mix_through_both_generators():
    srv = _RecordingServer()
    mix = request_mix(srv, 100, batch=2, dist="zipf", s=1.2, seed=4)
    rep = closed_loop(mix, clients=2, requests_per_client=10, seed=5)
    assert rep.summary()["errors"] == 0
    rep = open_loop(mix, rate=150.0, duration=0.2, seed=6)
    assert rep.summary()["errors"] == 0
    assert srv.union_calls or srv.pair_calls


@pytest.mark.parametrize("n,s", [(1000, 1.2), (50, 2.0), (4096, 0.8)])
def test_samplers_match_jax(n, s):
    got = ZipfSampler(n, s).sample(np.random.default_rng(9), 5000)
    want = jax_loadgen.ZipfSampler(n, s).sample(np.random.default_rng(9),
                                                5000)
    np.testing.assert_array_equal(got, want)
    for dist in ("uniform", "zipf"):
        np.testing.assert_array_equal(
            sample_vertices(np.random.default_rng(2), n, (7, 3), dist=dist,
                            s=s),
            jax_loadgen.sample_vertices(np.random.default_rng(2), n, (7, 3),
                                        dist=dist, s=s))


def test_summary_matches_jax():
    records = [("k", "ok", 0.001 * i) for i in range(1, 40)]
    records += [("k", "shed", 0.5), ("k", "deadline", 0.2),
                ("k", "error", 0.1)]
    mine, theirs = LoadReport(), jax_loadgen.LoadReport()
    for rec in records:
        mine._note(*rec)
        theirs._note(*rec)
    mine.span_seconds = theirs.span_seconds = 2.0
    assert mine.summary() == theirs.summary()
