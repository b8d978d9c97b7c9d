"""The port's spans (``repro_torch.tracing``) on a small CPU engine.

With no profile running a span is one shared null context and never
reaches ``record_function``; under ``torch.profiler`` the exported
Chrome trace holds each layer boundary's span, nested and counted as the
engine runs them, and the answers do not depend on whether a profile is
running.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import engine, tracing  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.engine.base import SketchEngine  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import inputs  # noqa: E402

LAYOUTS = ["byte", "packed"]
SCALE, T_MAX = 9, 3
#: undirected edges a chunk here, so an ingest runs several chunks
CHUNK = 1_000
#: directed edges a routing slice here, so the routing runs several slices
SLICE = 2_048
#: rounding of the trace's microsecond times
EPS_US = 1.0


@pytest.fixture(scope="module")
def graph():
    edges = generators.rmat(SCALE, 8, seed=3)
    pairs = edges[np.random.default_rng(5).integers(0, len(edges), 64)]
    return edges, 1 << SCALE, pairs


def _job(edges, n, pairs, layout):
    """build -> neighborhood(T_MAX) -> intersection_size(MLE)."""
    eng = engine.build(edges, n, HLLConfig(p=8), layout=layout, device="cpu")
    local, glob = eng.neighborhood(T_MAX)
    mle = eng.intersection_size(pairs, method="mle")
    return eng.regs.clone(), local, glob, mle


def _spans(prof, tmp_path) -> list:
    """The exported trace's user spans, (name, start, end, tid), by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"],
                    e["tid"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def _inside(child, parent) -> bool:
    return (child[3] == parent[3] and child[1] >= parent[1] - EPS_US
            and child[2] <= parent[2] + EPS_US)


def _named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_off_is_free_and_never_records(graph, layout, monkeypatch):
    """No profile: the shared null context, and ``record_function`` is
    never reached (patched to raise, the whole job still runs)."""
    assert not torch.autograd.profiler._is_profiler_enabled
    off = tracing.span("engine.ingest")
    assert off is tracing.span("intersection.newton")
    with off:
        pass

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profile")
    monkeypatch.setattr(tracing, "record_function", refuse)
    plans.global_cache().clear()
    regs, local, glob, mle = _job(*graph, layout)
    assert local.shape == (T_MAX, graph[1]) and np.isfinite(mle).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spans_nest_and_count_under_the_profiler(graph, layout, tmp_path,
                                                 monkeypatch):
    edges, n, pairs = graph
    monkeypatch.setattr(SketchEngine, "INGEST_BLOCK", CHUNK)
    monkeypatch.setattr(inputs, "ROUTING_SLICE", SLICE)
    plans.global_cache().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert isinstance(tracing.span("engine.ingest"),
                          torch.profiler.record_function)
        _job(edges, n, pairs, layout)
    assert not torch.autograd.profiler._is_profiler_enabled
    spans = _spans(prof, tmp_path)
    names = {s[0] for s in spans}
    assert all("." in name and name != "step" for name in names)

    # ingest: the id check and every chunk inside the one ingest
    (ingest,) = _named(spans, "engine.ingest")
    checks = [s for s in _named(spans, "engine.check_ids")
              if _inside(s, ingest)]
    assert len(checks) == 1
    chunks = _named(spans, "ingest.chunk")
    assert len(chunks) == -(-len(edges) // CHUNK) > 1
    assert all(_inside(c, ingest) for c in chunks)

    # neighborhood: the edge list once, the routing inside the first pass
    assert len(_named(spans, "engine.edges")) == 1
    passes = _named(spans, "propagate.pass")
    assert len(passes) == T_MAX - 1
    (routing,) = _named(spans, "routing.build")
    assert _inside(routing, passes[0]) and not _inside(routing, passes[1])
    (h2d,) = _named(spans, "routing.h2d")
    slices = _named(spans, "routing.slice")
    assert _inside(h2d, routing) and len(slices) >= 2
    assert all(_inside(s, routing) and s[1] >= h2d[2] - EPS_US
               for s in slices)
    estimates = _named(spans, "engine.estimate")
    assert len(estimates) == T_MAX
    assert estimates[0][1] >= passes[-1][2] - EPS_US

    # pairs: prepare, stats, Newton, copy back, in that order
    order = [s for s in spans if s[0] in ("pairs.prepare", "pairs.stats",
                                          "intersection.newton",
                                          "pairs.copy_back")]
    assert [s[0] for s in order] == ["pairs.prepare", "pairs.prepare",
                                     "pairs.stats", "intersection.newton",
                                     "pairs.copy_back"]
    assert all(a[2] <= b[1] + EPS_US for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_answers_equal_with_and_without_the_profiler(graph, layout):
    plans.global_cache().clear()
    plain = _job(*graph, layout)
    plans.global_cache().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _job(*graph, layout)
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1:], traced[1:]):
        np.testing.assert_array_equal(a, b)


def test_sharded_passes_are_spans_too(graph, tmp_path):
    """``propagate.pass`` is the base class's, so the sharded backend's
    passes are marked as the local one's."""
    edges, n, _ = graph
    eng = engine.build(edges, n, HLLConfig(p=8), backend="sharded",
                       shards=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.neighborhood(T_MAX)
    spans = _spans(prof, tmp_path)
    assert len(_named(spans, "propagate.pass")) == T_MAX - 1
    assert len(_named(spans, "engine.estimate")) == T_MAX
