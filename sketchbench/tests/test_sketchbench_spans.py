"""The readers of the program's spans (``sketchbench/spans.py`` and the
six metrics on it) against a hand-written Chrome trace whose answers are
known: nested spans, launches and device operations linked by
``correlation``, a launch outside its span, one on another thread, and a
kernel that runs after its span has ended but was launched inside it.
Each reader returns ``None`` without a trace, and without its span."""
from __future__ import annotations

import json
import types

import pytest

from conftest import ROOT
from sketchbench import harness, spans
from sketchbench.trace import Trace

PID, MAIN, OTHER = 7, 1, 2
HOPS = ("check_ids_ms.hops", "edges_concat_ms.hops", "routing_ms.hops",
        "estimate_ms.hops")
PAIRS = ("newton_host_ms.pairs", "newton_device_ms.pairs")


def _x(name, cat, ts, dur, tid=MAIN, pid=PID, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def _span(name, ts, dur, tid=MAIN):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr, tid=MAIN, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _x(name, cat, ts, 5, tid, correlation=corr)


def _op(ts, dur, corr, cat="kernel", name="k"):
    return _x(name, cat, ts, dur, tid=9, pid=0, correlation=corr)


def _events() -> list:
    """Two steps of 1,000 us. Known sums (us, over both steps):
    engine.check_ids 50 + 30; engine.edges 200 + 0; routing.build 120
    with a nested routing.build of 20 counted once; engine.estimate 3 x
    10 + 40; intersection.newton 400 + 100 on the host, and on the device
    100 (kernel) + 80 (a kernel after the span's end) + 20 (a copy) + 40
    (a `cuLaunchKernel`) = 240, leaving out a launch after the span and one
    on another thread."""
    return [
        _span("step", 0, 1000), _span("step", 1000, 1000),
        # the benchmark's own span around the call, outside every program span
        _span("build", 10, 480),
        _span("engine.ingest", 20, 380),
        _span("engine.check_ids", 100, 50),
        _span("ingest.chunk", 160, 100),
        _span("engine.check_ids", 1100, 30),
        _span("engine.edges", 500, 200),
        _span("routing.build", 710, 120),
        _span("routing.build", 720, 20),       # nested, same name
        _span("engine.estimate", 840, 10), _span("engine.estimate", 860, 10),
        _span("engine.estimate", 880, 10), _span("engine.estimate", 1500, 40),
        _span("intersection.newton", 200, 400),
        _launch(250, 1), _op(300, 100, 1),
        _launch(590, 2), _op(620, 80, 2),      # runs after the span's end
        _launch(650, 3), _op(700, 50, 3),      # launched after it
        _launch(300, 4, tid=OTHER), _op(400, 30, 4),   # another thread
        _launch(400, 5, name="cudaMemcpyAsync"),
        _op(450, 20, 5, cat="gpu_memcpy", name="Memcpy DtoH"),
        _span("intersection.newton", 1200, 100),
        _launch(1210, 6, cat="cuda_driver", name="cuLaunchKernel"),
        _op(1220, 40, 6),
        _op(1800, 10, 99),                      # no launch in the trace
    ]


def _run(tmp_path, events, write: bool = True):
    cell = types.SimpleNamespace(name="demo.cell")
    run = types.SimpleNamespace(cell=cell, ctx=types.SimpleNamespace(
        root=tmp_path), trace=Trace(events) if events is not None else None)
    if write and events is not None:
        path = spans.trace_path(run)
        path.parent.mkdir(parents=True)
        path.write_text(json.dumps({"traceEvents": events}))
    return run


def _read(metric, run):
    return harness.load_module(harness.BENCH_DIR / "metrics"
                               / f"{metric}.py").read(run)


@pytest.mark.parametrize("metric,want_us", [
    ("check_ids_ms.hops", 80), ("edges_concat_ms.hops", 200),
    ("routing_ms.hops", 120), ("estimate_ms.hops", 70),
    ("newton_host_ms.pairs", 500), ("newton_device_ms.pairs", 240)])
def test_reader_reads_its_known_value(tmp_path, metric, want_us):
    got = _read(metric, _run(tmp_path, _events()))
    assert got == pytest.approx(want_us / 1e3 / 2)


@pytest.mark.parametrize("metric", HOPS + PAIRS)
def test_reader_without_a_trace_is_none(tmp_path, metric):
    assert _read(metric, _run(tmp_path, None)) is None


@pytest.mark.parametrize("metric", HOPS + PAIRS)
def test_reader_without_its_span_is_none(tmp_path, metric):
    """A program without the spans, as the parent's: nothing to read."""
    names = {"engine.check_ids", "engine.edges", "routing.build",
             "engine.estimate", "intersection.newton"}
    events = [e for e in _events() if e["name"] not in names]
    assert _read(metric, _run(tmp_path, events)) is None


def test_device_reading_needs_the_exported_file(tmp_path):
    assert spans.device_ms(_run(tmp_path, _events(), write=False),
                           "intersection.newton") is None


def test_device_reading_without_device_operations_is_none(tmp_path):
    """A trace taken on the CPU has the spans but no device operation."""
    events = [e for e in _events() if e["cat"] == "user_annotation"]
    run = _run(tmp_path, events)
    assert spans.device_ms(run, "intersection.newton") is None
    assert spans.host_ms(run, "intersection.newton") == pytest.approx(0.25)


def test_new_metrics_are_listed_with_their_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in HOPS:
        assert layer[name]["workloads"] == ["g500-24p.hops", "g500-22.hops"]
        assert layer[name]["moves"] == "hop_job_ms"
    for name in PAIRS:
        assert layer[name]["workloads"] == ["g500-22.pairs"]
        assert layer[name]["moves"] == "pair_rate"
    assert all(layer[name]["source"] == "device_trace"
               for name in HOPS + PAIRS)
