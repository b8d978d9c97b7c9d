"""The closed loop: one client, each step sent when the one before has
answered.

A traffic file for it holds:

* ``engine``: ``"setup"`` (one engine built in set-up serves every step)
  or ``"step"`` (each step builds its own; the step before's engine is
  dropped first, so the peak is one step's);
* ``calls``: the calls of one step, in order. ``call`` is ``"build"``
  (``engine.build`` of the whole graph) or a method of the engine;
  ``args`` / ``kwargs`` are literals or generated (``{"gen": ...}``);
  ``span`` names the benchmark's span around it (a host clock ending in
  a device synchronize, and a ``record_function`` range for the trace);
  ``check`` names the check that judges its output in the last step;
* ``work``: the units of work one step completes (requests, pairs);
* ``warmup_steps``: steps run in set-up, each shape warmed there;
* ``profile_steps``: whole steps the traced run profiles, in the middle
  of the window.

The window starts after set-up and no step starts after ``seconds``; the
window ends when the last step does.
"""
from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

from sketchbench import harness
from sketchbench.trace import Trace


@dataclass
class State:
    """The engine the steps call, and what set-up learnt."""

    engine: object = None
    warm_step_s: float = 0.0
    next_index: int = 0


@dataclass
class Window:
    """The measured window's steps and readings."""

    setup_s: float
    start: float
    end: float
    steps: list
    peak_bytes: int
    trace: object = None


def _step(ctx, traffic: dict, state: State, index: int) -> harness.Step:
    torch = ctx.device.torch
    record_function = torch.profiler.record_function
    step = harness.Step(work=float(traffic["work"]))
    if traffic["engine"] == "step":
        state.engine = None
    calls = [harness.CallRecord(
        spec, [ctx.arg(a, index) for a in spec.get("args", [])],
        {k: ctx.arg(v, index) for k, v in spec.get("kwargs", {}).items()})
        for spec in traffic["calls"]]
    step.start = time.perf_counter()
    try:
        with record_function("step"):
            for rec in calls:
                with record_function(rec.spec["span"]):
                    t0 = time.perf_counter()
                    if rec.spec["call"] == "build":
                        state.engine = ctx.build()
                    else:
                        rec.result = getattr(state.engine, rec.spec["call"])(
                            *rec.args, **rec.kwargs)
                    ctx.device.sync()
                    step.spans[rec.spec["span"]] = time.perf_counter() - t0
    except Exception:  # a failed step is counted, and the run goes on
        traceback.print_exc(file=sys.stderr)
        step.failed = True
    step.end = time.perf_counter()
    step.calls = calls
    return step


def setup(ctx, traffic: dict) -> State:
    """Build the set-up engine, if any, have the generators make every
    argument the window will take, and run the warm-up steps."""
    state = State()
    if traffic["engine"] == "setup":
        state.engine = ctx.build()
        ctx.device.sync()
    ctx.reserve(traffic["calls"])
    for _ in range(int(traffic["warmup_steps"])):
        step = _step(ctx, traffic, state, state.next_index)
        state.next_index += 1
        state.warm_step_s = step.end - step.start
    return state


def run(ctx, traffic: dict, state: State, seconds: float, trace: bool,
        t_start: float) -> Window:
    """The measured window; in a traced run ``profile_steps`` whole steps
    in its middle run under ``torch.profiler``."""
    torch = ctx.device.torch
    n_prof = int(traffic["profile_steps"]) if trace else 0
    skip = max(1, int(seconds / max(state.warm_step_s, 1e-3) / 2)
               - n_prof // 2) if trace else 0
    prof = None
    ctx.device.sync()
    ctx.device.reset_peak()
    start = time.perf_counter()
    setup_s = start - t_start
    steps = []
    while (time.perf_counter() - start < seconds
           or len(steps) < max(1, skip + n_prof)):
        i = len(steps)
        if trace and i == skip:
            prof = _profiler(torch, ctx.device.is_cuda)
            prof.start()
        step = _step(ctx, traffic, state, state.next_index)
        state.next_index += 1
        step.profiled = prof is not None and skip <= i < skip + n_prof
        if steps:  # only the last step's outputs are judged
            for rec in steps[-1].calls:
                rec.result = None
                if not steps[-1].profiled:
                    rec.args, rec.kwargs = [], {}
        steps.append(step)
        if prof is not None and i == skip + n_prof - 1:
            prof.stop()
    end = steps[-1].end
    peak = ctx.device.peak_bytes()
    parsed = None
    if prof is not None:
        path = Path(ctx.root) / "build" / "sketchbench" / \
            f"{ctx.cell.name}.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        del prof
        parsed = Trace.from_file(path)
    return Window(setup_s=setup_s, start=start, end=end, steps=steps,
                  peak_bytes=peak, trace=parsed)


def _profiler(torch, cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)
