"""The program's own spans in a traced run, for the per-layer readers.

The program marks its layer boundaries with dotted ``record_function``
ranges while a profile runs (``repro_torch.tracing``); the exported
Chrome trace holds them as ``user_annotation`` events on the clock of
the device operations. Two readings, each a profiled step's average:

* :func:`host_ms`: the summed host duration of the spans of one name;
* :func:`device_ms`: the summed device time of the operations launched
  inside the spans of one name, on the span's thread. A device operation
  names its ``cuda_runtime`` / ``cuda_driver`` launch by the
  ``correlation`` argument both carry; ``Trace`` drops that link, so this
  re-reads the trace file that ``loops/closed.py`` exported. An operation
  counts in full where its launch lies inside the span, also when it
  runs after the span has ended.

Both return ``None`` where there is nothing to read: no traced run, no
span of that name (a program without it), or no device operation in
the trace (a run on the CPU).
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

from sketchbench.trace import DEVICE_CATS, _outermost

#: trace categories of the host calls that launch device operations
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_path(run) -> Path:
    """The Chrome trace the traced run exported (``loops/closed.py``)."""
    return Path(run.ctx.root) / "build" / "sketchbench" / \
        f"{run.cell.name}.trace.json"


def host_ms(run, name: str) -> float | None:
    """Summed duration of the spans ``name`` inside the traced window, ms
    a profiled step (nested spans of the same name counted once)."""
    tr = run.trace
    if tr is None or not tr.n_steps:
        return None
    ranges = [(max(s, tr.start), min(e, tr.end), n) for s, e, n in tr.spans
              if n == name and e > tr.start and s < tr.end]
    if not ranges:
        return None
    return sum(e - s for s, e, _ in _outermost(ranges)) / 1e3 / tr.n_steps


def device_ms(run, name: str) -> float | None:
    """Summed device time of the operations launched inside the spans
    ``name``, ms a profiled step."""
    tr = run.trace
    path = trace_path(run)
    if tr is None or not tr.n_steps or not tr.ops or not path.exists():
        return None
    with open(path, encoding="utf-8") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, launches, ops = defaultdict(list), {}, []
    for e in events:
        cat, ts = e.get("cat"), float(e.get("ts", 0.0))
        where = (e.get("pid"), e.get("tid"))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name") == name:
            spans[where].append((ts, ts + float(e.get("dur", 0.0)), name))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (where, ts)
        elif cat in DEVICE_CATS and corr is not None:
            ops.append((corr, float(e.get("dur", 0.0))))
    if not spans:
        return None
    outer = {k: _outermost(v) for k, v in spans.items()}
    starts = {k: [s for s, *_ in v] for k, v in outer.items()}
    total = 0.0
    for corr, dur in ops:
        where, ts = launches.get(corr, (None, None))
        if where not in outer:
            continue
        i = bisect.bisect_right(starts[where], ts) - 1
        if i >= 0 and ts <= outer[where][i][1]:
            total += dur
    return total / 1e3 / tr.n_steps
