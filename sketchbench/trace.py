"""The traced run's profiler trace, reduced to what the readers need.

``torch.profiler`` writes a Chrome trace: device operations (kernels,
memory copies and sets, with their bytes), the host's operator ranges and
the benchmark's own ``record_function`` spans, on one clock. The traced
window runs from the first profiled step's ``step`` span to the last
one's end. Times are kept in microseconds, as the trace gives them, and
reported in seconds.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

#: trace categories that are operations on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries of each breakdown list
TOP = 10


def _outermost(ranges: list) -> list:
    """The ranges (start, end, name) not inside an earlier one, sorted."""
    out = []
    for r in sorted(ranges):
        if not out or r[0] >= out[-1][1]:
            out.append(r)
    return out


def _covering(ranges: list, starts: list, t: float):
    """The name of the range of sorted, disjoint ``ranges`` holding t."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and ranges[i][1] > t:
        return ranges[i][2]
    return None


class Trace:
    """Device operations, host ranges and benchmark spans of one window."""

    def __init__(self, events: list):
        self.ops = []      # (start, end, name, cat, bytes)
        steps, spans, host = [], [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts = e.get("cat"), float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.ops.append((ts, end, e["name"], cat,
                                 (e.get("args") or {}).get("bytes", 0)))
            elif cat == "user_annotation":
                (steps if e["name"] == "step" else spans).append(
                    (ts, end, e["name"]))
            elif cat == "cpu_op":
                host.append((ts, end, e["name"]))
        self.n_steps = len(steps)
        self.start = min((s[0] for s in steps), default=0.0)
        self.end = max((s[1] for s in steps), default=0.0)
        self.ops = sorted(o for o in self.ops
                          if o[1] > self.start and o[0] < self.end)
        self.spans = sorted(spans)
        self.host = _outermost(host)
        self._host_starts = [h[0] for h in self.host]

    @classmethod
    def from_file(cls, path) -> "Trace":
        """Read a Chrome trace written by ``export_chrome_trace``."""
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f)["traceEvents"])

    @property
    def window_s(self) -> float:
        """Length of the traced window, seconds."""
        return (self.end - self.start) / 1e6

    def _busy_intervals(self) -> list:
        merged = []
        for s, e, *_ in self.ops:
            s, e = max(s, self.start), min(e, self.end)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return sum(e - s for s, e in self._busy_intervals()) / 1e6

    def gaps(self) -> list:
        """Idle intervals (start, end) of the device inside the window."""
        out, at = [], self.start
        for s, e in self._busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    def device_s(self, names: tuple = (), cats: tuple = DEVICE_CATS) -> float:
        """Summed device seconds of the operations of ``cats`` whose name
        holds one of ``names`` (every name when empty)."""
        return sum(e - s for s, e, name, cat, _ in self.ops
                   if cat in cats and (not names
                                       or any(k in name for k in names))) / 1e6

    def count(self, cat: str) -> int:
        """Device operations of category ``cat`` in the window."""
        return sum(1 for o in self.ops if o[3] == cat)

    def copy_bytes(self, direction: str) -> int:
        """Bytes of the memory copies whose name holds ``direction``
        (``"HtoD"``, ``"DtoH"``, ``"DtoD"``)."""
        return sum(int(b) for _, _, name, cat, b in self.ops
                   if cat == "gpu_memcpy" and direction in name)

    def _label(self, t: float) -> str:
        span = None
        for s, e, name in self.spans:
            if s > t:
                break
            if e > t:
                span = name   # the innermost span open at t
        op = _covering(self.host, self._host_starts, t)
        return f"{span or 'between calls'}: {op or 'python'}"

    def breakdown(self) -> dict:
        """The device operations with the most time, by name, and the idle
        time by what the host was doing (the benchmark span open and the
        host operator running), seconds."""
        by_op = defaultdict(float)
        for s, e, name, *_ in self.ops:
            by_op[name] += (min(e, self.end) - max(s, self.start)) / 1e6
        idle = defaultdict(float)
        for s, e in self.gaps():
            idle[self._label((s + e) / 2)] += (e - s) / 1e6
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}
