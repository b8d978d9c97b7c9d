"""Load generation for the serving layer: open- and closed-loop generators
(copy of ``repro.serve.loadgen``, numpy and threads).

Shared by load benchmarks and the tests; the generators are
server-agnostic — a *mix* is a list of ``(kind, thunk)`` pairs where each
thunk issues one blocking request against whichever server the caller
closed it over (``QueryServer`` or ``ContinuousServer``), so the same
workload definition drives both serving modes side by side.

Two load shapes (they answer different questions):

* **Closed loop** — N clients, each issuing its next request the moment
  the previous one returns. Measures throughput under a fixed
  concurrency; latency and throughput are coupled (a slow server slows
  the offered load, hiding queueing delay).
* **Open loop** — requests arrive on a Poisson process at a fixed
  offered rate regardless of completions, each on its own thread.
  This is the SLO-honest shape: when the server can't keep up, queueing
  delay (and shed/deadline counts) show up in the tail percentiles
  instead of silently lowering the offered rate.

Outcomes are classified per request: ``ok``, ``shed`` (admission
control's ``Overloaded``), ``deadline`` (``DeadlineExceeded``) and
``error``; :meth:`LoadReport.summary` folds them into p50/p99/p999,
achieved qps and shed rate.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.frontend import DeadlineExceeded, Overloaded

__all__ = ["LoadReport", "ZipfSampler", "closed_loop", "open_loop",
           "request_mix", "sample_vertices"]


class ZipfSampler:
    """Rank-skewed vertex sampler: id ``r`` drawn with weight (r+1)^-s.

    The workload shape behind the placement policy (DESIGN.md §12): real
    query streams concentrate on a small hot set, and a Zipf(s) draw over
    vertex ids reproduces that — at s=1.2 the top ~1% of ids absorb most
    of the mass. Sampling is inverse-CDF over the normalized rank
    weights, so draws are deterministic given the caller's RNG and cost
    one ``searchsorted`` per batch.
    """

    def __init__(self, n: int, s: float = 1.2):
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if s <= 0:
            raise ValueError(f"zipf exponent s must be > 0, got {s}")
        self.n, self.s = int(n), float(s)
        w = np.arange(1, n + 1, dtype=np.float64) ** -self.s
        cum = np.cumsum(w)
        self._cdf = cum / cum[-1]  # cdf[-1] == 1.0 exactly

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        """Draw ``size`` ids in [0, n) — low ids are the hot ranks."""
        u = rng.random(size)
        return np.searchsorted(self._cdf, u, side="right").astype(np.int64)


def sample_vertices(rng: np.random.Generator, n: int, size, *,
                    dist: str = "uniform", s: float = 1.2) -> np.ndarray:
    """Draw vertex ids under ``dist`` — "uniform" or "zipf" (exponent s).

    The one-call form of :class:`ZipfSampler` for callers that sample
    once (e.g. picking benchmark query ids); loops should hold a sampler
    to amortize the CDF build.
    """
    if dist == "uniform":
        return rng.integers(0, n, size=size, dtype=np.int64)
    if dist == "zipf":
        return ZipfSampler(n, s).sample(rng, size)
    raise ValueError(f"dist must be 'uniform' or 'zipf', got {dist!r}")


def request_mix(server, n: int, *, batch: int = 8, set_size: int = 3,
                dist: str = "uniform", s: float = 1.2, seed: int = 0,
                kinds=("union", "intersection")):
    """Build a ``(kind, thunk)`` mix with per-request vertex sampling.

    Unlike a hand-rolled mix closed over fixed ids, every thunk call
    redraws its ids from ``dist`` ("uniform" or "zipf" with exponent
    ``s``) at a fixed batch shape — so plan buckets stay warm while the
    *key* distribution exercises the access counters and the placement
    policy (DESIGN.md §12). ``kinds`` picks from "union" (batch sets of
    ``set_size``), "intersection" (batch pairs) and "degrees". Draws are
    serialized on one seeded RNG, so the mix is safe under both
    :func:`closed_loop` threads and :func:`open_loop` dispatch.
    """
    sampler = ZipfSampler(n, s) if dist == "zipf" else None
    if dist not in ("uniform", "zipf"):
        raise ValueError(f"dist must be 'uniform' or 'zipf', got {dist!r}")
    rng = np.random.default_rng(seed)
    lock = threading.Lock()

    def draw(shape):
        with lock:
            if sampler is None:
                return rng.integers(0, n, size=shape, dtype=np.int64)
            return sampler.sample(rng, shape)

    thunks = {
        "union": lambda: server.union_size(draw((batch, set_size))),
        "intersection": lambda: server.intersection_size(draw((batch, 2))),
        "degrees": lambda: server.degrees(),
    }
    unknown = [k for k in kinds if k not in thunks]
    if unknown:
        raise ValueError(f"unknown mix kinds {unknown}; "
                         f"choose from {sorted(thunks)}")
    return [(k, thunks[k]) for k in kinds]


@dataclass
class LoadReport:
    """Outcome of one load-generation run (see :meth:`summary`)."""

    #: per-request (kind, status, latency_seconds) tuples, arrival order
    records: list = field(default_factory=list)
    #: wall-clock span of the run, first submit to last completion
    span_seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def _note(self, kind: str, status: str, latency: float) -> None:
        with self._lock:
            self.records.append((kind, status, latency))

    def summary(self) -> dict:
        """Aggregate the run: counts, tail percentiles, achieved rates.

        Percentiles (``p50_ms``/``p99_ms``/``p999_ms``) cover *served*
        requests only — shed and deadline-missed requests are reported
        through ``shed_rate``/``deadline_misses`` instead, so admission
        control cannot launder tail latency out of the report while the
        drop counts are in plain view.
        """
        ok = [lat for _, status, lat in self.records if status == "ok"]
        lat = np.asarray(ok, dtype=np.float64)
        pct = (lambda q: float(np.percentile(lat, q) * 1e3)
               if lat.size else None)
        n = len(self.records)
        shed = sum(1 for _, s, _ in self.records if s == "shed")
        missed = sum(1 for _, s, _ in self.records if s == "deadline")
        errors = sum(1 for _, s, _ in self.records if s == "error")
        span = self.span_seconds
        return {
            "requests": n,
            "served": len(ok),
            "shed": shed,
            "deadline_misses": missed,
            "errors": errors,
            "shed_rate": (shed / n) if n else 0.0,
            "p50_ms": pct(50),
            "p99_ms": pct(99),
            "p999_ms": pct(99.9),
            "mean_ms": float(lat.mean() * 1e3) if lat.size else None,
            "achieved_qps": (len(ok) / span) if span > 0 else None,
            "offered_qps": (n / span) if span > 0 else None,
        }


def _issue(report: LoadReport, kind: str, thunk) -> None:
    """Run one request thunk, classify its outcome, record the latency."""
    t0 = time.monotonic()
    try:
        thunk()
    except Overloaded:
        report._note(kind, "shed", time.monotonic() - t0)
    except DeadlineExceeded:
        report._note(kind, "deadline", time.monotonic() - t0)
    except Exception:  # noqa: BLE001 — load gen must outlive bad requests
        report._note(kind, "error", time.monotonic() - t0)
    else:
        report._note(kind, "ok", time.monotonic() - t0)


def closed_loop(mix, *, clients: int = 4, requests_per_client: int = 32,
                seed: int = 0) -> LoadReport:
    """Drive ``mix`` from ``clients`` threads, back-to-back per thread.

    Each client draws its request sequence from the mix with its own
    deterministic RNG stream (``seed`` + client id), issues one request
    at a time, and starts the next the moment the previous returns — the
    classic closed loop. Returns the populated :class:`LoadReport`.

    The mix controls the *key* distribution: pass
    ``request_mix(..., dist="zipf", s=...)`` to drive a hot-vertex
    (Zipfian) workload through the same loop.
    """
    if not mix:
        raise ValueError("mix must contain at least one (kind, thunk) pair")
    report = LoadReport()
    start = threading.Barrier(clients + 1)

    def client(cid: int) -> None:
        rng = np.random.default_rng(seed + cid)
        picks = rng.integers(0, len(mix), size=requests_per_client)
        start.wait()
        for p in picks:
            kind, thunk = mix[int(p)]
            _issue(report, kind, thunk)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    report.span_seconds = time.monotonic() - t0
    return report


def open_loop(mix, *, rate: float, duration: float,
              seed: int = 0) -> LoadReport:
    """Drive ``mix`` on a Poisson arrival process at ``rate`` req/s.

    A dispatcher thread draws exponential inter-arrival gaps and fires
    every request on its own thread at its scheduled instant, regardless
    of how earlier requests are doing — so server slowdown surfaces as
    queueing delay in the percentiles (and as shed/deadline outcomes),
    never as silently reduced load. ``duration`` bounds the arrival
    window in seconds; all in-flight requests are joined before the
    report is returned.

    As with :func:`closed_loop`, the key distribution lives in the mix —
    ``request_mix(..., dist="zipf", s=...)`` makes the arrivals Zipfian
    over vertex ids without touching the arrival process.
    """
    if rate <= 0:
        raise ValueError(f"rate must be > 0 req/s, got {rate}")
    if duration <= 0:
        raise ValueError(f"duration must be > 0 s, got {duration}")
    if not mix:
        raise ValueError("mix must contain at least one (kind, thunk) pair")
    rng = np.random.default_rng(seed)
    report = LoadReport()
    threads: list[threading.Thread] = []
    t0 = time.monotonic()
    t_next = t0
    while True:
        t_next += float(rng.exponential(1.0 / rate))
        if t_next - t0 > duration:
            break
        delay = t_next - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        kind, thunk = mix[int(rng.integers(0, len(mix)))]
        th = threading.Thread(target=_issue, args=(report, kind, thunk),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    report.span_seconds = time.monotonic() - t0
    return report
