"""QueryServer: micro-batched, epoch-guarded serving over a SketchEngine
(port of ``repro.serve.server``).

Design (DESIGN.md §3b):

* **One worker thread owns the engine.** Every engine touch — queries
  *and* the in-place ingest steps — happens on the worker, so a query can
  never run concurrently with a write to the register panel. The worker
  makes the engine's device current before its first engine call. The
  ingest/query *epoch* (one tick per ingest barrier) records which
  accumulated state served each request.
* **Micro-batch coalescing.** Pending requests of the same kind are
  drained together and fused into one engine call: union sets concatenate
  into one ragged batch, intersection pairs concatenate per
  ``(method, iters)`` group, degree requests dedupe into a single table
  scan, triangle requests dedupe per ``(k, mode, iters)``, and
  neighborhood requests dedupe per canonical schedule — one engine call
  at the deepest requested horizon rides the t-hop panel cache
  (DESIGN.md §3c) and every request gets its ``t``-prefix. The fused
  batch rides the power-of-two shape buckets of the plan layer, so N
  clients with jittering batch sizes are served by O(log max-batch)
  plans per query kind (``plans.trace_counts``) — and every per-request
  answer is bit-identical to a direct engine call, because the kernels
  and the estimator tail compute each row independently of the batch
  it rides in.
* **Mixed-kind fusion.** Contiguous degrees/union/intersection requests
  coalesce across *kinds* too: the segment is answered by ONE mixed-kind
  plan (``SketchEngine.query_batch``, DESIGN.md §10) with one host copy
  of each input and one readback per kind. Intersection requests join
  the fused plan only when the segment has a single ``(method, iters)``
  group; extra groups are served in the same drain through the per-kind
  plan.
* **Client calls are plain blocking methods**, safe from any thread;
  errors raised by a request (bad ids, edge-free engine, ...) propagate
  to the calling client only, never poisoning the rest of a batch.
* **Shutdown never hangs a client.** ``close()``/``shutdown()`` drain
  the queue before joining the worker; if the worker dies (a
  ``BaseException`` like ``KeyboardInterrupt``/``SystemExit`` escaping a
  drain), every queued-but-unserved future fails with a clear
  :class:`ServerClosed` instead of blocking forever, and later submits
  are rejected the same way.

The batching/serving core (`serve_segment` and friends) is shared with
the continuous-serving frontend (``repro_torch.serve.frontend``,
DESIGN.md §3d), which drives it against read-only snapshot engines
instead of the live writer. Every engine call of both servers runs on
PyTorch's current stream of the engine's device, so a panel that a
rotation frees while a reader's kernel is still queued is reused only
after that kernel (the caching allocator orders reuse on the stream).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.engine import placement, plans
from repro_torch.engine.base import validate_t_max

__all__ = ["QueryServer", "ServerClosed", "device_scope", "note_access",
           "to_native"]

_LATENCY_WINDOW = 8192  # per-kind latency samples kept for the stats

#: kinds the mixed-kind fused plan (DESIGN.md §10) can answer — a
#: contiguous drained run of these coalesces into one segment and, when
#: at least two kinds are present, one plan.
_FUSABLE = ("degrees", "union", "intersection")

#: latency histogram bucket upper bounds (milliseconds): log-spaced from
#: 0.25ms to ~16s; anything slower lands in the +inf bucket. Log spacing
#: keeps the histogram meaningful across the 1000x spread between a
#: degree lookup and a first neighborhood query.
_HIST_EDGES_MS = tuple(0.25 * 2 ** k for k in range(17)) + (float("inf"),)


def device_scope(device: torch.device):
    """Make ``device`` current in the calling thread when it is a card.

    Server threads enter it before their first engine call, so every
    kernel they launch runs on the engine's device whatever device a new
    thread would start on.
    """
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_native(obj):
    """Recursively convert numpy scalars/arrays into native Python types.

    The stats boundary: every ``stats()`` snapshot passes through here so
    the dicts hold only ``int``/``float``/``str``/``list``/``dict`` and
    serialize with a plain ``json.dumps`` — no ``default=str`` escape
    hatch silently stringifying ``np.int64`` counters into unparseable
    ``"123"`` values (the bug that motivated this sanitizer). Unknown
    types pass through untouched so a genuinely unserializable value
    still fails loudly at the json layer.
    """
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_native(v) for v in obj]
    return obj


class ServerClosed(RuntimeError):
    """Raised by client calls after ``close`` or after the worker died.

    Also *delivered* to any queued-but-unserved request when the server
    shuts down or its worker thread crashes — a pending future never
    hangs forever (DESIGN.md §3b).
    """


@dataclass
class _Request:
    """One client request in flight (internal)."""

    kind: str
    payload: tuple
    done: threading.Event = field(default_factory=threading.Event)
    result: object = None
    error: BaseException | None = None
    t_submit: float = 0.0
    t_done: float = 0.0
    epoch: int = -1  # ingest epoch / snapshot version that served this
    deadline: float | None = None  # absolute time.monotonic() cutoff

    def wait(self):
        """Block until served; re-raise the request's error in the client."""
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.result


class _KindStats:
    """Per-kind serving counters: window percentiles + latency histogram."""

    __slots__ = ("requests", "batches", "max_coalesced", "latencies",
                 "hist")

    def __init__(self, window: int):
        self.requests = 0
        self.batches = 0
        self.max_coalesced = 0
        self.latencies: deque = deque(maxlen=window)
        self.hist = [0] * len(_HIST_EDGES_MS)

    def observe(self, run: list[_Request], now: float) -> None:
        """Fold one served same-kind run into the counters."""
        self.requests += len(run)
        self.batches += 1
        self.max_coalesced = max(self.max_coalesced, len(run))
        for r in run:
            r.t_done = now
            lat = now - r.t_submit
            self.latencies.append(lat)
            ms = lat * 1e3
            for i, edge in enumerate(_HIST_EDGES_MS):
                if ms <= edge:
                    self.hist[i] += 1
                    break

    def snapshot(self) -> dict:
        """Stats dict: counters, p50/p99/p999 and the non-empty buckets."""
        lat = np.asarray(self.latencies, dtype=np.float64)
        pct = (lambda q: float(np.percentile(lat, q) * 1e3)
               if lat.size else None)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "max_coalesced": self.max_coalesced,
            "p50_ms": pct(50),
            "p99_ms": pct(99),
            "p999_ms": pct(99.9),
            "histogram_ms": [[edge, n] for edge, n
                             in zip(_HIST_EDGES_MS, self.hist) if n],
        }


def _note_served(stats: dict, seg: list[_Request], now: float,
                 window: int) -> None:
    """Record one served segment into a {kind: _KindStats} map."""
    for kind in dict.fromkeys(r.kind for r in seg):
        run = [r for r in seg if r.kind == kind]
        stats.setdefault(kind, _KindStats(window)).observe(run, now)


def note_access(access: placement.AccessStats, seg: list[_Request]) -> None:
    """Fold one drained segment's vertex touches into ``access``.

    Union/intersection requests count one access per queried vertex id
    (the gather kinds the placement policy replicates for); table-scan
    kinds (degrees, neighborhood / triangle, and the HIP distance
    queries) and barriers count one access per request — every serveable
    kind must be registered in ``placement.ID_KINDS`` or ``SCAN_KINDS``,
    so an unregistered kind raises here instead of losing its traffic
    silently. Called on the single serving thread right after
    each segment is served — the cheap, lock-free aggregation point the
    hot-vertex placement decision reads from (DESIGN.md §12). Shared by
    the epoch-barrier worker and the continuous frontend's reader.
    """
    for r in seg:
        if r.kind == "union":
            for s in r.payload[0]:
                access.note_ids("union", s)
        elif r.kind == "intersection":
            access.note_ids("intersection", r.payload[0])
        else:
            access.note_query(r.kind)


# --------------------------------------------------------- serving core
# Module-level so the continuous frontend (DESIGN.md §3d) drives the
# exact same coalescing paths against read-only snapshot engines; the
# caller supplies the engine, the epoch tag, and owns stats + wakeups.

def _segments(batch: list[_Request]) -> list[list[_Request]]:
    """Split a drained batch into contiguous serveable segments.

    Same-kind requests coalesce; additionally, adjacent requests whose
    kinds are all in :data:`_FUSABLE` merge into one mixed segment for
    the fused plan. Arrival order is preserved across segments (an
    ingest between two query runs stays between them — that is the
    epoch barrier).
    """
    segs: list[list[_Request]] = []
    for r in batch:
        if segs and (r.kind == segs[-1][-1].kind
                     or (r.kind in _FUSABLE
                         and segs[-1][-1].kind in _FUSABLE)):
            segs[-1].append(r)
        else:
            segs.append([r])
    return segs


def _fail(run: list[_Request], err: BaseException) -> None:
    for r in run:
        if not r.done.is_set() and r.error is None and r.result is None:
            r.error = err


def serve_segment(eng, seg: list[_Request], epoch: int) -> int:
    """Serve one coalesced segment against ``eng``; returns fused launches.

    Fills ``result``/``error`` and tags ``epoch`` on every request; the
    caller sets ``done`` (after recording stats) and owns any locking.
    A mixed-kind segment rides the fused plan when it can (the return
    value counts those fused batches, 0 or 1).
    """
    if len({r.kind for r in seg}) > 1:
        return _serve_fused(eng, seg, epoch)
    kind = seg[0].kind
    _SERVE_BY_KIND[kind](eng, seg, epoch)
    return 0


def _serve_fused(eng, seg: list[_Request], epoch: int) -> int:
    """Serve a mixed degrees/union/intersection segment.

    When at least two kinds can share the plan (intersections require a
    single ``(method, iters)`` group), the segment is answered by ONE
    mixed-kind plan via ``SketchEngine._query_batch_presplit`` —
    bit-identical to the per-kind paths. Non-fusable leftovers (extra
    intersection groups) are served through their per-kind plan in the
    same drain.
    """
    deg = [r for r in seg if r.kind == "degrees"]
    uni = [r for r in seg if r.kind == "union"]
    inter = [r for r in seg if r.kind == "intersection"]
    groups: OrderedDict[tuple, list[_Request]] = OrderedDict()
    for r in inter:
        groups.setdefault(r.payload[2:], []).append(r)
    fused_inter = inter if len(groups) == 1 else []
    fused_kinds = [k for k, rs in (("degrees", deg), ("union", uni),
                                   ("intersection", fused_inter)) if rs]
    if len(fused_kinds) < 2:  # nothing to fuse after grouping
        for rs, kind in ((deg, "degrees"), (uni, "union"),
                         (inter, "intersection")):
            if rs:
                _SERVE_BY_KIND[kind](eng, rs, epoch)
        return 0
    all_sets: list[np.ndarray] = []
    for r in uni:
        all_sets.extend(r.payload[0])
    pairs = (np.concatenate([r.payload[0] for r in fused_inter], axis=0)
             if fused_inter else None)
    method, iters = (next(iter(groups)) if fused_inter
                     else ("mle", eng._resolve_iters(None)))
    fused = deg + uni + fused_inter
    launches = 0
    try:
        out = eng._query_batch_presplit(
            all_sets or None, pairs, bool(deg), method, iters)
    except Exception as e:  # noqa: BLE001 — propagate to clients
        _fail(fused, e)
    else:
        launches = 1
        for r in deg:
            r.result, r.epoch = out["degrees"], epoch
        pos = 0
        for r in uni:
            sets, scalar = r.payload
            chunk = out["union"][pos:pos + len(sets)]
            pos += len(sets)
            r.result = float(chunk[0]) if scalar else chunk
            r.epoch = epoch
        pos = 0
        for r in fused_inter:
            arr, scalar = r.payload[0], r.payload[1]
            chunk = out["intersection"][pos:pos + len(arr)]
            pos += len(arr)
            r.result = float(chunk[0]) if scalar else chunk
            r.epoch = epoch
    if inter and not fused_inter:
        _serve_intersection(eng, inter, epoch)
    return launches


def _serve_degrees(eng, run: list[_Request], epoch: int) -> None:
    try:
        out = eng.degrees()
    except Exception as e:  # noqa: BLE001 — propagate to clients
        _fail(run, e)
        return
    for r in run:
        r.result, r.epoch = out, epoch


def _serve_union(eng, run: list[_Request], epoch: int) -> None:
    all_sets: list[np.ndarray] = []
    for r in run:
        all_sets.extend(r.payload[0])
    try:
        # pre-split entry: ids were validated on the client threads
        est = eng._union_presplit(all_sets)
    except Exception as e:  # noqa: BLE001
        _fail(run, e)
        return
    pos = 0
    for r in run:
        sets, scalar = r.payload
        chunk = est[pos:pos + len(sets)]
        pos += len(sets)
        r.result = float(chunk[0]) if scalar else chunk
        r.epoch = epoch


def _serve_intersection(eng, run: list[_Request], epoch: int) -> None:
    groups: OrderedDict[tuple, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault(r.payload[2:], []).append(r)
    for (method, iters), reqs in groups.items():
        pairs = np.concatenate([r.payload[0] for r in reqs], axis=0)
        try:
            # pre-split entry: pairs were validated on client threads
            est = eng._intersection_presplit(pairs, method, iters)
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        pos = 0
        for r in reqs:
            arr, scalar = r.payload[0], r.payload[1]
            chunk = est[pos:pos + len(arr)]
            pos += len(arr)
            r.result = float(chunk[0]) if scalar else chunk
            r.epoch = epoch


def _serve_triangle(eng, run: list[_Request], epoch: int) -> None:
    groups: OrderedDict[tuple, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault(r.payload, []).append(r)
    for (k, mode, iters), reqs in groups.items():
        try:
            out = eng.triangle_heavy_hitters(k, mode=mode, iters=iters)
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        for r in reqs:
            r.result, r.epoch = out, epoch


def _serve_neighborhood(eng, run: list[_Request], epoch: int) -> None:
    groups: OrderedDict[str, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault(r.payload[2], []).append(r)  # canonical sched
    for reqs in groups.values():
        t_big = max(r.payload[0] for r in reqs)
        try:
            # one engine call at the deepest horizon; the panel cache
            # materializes D^1..D^{t_big} once for the whole group
            local, glob = eng.neighborhood(t_big, schedule=reqs[0].payload[1])
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        for r in reqs:
            t = r.payload[0]
            r.result = (local[:t], glob[:t])
            r.epoch = epoch


def _serve_distance_histogram(eng, run: list[_Request], epoch: int) -> None:
    """HIP distance histograms, coalesced like :func:`_serve_neighborhood`.

    Requests sharing a canonical schedule run ONE engine call at the
    deepest horizon — the per-hop histogram is a pure prefix quantity
    (hop t's row never depends on deeper hops), so each request's
    ``t``-prefix is bit-identical to a direct call at its own ``t_max``.
    """
    groups: OrderedDict[str, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault(r.payload[2], []).append(r)  # canonical sched
    for reqs in groups.values():
        t_big = max(r.payload[0] for r in reqs)
        try:
            hist, glob = eng.distance_histogram(
                t_big, schedule=reqs[0].payload[1])
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        for r in reqs:
            t = r.payload[0]
            r.result = (hist[:t], glob[:t])
            r.epoch = epoch


def _serve_closeness(eng, run: list[_Request], epoch: int) -> None:
    """Closeness centralities, deduped per ``(t_max, schedule)`` group.

    Closeness at horizon ``t`` folds the whole curve up to ``t`` into one
    scalar per vertex, so distinct horizons are distinct answers — but
    groups at different depths still share the engine's cached panels and
    HIP curve rows, so the deepest group pays and the rest ride.
    """
    groups: OrderedDict[tuple, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault((r.payload[0], r.payload[2]), []).append(r)
    for reqs in groups.values():
        try:
            out = eng.closeness(reqs[0].payload[0],
                                schedule=reqs[0].payload[1])
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        for r in reqs:
            r.result, r.epoch = out, epoch


def _serve_effective_diameter(eng, run: list[_Request], epoch: int) -> None:
    """Effective diameters, deduped per ``(t_max, q, schedule)`` group."""
    groups: OrderedDict[tuple, list[_Request]] = OrderedDict()
    for r in run:
        groups.setdefault((r.payload[0], r.payload[1], r.payload[3]),
                          []).append(r)
    for reqs in groups.values():
        t_max, q = reqs[0].payload[0], reqs[0].payload[1]
        try:
            out = eng.effective_diameter(t_max, q=q,
                                         schedule=reqs[0].payload[2])
        except Exception as e:  # noqa: BLE001
            _fail(reqs, e)
            continue
        for r in reqs:
            r.result, r.epoch = out, epoch


_SERVE_BY_KIND = {
    "degrees": _serve_degrees,
    "union": _serve_union,
    "intersection": _serve_intersection,
    "triangle": _serve_triangle,
    "neighborhood": _serve_neighborhood,
    "distance_histogram": _serve_distance_histogram,
    "closeness": _serve_closeness,
    "effective_diameter": _serve_effective_diameter,
}


class QueryServer:
    """Serve concurrent queries (and ingest blocks) over one engine.

    Wraps any :class:`~repro_torch.engine.base.SketchEngine`; the engine
    must not be touched directly while the server owns it (every access
    goes through the single worker thread — that serialization is what
    makes in-place ingestion safe under concurrent reads). Use as a
    context manager or call :meth:`close` when done.
    """

    def __init__(self, engine, *, latency_window: int = _LATENCY_WINDOW):
        self._eng = engine
        self._cv = threading.Condition()
        self._queue: deque[_Request] = deque()
        self._paused = False
        self._closed = False
        self._dead = False  # worker exited (clean close or crash)
        self._epoch = 0
        self._t0 = None  # first submit (throughput window start)
        self._t_last = None
        self._stats: dict[str, _KindStats] = {}
        self._access = placement.AccessStats(engine.n)
        self._fused_batches = 0
        self._latency_window = int(latency_window)
        self._trace_base = plans.trace_counts()  # delta baseline for stats
        # runtime block schema parity with ContinuousServer (DESIGN.md
        # §14): the epoch-barrier server has no failover writer, so only
        # the worker's drain heartbeats ever move
        self._runtime = {"heartbeats_seen": 0, "evictions": 0,
                         "recoveries": 0, "last_recovery_ms": None,
                         "checkpoints_written": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="sketch-query-server")
        self._worker.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self):
        """Context-manager entry: the server is already running."""
        return self

    def __exit__(self, *exc):
        """Context-manager exit: drain pending requests and stop."""
        self.close()
        return False

    def close(self) -> None:
        """Stop accepting requests, drain the queue, join the worker.

        Pending requests are *served* on a clean close; if the worker
        already died (crashed), they are failed with
        :class:`ServerClosed` instead — a future returned by this server
        never hangs (DESIGN.md §3b).
        """
        with self._cv:
            if self._closed:
                self._fail_pending_locked()  # worker may have died since
                return
            self._closed = True
            self._paused = False
            self._cv.notify_all()
        self._worker.join()
        with self._cv:
            self._fail_pending_locked()  # anything a crashed worker left

    def shutdown(self) -> None:
        """Alias of :meth:`close` (the serving-frontend vocabulary)."""
        self.close()

    def _fail_pending_locked(self) -> None:
        """Fail every queued request with ServerClosed (lock held)."""
        while self._queue:
            r = self._queue.popleft()
            if not r.done.is_set():
                if r.error is None:
                    r.error = ServerClosed(
                        "QueryServer shut down before serving this request")
                r.done.set()

    @property
    def engine(self):
        """The wrapped engine (read-only access; queries go via methods)."""
        return self._eng

    @property
    def epoch(self) -> int:
        """Ingest/query epoch: bumps once per served ingest barrier.

        A query served at epoch e saw the register panel produced by the
        first e ingest barriers and none of the later ones — the worker
        serializes the in-place writes against reads, so no request ever
        observes a panel mid-write.
        """
        with self._cv:
            return self._epoch

    def pause(self) -> None:
        """Hold the worker: requests queue up but are not served.

        With the worker held, concurrent submissions accumulate and the
        next :meth:`resume` drains them as maximal micro-batches — used by
        tests (and benchmarks) to make coalescing deterministic.
        """
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        """Release a :meth:`pause`; the worker drains the queued batch."""
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    # ------------------------------------------------------------- clients
    def degrees(self) -> np.ndarray:
        """d̃(x) for every vertex (coalesced: one table scan per batch)."""
        return self._submit("degrees", ()).wait()

    def union_size(self, vertex_sets):
        """|∪ N(x)| — same contract as ``SketchEngine.union_size``.

        Input is parsed and validated (ids against [0, n)) on the calling
        thread, so malformed requests raise here; well-formed ones are
        coalesced with concurrent union queries into one ragged batch.
        """
        sets, scalar = plans.split_sets(vertex_sets, self._eng.n)
        return self._submit("union", (sets, scalar)).wait()

    def intersection_size(self, pairs, *, method: str = "mle",
                          iters: int | None = None):
        """Batched T̃(xy) — same contract as the engine method.

        ``iters=None`` resolves to the engine family's default estimator
        iteration count on the calling thread, so requests leaving the
        default coalesce into one ``(method, iters)`` group; others are
        served in the same drain, through their own plan.
        """
        if method not in ("mle", "ie"):
            raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
        iters = self._eng._resolve_iters(iters)
        arr, scalar = plans.split_pairs(pairs, self._eng.n)
        return self._submit("intersection",
                            (arr, scalar, method, iters)).wait()

    def triangle_heavy_hitters(self, k: int, *, mode: str = "edge",
                               iters: int = 30):
        """Algorithms 4/5 — identical requests in a batch are deduped."""
        return self._submit("triangle", (int(k), mode, int(iters))).wait()

    def neighborhood(self, t_max: int, schedule: str = "auto"):
        """Algorithm 2 — same contract as ``SketchEngine.neighborhood``.

        ``t_max``/``schedule`` are validated on the calling thread;
        concurrent requests whose schedules canonicalize to the same
        panel-cache key coalesce into ONE engine call at the largest
        requested horizon, and each request receives the ``t <= t_max``
        prefix — bit-identical to a direct engine call, because every
        horizon's estimates come from the same cached D^t panels
        (DESIGN.md §3c). Served on the worker, so the answer is
        epoch-guarded like every other kind: it reflects exactly the
        panels of the epoch that served it.
        """
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)  # validates schedule
        return self._submit("neighborhood", (t_max, schedule, key)).wait()

    def distance_histogram(self, t_max: int, schedule: str = "auto"):
        """Per-vertex HIP distance histograms (ADS family, DESIGN.md §13).

        Same contract as ``SketchEngine.distance_histogram``; coalesced
        like :meth:`neighborhood` — concurrent requests sharing a
        canonical schedule are answered by one engine call at the deepest
        horizon and each receives its ``t``-prefix, bit-identical to a
        direct call. Raises ``UnsupportedQuery`` (in the client) when the
        engine's family has no HIP estimator.
        """
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("distance_histogram",
                            (t_max, schedule, key)).wait()

    def closeness(self, t_max: int, schedule: str = "auto"):
        """HIP closeness centralities float64[n] at horizon ``t_max``.

        Same contract as ``SketchEngine.closeness``; identical
        ``(t_max, schedule)`` requests in a batch dedupe into one engine
        call, and different horizons share the cached HIP curve rows.
        """
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("closeness", (t_max, schedule, key)).wait()

    def effective_diameter(self, t_max: int, q: float = 0.9,
                           schedule: str = "auto"):
        """HIP effective diameter (quantile ``q``) probed to ``t_max`` hops.

        Same contract as ``SketchEngine.effective_diameter``; identical
        ``(t_max, q, schedule)`` requests dedupe into one engine call.
        """
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("effective_diameter",
                            (t_max, float(q), schedule, key)).wait()

    def ingest(self, edge_block) -> int:
        """Fold an edge block into the sketch; returns the new epoch.

        Served as a *barrier* on the worker: queries queued before the
        block observe the pre-ingest panel, queries queued after observe
        the post-ingest panel, and the in-place write can never reach a
        read in flight.
        """
        block = np.asarray(edge_block)
        return self._submit("ingest", (block,)).wait()

    def replicate(self, vertex_ids=None, *,
                  policy: placement.PlacementPolicy | None = None,
                  ) -> np.ndarray:
        """Install (or clear) the engine's hot-vertex replica set.

        Pass exactly one of ``vertex_ids`` (explicit ids; empty clears) or
        ``policy`` (a :class:`~repro_torch.engine.placement.PlacementPolicy`
        applied to this server's measured access counters). Served as a
        barrier on the worker like :meth:`ingest` — with ``policy``, the
        hot set is computed *at serve time*, after every earlier queued
        query has been counted. Replication never changes answers (replica
        rows are byte copies, DESIGN.md §12), so the epoch does not bump.

        Returns the installed sorted id array (empty when cleared).
        """
        if (vertex_ids is None) == (policy is None):
            raise ValueError(
                "replicate takes exactly one of vertex_ids or policy")
        ids = None if vertex_ids is None else np.asarray(vertex_ids)
        return self._submit("replicate", (ids, policy)).wait()

    # -------------------------------------------------------------- stats
    @property
    def access_stats(self) -> placement.AccessStats:
        """The per-vertex access counters this server aggregates.

        Written only by the worker thread (one ``note_access`` per served
        segment); reads from other threads (placement decisions, the
        ``stats()`` snapshot) are approximate by at most the segment in
        flight.
        """
        return self._access
    def stats(self) -> dict:
        """Serving statistics snapshot.

        Per query kind: ``requests``, ``batches`` (serving drains that
        touched the kind — coalescing makes this smaller; kinds sharing
        a fused mixed plan each count the segment once),
        ``max_coalesced``, latency percentiles ``p50_ms`` / ``p99_ms`` /
        ``p999_ms`` and the log-bucketed latency ``histogram_ms``
        (non-empty ``[bucket_upper_ms, count]`` pairs). Top level adds
        the request rate over the active window (``requests_per_sec``),
        the live ``queue_depth``, the current ``epoch``,
        ``fused_batches`` (mixed-kind fused plans run, DESIGN.md §10),
        ``shed_total``/``deadline_misses`` (always 0 here — the epoch-
        barrier server has no admission control; the fields exist so the
        continuous frontend's stats are a superset of this schema,
        DESIGN.md §3d), the plan layer's counters
        (``plan_traces`` — plans first built since this server was created,
        the O(log N) quantity — plus the shared-cache hit/miss stats),
        the per-vertex ``access`` counters (totals per kind + the hottest
        vertices, DESIGN.md §12), the engine's sketch ``family`` name
        (DESIGN.md §13) and ``replicated`` (the installed hot-vertex
        replica count). The snapshot is passed through :func:`to_native`,
        so every value is a native Python type and ``json.dumps`` works
        without a ``default=`` escape hatch. ``runtime`` mirrors the
        continuous frontend's failover counters (DESIGN.md §14) —
        here only ``heartbeats_seen`` (worker queue drains) moves; the
        epoch-barrier server has no failover-aware writer to evict or
        recover.
        """
        with self._cv:
            out: dict = {"epoch": self._epoch,
                         "queue_depth": len(self._queue),
                         "runtime": dict(self._runtime)}
            total = 0
            for kind, s in self._stats.items():
                out[kind] = s.snapshot()
                total += s.requests
            span = ((self._t_last or 0.0) - (self._t0 or 0.0))
            out["requests_total"] = total
            out["requests_per_sec"] = (total / span) if span > 0 else None
            out["fused_batches"] = self._fused_batches
            out["shed_total"] = 0
            out["deadline_misses"] = 0
        now_traces = plans.trace_counts()
        out["plan_traces"] = {  # plans first built since THIS server opened
            k: v - self._trace_base.get(k, 0) for k, v in now_traces.items()
            if v - self._trace_base.get(k, 0) > 0}
        out["plan_cache"] = self._eng.plan_cache.stats()
        out["access"] = self._access.snapshot()
        out["family"] = self._eng.family.name
        rep = self._eng.replicated_ids
        out["replicated"] = 0 if rep is None else int(len(rep))
        return to_native(out)

    def reset_stats(self) -> None:
        """Zero the serving-statistics window (counters, latencies, rate).

        Benchmarks call this after their warmup requests so first-call
        outliers (the kernel library's build and load, the first
        neighborhood's routing and panels) don't dominate the reported
        p99 — that cost is real but is a *startup* cost, reported
        separately from steady-state serving latency. The epoch and the
        engine's plan cache are untouched.
        """
        with self._cv:
            self._stats.clear()
            self._fused_batches = 0
            self._t0 = None
            self._t_last = None
        self._access.reset()
        self._trace_base = plans.trace_counts()

    # -------------------------------------------------------------- worker
    def _submit(self, kind: str, payload: tuple) -> _Request:
        req = _Request(kind=kind, payload=payload)
        req.t_submit = time.monotonic()
        with self._cv:
            if self._closed or self._dead:
                raise ServerClosed("QueryServer is closed")
            if self._t0 is None:
                self._t0 = req.t_submit
            self._queue.append(req)
            self._cv.notify_all()
        return req

    def _run(self) -> None:
        batch: list[_Request] = []
        try:
            with device_scope(self._eng.device):
                while True:
                    with self._cv:
                        while ((not self._queue or self._paused)
                               and not self._closed):
                            self._cv.wait()
                        if self._closed and not self._queue:
                            return
                        batch = list(self._queue)
                        self._queue.clear()
                        self._runtime["heartbeats_seen"] += 1
                    try:
                        self._serve(batch)
                    except Exception as e:  # noqa: BLE001 — never hang
                        for r in batch:
                            if not r.done.is_set():
                                if r.error is None:
                                    r.error = e
                                r.done.set()
        except BaseException as e:  # worker is dying: nothing may hang
            for r in batch:
                if not r.done.is_set():
                    if r.error is None:
                        r.error = e
                    r.done.set()
            raise
        finally:
            # clean exit or crash: reject the backlog and future submits
            with self._cv:
                self._dead = True
                self._fail_pending_locked()

    def _serve(self, batch: list[_Request]) -> None:
        """Serve one drained batch segment by segment (see _segments)."""
        for seg in _segments(batch):
            if seg[0].kind == "ingest" and len({r.kind for r in seg}) == 1:
                self._serve_ingest(seg)
            elif (seg[0].kind == "replicate"
                  and len({r.kind for r in seg}) == 1):
                self._serve_replicate(seg)
            else:
                fused = serve_segment(self._eng, seg, self._epoch)
                if fused:
                    with self._cv:
                        self._fused_batches += fused
            note_access(self._access, seg)
            now = time.monotonic()
            with self._cv:
                self._t_last = now
                _note_served(self._stats, seg, now, self._latency_window)
            for r in seg:
                r.done.set()

    def _serve_ingest(self, run: list[_Request]) -> None:
        for r in run:
            try:
                self._eng.ingest(r.payload[0])
            except Exception as e:  # noqa: BLE001
                r.error = e
                continue
            with self._cv:
                self._epoch += 1
                r.result = r.epoch = self._epoch

    def _serve_replicate(self, run: list[_Request]) -> None:
        """Apply replica-set changes as a worker barrier (like ingest).

        A ``policy`` request resolves its hot set here, on the worker,
        so every query queued before it has already been folded into the
        access counters. The epoch never bumps — replication is
        answer-preserving by construction.
        """
        for r in run:
            ids, policy = r.payload
            try:
                if ids is None:
                    ids = policy.hot_vertices(self._access)
                self._eng.replicate(ids)
            except Exception as e:  # noqa: BLE001
                r.error = e
                continue
            installed = self._eng.replicated_ids
            r.result = (installed if installed is not None
                        else np.zeros(0, np.int64))
            r.epoch = self._epoch
