"""ContinuousServer: writer/reader split serving over rotating snapshots
(port of ``repro.serve.frontend``).

The epoch-barrier :class:`~repro_torch.serve.server.QueryServer`
serializes ingest *between* query drains: every reader stalls for the
full accumulate step. This frontend (DESIGN.md §3d) removes that stall:

* A **writer thread** owns the live engine and drains ingest blocks from
  a bounded queue, applying accumulate steps back-to-back.
* A **reader thread** serves queries against the current *read-only
  snapshot* (``SketchEngine.snapshot()``) through the exact same
  coalescing/fused-plan core as ``QueryServer`` — answers are
  bit-identical to direct engine calls at the snapshot's version.
* **Rotation** publishes writer progress: per :class:`RotationPolicy`
  (every N blocks and/or a staleness budget) the writer takes a fresh
  snapshot and swaps it into the :class:`SnapshotSlot` — a pointer swap
  plus plan/panel-cache handoff, never a reader stall. The snapshot
  leases the writer's panel, so the writer's first ingest after a
  rotation clones the panel once (``SketchEngine._release_lease``): one
  panel copy per rotation, paid on the writer's thread, and one more
  panel held while the published snapshot lives.

Both threads make the engine's device current before their first engine
call and launch on its current stream, the one stream every engine call
of the server shares.

Production controls:

* **Backpressure** — ``ingest`` blocks once ``max_ingest_queue`` blocks
  are pending (the stream source slows down instead of OOMing the host).
* **Admission control** — query submits past the ``shed_watermark``
  queue depth are rejected immediately with :class:`Overloaded`; shed
  requests cost nothing downstream.
* **Deadlines** — a query may carry a deadline (seconds); requests whose
  deadline expired while queued are failed fast with
  :class:`DeadlineExceeded` at drain time instead of occupying a
  micro-batch slot.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from repro_torch.engine import placement, plans
from repro_torch.engine.base import validate_t_max
from repro_torch.runtime.faults import HostLost
from repro_torch.serve.server import (_LATENCY_WINDOW, _KindStats, _Request,
                                      _note_served, _segments, device_scope,
                                      note_access, ServerClosed,
                                      serve_segment, to_native)
from repro_torch.serve.snapshot import RotationPolicy, SnapshotSlot

__all__ = ["ContinuousServer", "Overloaded", "DeadlineExceeded"]


class Overloaded(RuntimeError):
    """Request shed at admission: the query queue is past the watermark.

    Raised on the *calling* thread at submit time — a shed request never
    reaches the reader, so overload sheds cost-free instead of growing
    the queue without bound (DESIGN.md §3d).
    """


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before it was served.

    Delivered at drain time: the reader fails expired requests fast and
    spends the micro-batch on requests a client is still waiting for.
    """


class ContinuousServer:
    """Serve queries from rotating snapshots while a writer ingests.

    Wraps a mutable :class:`~repro_torch.engine.base.SketchEngine`; the engine
    must not be touched directly while the server owns it. ``ingest`` is
    asynchronous (enqueue + return; :meth:`flush` waits for the data to
    be applied *and published*); queries are blocking like
    ``QueryServer``'s, and are answered by the newest published snapshot
    — ``version_lag`` in :meth:`stats` reports the freshness gap. Use as
    a context manager or call :meth:`close` when done.
    """

    def __init__(self, engine, *, rotation: RotationPolicy | None = None,
                 max_ingest_queue: int = 64, shed_watermark: int = 1024,
                 latency_window: int = _LATENCY_WINDOW, ft=None, faults=None):
        if max_ingest_queue < 1:
            raise ValueError(
                f"max_ingest_queue must be >= 1, got {max_ingest_queue}")
        if shed_watermark < 1:
            raise ValueError(
                f"shed_watermark must be >= 1, got {shed_watermark}")
        self._eng = engine
        # failover-aware writer (DESIGN.md §14): with an
        # ft=runtime.ft.FTConfig the writer checkpoints the engine every
        # ft.ckpt_every applied blocks through the async checkpointer and
        # survives a writer-host loss (runtime.faults.HostLost) by
        # restoring the newest complete manifest and replaying the
        # buffered entries the checkpoint does not cover — the m_ingested
        # cursor decides exactly which, so nothing is applied twice.
        self._ft = ft
        self._faults = faults
        self._ckpt = None
        self._entry_index = 0  # fault-plan block index (applied entries)
        self._ckpt_blocks = 0  # ingest entries since the last checkpoint
        self._ckpt_step = 0
        self._replay_old: list = []  # covered by the in-flight checkpoint
        self._replay_new: list = []  # not yet in any initiated checkpoint
        self._runtime = {"heartbeats_seen": 0, "evictions": 0,
                         "recoveries": 0, "last_recovery_ms": None,
                         "checkpoints_written": 0}
        if ft is not None:
            from repro_torch.ckpt.checkpoint import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(ft.ckpt_dir, keep=ft.keep)
            # make the handover state durable so recovery always has a
            # manifest to restore (step 0 = the engine as given to us)
            tree, extra = engine.checkpoint_state()
            self._ckpt.save(self._ckpt_step, tree, extra=extra)
            self._runtime["checkpoints_written"] += 1
        self._rotation = rotation or RotationPolicy()
        self._max_ingest_queue = int(max_ingest_queue)
        self._shed_watermark = int(shed_watermark)
        self._latency_window = int(latency_window)
        # readers start on a snapshot of the engine as handed over
        self._slot = SnapshotSlot(engine.snapshot())
        self._access = placement.AccessStats(engine.n)
        # writer state (guarded by _wcv); entries are tagged
        # ("ingest", block) / ("replicate", ids) so replica-set changes
        # ride the same ordered apply-then-publish path as edge blocks
        self._wcv = threading.Condition()
        self._wq: deque[tuple[str, np.ndarray]] = deque()
        self._inflight = 0  # blocks drained but not yet applied
        self._blocks_pending = 0  # applied but not yet published
        self._oldest_pending_t: float | None = None
        self._blocks_applied = 0
        self._flush_waiters = 0
        self._writer_dead = False
        # reader state (guarded by _rcv)
        self._rcv = threading.Condition()
        self._rq: deque[_Request] = deque()
        self._reader_dead = False
        self._stats: dict[str, _KindStats] = {}
        self._fused_batches = 0
        self._shed_total = 0
        self._deadline_misses = 0
        self._t0 = None
        self._t_last = None
        self._closed = False
        self._trace_base = plans.trace_counts()
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name="sketch-cont-writer")
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="sketch-cont-reader")
        self._writer.start()
        self._reader.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self):
        """Context-manager entry: both threads are already running."""
        return self

    def __exit__(self, *exc):
        """Context-manager exit: drain, publish, and stop."""
        self.close()
        return False

    def close(self) -> None:
        """Stop both threads; never leaves a client hanging.

        A clean close drains the queues first (pending ingest blocks are
        applied and published, pending queries served); if either thread
        died, its leftover work is failed with :class:`ServerClosed`.
        """
        with self._wcv:
            if self._closed:
                closed_already = True
            else:
                closed_already = False
                self._closed = True
            self._wcv.notify_all()
        with self._rcv:
            self._rcv.notify_all()
        if not closed_already:
            self._writer.join()
            self._reader.join()
        with self._rcv:
            self._fail_reads_locked()

    def shutdown(self) -> None:
        """Alias of :meth:`close`."""
        self.close()

    def _fail_reads_locked(self) -> None:
        """Fail every queued query with ServerClosed (_rcv held)."""
        while self._rq:
            r = self._rq.popleft()
            if not r.done.is_set():
                if r.error is None:
                    r.error = ServerClosed(
                        "ContinuousServer shut down before serving this "
                        "request")
                r.done.set()

    @property
    def engine(self):
        """The writer engine (do not mutate; stats/config reads only)."""
        return self._eng

    @property
    def snapshot_version(self) -> int:
        """Engine version of the snapshot queries are currently served by."""
        return self._slot.get().version

    # ------------------------------------------------------------- writer
    def ingest(self, edge_block) -> None:
        """Enqueue an edge block for the writer thread (asynchronous).

        Returns as soon as the block is queued; blocks (backpressure)
        while ``max_ingest_queue`` blocks are already pending, so a
        too-fast stream source is slowed to the writer's drain rate
        instead of growing the queue without bound. Use :meth:`flush` to
        wait until queued data is applied and published.
        """
        self._enqueue("ingest", np.asarray(edge_block))

    def _enqueue(self, tag: str, payload) -> None:
        """Append one tagged entry to the writer queue (backpressured)."""
        with self._wcv:
            while (len(self._wq) >= self._max_ingest_queue
                   and not self._closed and not self._writer_dead):
                self._wcv.wait()
            if self._closed or self._writer_dead:
                raise ServerClosed("ContinuousServer is closed")
            self._wq.append((tag, payload))
            self._wcv.notify_all()

    def replicate(self, vertex_ids=None, *, policy=None) -> np.ndarray:
        """Install a hot-vertex replica set on the writer engine.

        Exactly one of ``vertex_ids`` (explicit ids; ``[]`` clears) or
        ``policy`` (a :class:`~repro_torch.engine.placement.PlacementPolicy`,
        resolved *now* against the reader's access counters) must be
        given. The change rides the writer queue like an ingest block and
        this call flushes, so on return the served snapshot carries the
        new replica set — answers are bit-identical either way
        (DESIGN.md §12); replication only relocates hot rows.
        Returns the installed id array (empty when cleared).
        """
        if (vertex_ids is None) == (policy is None):
            raise ValueError(
                "pass exactly one of vertex_ids= or policy=")
        if vertex_ids is None:
            ids = policy.hot_vertices(self._access)
        else:
            ids = np.asarray(vertex_ids)
        self._enqueue("replicate", ids)
        self.flush()
        installed = self._eng.replicated_ids
        return installed if installed is not None else np.zeros(0, np.int64)

    @property
    def access_stats(self) -> placement.AccessStats:
        """Per-vertex access counters folded by the reader (DESIGN.md §12)."""
        return self._access

    def flush(self, timeout: float | None = None) -> int:
        """Wait until every queued block is applied AND published.

        Forces a rotation if applied-but-unpublished blocks remain (the
        policy's counters/timers reset), so after ``flush`` returns the
        served snapshot reflects every prior ``ingest`` — that is the
        determinism hook the CLI smoke check and the bit-identity tests
        build on. Returns the published snapshot version.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._wcv:
            self._flush_waiters += 1
            self._wcv.notify_all()
            try:
                while (self._wq or self._inflight or self._blocks_pending):
                    if self._closed or self._writer_dead:
                        raise ServerClosed(
                            "ContinuousServer closed while flushing")
                    left = (None if deadline is None
                            else deadline - time.monotonic())
                    if left is not None and left <= 0:
                        raise TimeoutError(
                            "flush timed out with ingest still pending")
                    self._wcv.wait(timeout=left)
            finally:
                self._flush_waiters -= 1
        return self.snapshot_version

    def _write_loop(self) -> None:
        try:
            with device_scope(self._eng.device):
                while True:
                    with self._wcv:
                        while not self._wq and not self._closed:
                            if self._blocks_pending and self._flush_waiters:
                                break  # flush() forces the tail out now
                            age = (0.0 if self._oldest_pending_t is None else
                                   time.monotonic() - self._oldest_pending_t)
                            left = self._rotation.timeout(self._blocks_pending,
                                                          age)
                            if left is not None and left <= 0:
                                break  # staleness budget spent: rotate
                            # left is None when nothing is pending or no
                            # staleness timer is set: only new blocks, a
                            # flush, or close can change what to do next
                            self._wcv.wait(timeout=left)
                        if self._closed and not self._wq:
                            if self._blocks_pending:
                                self._rotate()  # publish the tail on close
                            return
                        batch = list(self._wq)
                        self._wq.clear()
                        self._inflight = len(batch)
                        self._wcv.notify_all()  # free backpressured producers
                    self._runtime["heartbeats_seen"] += 1  # one beat per drain
                    applied = 0
                    for tag, payload in batch:
                        applied += self._apply_entry(tag, payload)
                    now = time.monotonic()
                    with self._wcv:
                        self._inflight = 0
                        if batch:
                            # replicate entries count as pending too: the next
                            # rotation must publish the replica-carrying
                            # snapshot
                            self._blocks_pending += len(batch)
                            self._blocks_applied += applied
                            if self._oldest_pending_t is None:
                                self._oldest_pending_t = now
                        age = (0.0 if self._oldest_pending_t is None else
                               now - self._oldest_pending_t)
                        if self._blocks_pending and (
                                self._rotation.due(self._blocks_pending, age)
                                or (self._flush_waiters and not self._wq)):
                            self._rotate()
                        self._wcv.notify_all()
        finally:
            with self._wcv:
                self._writer_dead = True
                self._wcv.notify_all()

    def _rotate(self) -> None:
        """Take a snapshot and publish it (_wcv held; no copy here: the
        writer's next ingest clones the leased panel)."""
        self._slot.swap(self._eng.snapshot())
        self._blocks_pending = 0
        self._oldest_pending_t = None

    # ------------------------------------------------- failover (writer)
    def _apply_entry(self, tag: str, payload) -> int:
        """Apply one writer entry; recover through injected host losses.

        Returns 1 for a first-time-applied ingest block (the
        ``ingest_blocks_applied`` increment), 0 otherwise. Without an
        ``ft`` config any exception propagates and kills the writer as
        before; with one, a ``runtime.faults.HostLost`` triggers
        :meth:`_recover_writer` and the entry is retried on the restored
        engine (the fault plan fires each kill once per visit, so the
        retry makes progress).
        """
        while True:
            try:
                if self._faults is not None:
                    before = set(self._faults.killed)
                    self._faults.tick(self._entry_index)
                    lost = self._faults.killed - before
                    if lost:
                        raise HostLost(min(lost), self._entry_index)
                m_before = self._eng.m
                if tag == "ingest":
                    self._eng.ingest(payload)
                else:
                    self._eng.replicate(payload)
                break
            except HostLost as e:
                if self._ft is None:
                    raise
                self._recover_writer(e)
        if self._ft is not None:
            self._replay_new.append(
                (self._entry_index, tag, payload, m_before))
            self._entry_index += 1
            if tag == "ingest":
                self._ckpt_blocks += 1
                if self._ckpt_blocks >= self._ft.ckpt_every:
                    self._take_checkpoint()
        return 1 if tag == "ingest" else 0

    def _take_checkpoint(self) -> None:
        """Initiate an async engine checkpoint and rotate replay buffers.

        ``AsyncCheckpointer.save`` waits for the previous write first, so
        initiating step N proves step N-1 is complete — which is exactly
        when the segment covered only by N-1 becomes safe to drop. The
        surviving two segments always span every entry the newest
        *complete* manifest might miss.
        """
        self._ckpt_step += 1
        tree, extra = self._eng.checkpoint_state()
        self._ckpt.save(self._ckpt_step, tree, extra=extra)
        self._runtime["checkpoints_written"] += 1
        self._ckpt_blocks = 0
        self._replay_old = self._replay_new
        self._replay_new = []

    def _recover_writer(self, err) -> None:
        """Restore the newest complete checkpoint and replay past it.

        Replay is *exact*: a buffered ingest entry is reapplied only if
        its pre-apply ``m`` cursor is at or beyond the restored engine's
        ``m_ingested`` (entries below it are already inside the
        checkpoint; reapplying would duplicate edge rows). Replicate
        entries are idempotent and always reapplied. Replay consults the
        fault plan with the entries' original indices, so a second
        injected failure lands *during* recovery and restarts it — the
        double-failure case — bounded by the (finite) fault plan.
        """
        from repro_torch import engine as engine_mod
        from repro_torch.ckpt.checkpoint import latest_step
        t0 = time.monotonic()
        self._faults.killed.discard(err.host)  # the host process restarts
        while True:
            self._ckpt.wait()  # an in-flight write may complete and win
            step = latest_step(self._ft.ckpt_dir)
            eng = engine_mod.load(self._ft.ckpt_dir, step=step,
                                  device=self._eng.device)
            try:
                for entry in self._replay_old + self._replay_new:
                    self._replay_one(eng, *entry)
                break
            except HostLost as e2:
                self._runtime["recoveries"] += 1
                self._faults.killed.discard(e2.host)
        self._eng = eng
        self._runtime["recoveries"] += 1
        self._runtime["last_recovery_ms"] = (time.monotonic() - t0) * 1e3

    def _replay_one(self, eng, idx: int, tag: str, payload,
                    m_before: int) -> None:
        """Re-drive one buffered entry against a restored engine.

        ``m_before`` was the engine's ``m_ingested`` cursor when the
        entry first applied; an ingest block whose cursor is below the
        restored engine's is already inside the checkpoint and is
        skipped, keeping the edge list duplicate-free.
        """
        if self._faults is not None:
            before = set(self._faults.killed)
            self._faults.tick(idx)
            lost = self._faults.killed - before
            if lost:
                raise HostLost(min(lost), idx)
        if tag == "ingest":
            if m_before >= eng.m:
                eng.ingest(payload)
        else:
            eng.replicate(payload)

    # ------------------------------------------------------------- clients
    def _submit(self, kind: str, payload: tuple,
                deadline: float | None) -> _Request:
        req = _Request(kind=kind, payload=payload)
        req.t_submit = time.monotonic()
        if deadline is not None:
            if deadline <= 0:
                raise ValueError(f"deadline must be > 0 s, got {deadline}")
            req.deadline = req.t_submit + deadline
        with self._rcv:
            if self._closed or self._reader_dead:
                raise ServerClosed("ContinuousServer is closed")
            if len(self._rq) >= self._shed_watermark:
                self._shed_total += 1
                raise Overloaded(
                    f"query queue depth {len(self._rq)} is at the shed "
                    f"watermark ({self._shed_watermark}); retry later")
            if self._t0 is None:
                self._t0 = req.t_submit
            self._rq.append(req)
            self._rcv.notify_all()
        return req

    def degrees(self, *, deadline: float | None = None) -> np.ndarray:
        """d̃(x) for every vertex, from the current snapshot."""
        return self._submit("degrees", (), deadline).wait()

    def union_size(self, vertex_sets, *, deadline: float | None = None):
        """|∪ N(x)| — contract of ``SketchEngine.union_size``."""
        sets, scalar = plans.split_sets(vertex_sets, self._eng.n)
        return self._submit("union", (sets, scalar), deadline).wait()

    def intersection_size(self, pairs, *, method: str = "mle",
                          iters: int | None = None,
                          deadline: float | None = None):
        """Batched T̃(xy) — contract of the engine method.

        ``iters=None`` resolves to the family default on the calling
        thread (see ``QueryServer.intersection_size``).
        """
        if method not in ("mle", "ie"):
            raise ValueError(f"method must be 'mle' or 'ie', got {method!r}")
        iters = self._eng._resolve_iters(iters)
        arr, scalar = plans.split_pairs(pairs, self._eng.n)
        return self._submit("intersection", (arr, scalar, method, iters),
                            deadline).wait()

    def triangle_heavy_hitters(self, k: int, *, mode: str = "edge",
                               iters: int = 30,
                               deadline: float | None = None):
        """Algorithms 4/5 against the current snapshot."""
        return self._submit("triangle", (int(k), mode, int(iters)),
                            deadline).wait()

    def neighborhood(self, t_max: int, schedule: str = "auto", *,
                     deadline: float | None = None):
        """Algorithm 2 — coalesced per schedule like ``QueryServer``."""
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("neighborhood", (t_max, schedule, key),
                            deadline).wait()

    def distance_histogram(self, t_max: int, schedule: str = "auto", *,
                           deadline: float | None = None):
        """HIP distance histograms — coalesced per schedule (DESIGN.md §13)."""
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("distance_histogram", (t_max, schedule, key),
                            deadline).wait()

    def closeness(self, t_max: int, schedule: str = "auto", *,
                  deadline: float | None = None):
        """HIP closeness centralities — deduped per ``(t_max, schedule)``."""
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("closeness", (t_max, schedule, key),
                            deadline).wait()

    def effective_diameter(self, t_max: int, q: float = 0.9,
                           schedule: str = "auto", *,
                           deadline: float | None = None):
        """HIP effective diameter — deduped per ``(t_max, q, schedule)``."""
        t_max = validate_t_max(t_max)
        key = self._eng._canonical_schedule(schedule)
        return self._submit("effective_diameter",
                            (t_max, float(q), schedule, key),
                            deadline).wait()

    # -------------------------------------------------------------- reader
    def _read_loop(self) -> None:
        batch: list[_Request] = []
        try:
            with device_scope(self._eng.device):
                while True:
                    with self._rcv:
                        while not self._rq and not self._closed:
                            self._rcv.wait()
                        if self._closed and not self._rq:
                            return
                        batch = list(self._rq)
                        self._rq.clear()
                    snap = self._slot.get()  # one snapshot per drain
                    now = time.monotonic()
                    live: list[_Request] = []
                    expired: list[_Request] = []
                    for r in batch:
                        late = r.deadline is not None and now > r.deadline
                        (expired if late else live).append(r)
                    for r in expired:
                        r.error = DeadlineExceeded(
                            f"deadline expired {now - r.deadline:.3f}s before "
                            f"the {r.kind} request was served")
                        r.t_done = now
                        r.done.set()
                    if expired:
                        with self._rcv:
                            self._deadline_misses += len(expired)
                    try:
                        self._serve(snap, live)
                    except Exception as e:  # noqa: BLE001 — never hang
                        for r in live:
                            if not r.done.is_set():
                                if r.error is None:
                                    r.error = e
                                r.done.set()
        except BaseException as e:  # reader is dying: nothing may hang
            for r in batch:
                if not r.done.is_set():
                    if r.error is None:
                        r.error = e
                    r.done.set()
            raise
        finally:
            with self._rcv:
                self._reader_dead = True
                self._fail_reads_locked()
                self._rcv.notify_all()

    def _serve(self, snap, batch: list[_Request]) -> None:
        """Serve one drained query batch against ``snap`` (reader thread)."""
        for seg in _segments(batch):
            fused = serve_segment(snap, seg, snap.version)
            note_access(self._access, seg)
            now = time.monotonic()
            with self._rcv:
                self._t_last = now
                if fused:
                    self._fused_batches += fused
                _note_served(self._stats, seg, now, self._latency_window)
            for r in seg:
                r.done.set()

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Serving statistics snapshot (a superset of ``QueryServer``'s).

        Per-kind blocks match ``QueryServer.stats()`` (requests, batches,
        max_coalesced, p50/p99/p999, histogram). On top: ``queue_depth``
        (queries waiting), ``ingest_queue_depth``/``ingest_blocks_applied``
        for the writer side, ``shed_total`` (admission rejections),
        ``deadline_misses``, and a ``snapshot`` block from
        :meth:`SnapshotSlot.stats` — published version, rotation count,
        ``age_seconds`` staleness and the writer ``version_lag``.
        ``epoch`` mirrors the served snapshot version so workloads
        written against ``QueryServer`` can read either server's stats.
        ``access`` (per-vertex hot-set counters from the reader) and
        ``replicated`` (installed replica count) match ``QueryServer``'s
        keys too (DESIGN.md §12). ``runtime`` reports the failover-aware
        writer's counters (heartbeats seen — one per queue drain —
        evictions, recoveries, last recovery ms, checkpoints written;
        DESIGN.md §14), all zero/None when no ``ft`` config is set.
        """
        with self._rcv:
            out: dict = {"queue_depth": len(self._rq)}
            total = 0
            for kind, s in self._stats.items():
                out[kind] = s.snapshot()
                total += s.requests
            span = ((self._t_last or 0.0) - (self._t0 or 0.0))
            out["requests_total"] = total
            out["requests_per_sec"] = (total / span) if span > 0 else None
            out["fused_batches"] = self._fused_batches
            out["shed_total"] = self._shed_total
            out["deadline_misses"] = self._deadline_misses
        with self._wcv:
            out["ingest_queue_depth"] = len(self._wq) + self._inflight
            out["ingest_blocks_applied"] = self._blocks_applied
            out["runtime"] = dict(self._runtime)
        out["snapshot"] = self._slot.stats(writer_version=self._eng.version)
        out["epoch"] = out["snapshot"]["version"]
        out["access"] = self._access.snapshot()
        rep = self._slot.get().replicated_ids
        out["replicated"] = 0 if rep is None else int(len(rep))
        now_traces = plans.trace_counts()
        out["plan_traces"] = {
            k: v - self._trace_base.get(k, 0) for k, v in now_traces.items()
            if v - self._trace_base.get(k, 0) > 0}
        out["plan_cache"] = self._eng.plan_cache.stats()
        out["family"] = self._eng.family.name
        return to_native(out)

    def reset_stats(self) -> None:
        """Zero the query-side statistics window (see ``QueryServer``).

        Writer counters (blocks applied, rotations) and the snapshot
        itself are untouched — only latency/throughput/shed windows reset,
        so benchmarks can exclude warmup calls from steady-state SLOs.
        """
        with self._rcv:
            self._stats.clear()
            self._fused_batches = 0
            self._shed_total = 0
            self._deadline_misses = 0
            self._t0 = None
            self._t_last = None
        self._access.reset()
        self._trace_base = plans.trace_counts()
