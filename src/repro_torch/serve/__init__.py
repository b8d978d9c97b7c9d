"""Serving frontends: concurrent sketch queries over a ``SketchEngine``
(port of ``repro.serve``).

Two servers share one coalescing/fused-plan core (DESIGN.md §3b, §3d):

* ``QueryServer`` — epoch-barrier serving: ONE worker thread owns the
  engine, ingest is a barrier between query drains. Strongest freshness
  (a query sees every prior ingest), but readers wait for each ingest.
* ``ContinuousServer`` — writer/reader split: a writer thread ingests
  continuously while queries are served from rotating read-only
  snapshots (``SketchEngine.snapshot()``). Readers never wait for the
  writer; they accept a bounded freshness lag (the ``RotationPolicy``),
  and the frontend adds production controls — ingest backpressure,
  admission control (``Overloaded``), per-request deadlines
  (``DeadlineExceeded``) and, with ``ft=``/``faults=``, a writer that
  recovers from an injected host loss through its checkpoints.

Both coalesce concurrent requests into micro-batches riding the
shape-bucketed query plans, so answers are bit-identical to direct
engine calls at the serving epoch or snapshot version. Both run their
engine calls on the engine's device (the card unless it was opened on
the CPU).

    from repro_torch import engine, serve

    with serve.QueryServer(engine.load("/ckpt/web-graph")) as srv:
        deg  = srv.degrees()
        u    = srv.union_size([[0, 1, 2]])        # safe from any thread
        srv.ingest(next_block)                    # epoch barrier
        print(srv.stats()["union"]["p99_ms"])

    with serve.ContinuousServer(engine.open(n, cfg)) as srv:
        srv.ingest(block)                         # async, backpressured
        srv.flush()                               # apply + publish
        t = srv.intersection_size([(0, 1)], deadline=0.05)

``repro_torch.serve.loadgen`` generates open- and closed-loop load over
either server. CLI: ``python -m repro_torch.launch.sketch_serve``
(``--continuous`` for the writer/reader split, ``--stats`` for the dump).
"""
from repro_torch.serve.frontend import (ContinuousServer, DeadlineExceeded,
                                        Overloaded)
from repro_torch.serve.server import QueryServer, ServerClosed
from repro_torch.serve.snapshot import (RotationPolicy, SnapshotFrozen,
                                        SnapshotSlot)

__all__ = [
    "QueryServer",
    "ServerClosed",
    "ContinuousServer",
    "Overloaded",
    "DeadlineExceeded",
    "RotationPolicy",
    "SnapshotSlot",
    "SnapshotFrozen",
]
