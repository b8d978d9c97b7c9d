"""Sketch serving launcher: drive concurrent clients through a server
(port of ``repro.launch.sketch_serve``).

Builds a sketch engine on ``--device`` (default: the card; ``cpu`` runs
every kernel's plain PyTorch version), wraps it in
``repro_torch.serve.QueryServer`` (or, with ``--continuous``, the
snapshot-rotating ``repro_torch.serve.ContinuousServer`` — DESIGN.md
§3d) and fires N client threads issuing mixed
degree/union/intersection/neighborhood queries (the HIP distance kinds
for ``--family ads``) with jittering batch sizes and horizons —
interleaved with live ingest blocks — then prints latency/throughput
stats and the plan counters that demonstrate micro-batch coalescing over
the shape-bucketed plan cache (DESIGN.md §3b) plus the t-hop panel cache
serving neighborhood queries (§3c). In continuous mode the run ends with
a flush and a *deterministic sample assertion*: served answers must be
bit-identical to a direct engine call on the full edge set — rotation is
not allowed to change an answer. ``--stats`` dumps the complete stats
structure (queue depths, latency histograms, shed/deadline counters,
snapshot staleness, per-vertex access counters) as JSON.

Workload-aware placement (DESIGN.md §12): ``--zipf S`` draws client
vertex ids from a Zipf(S) hot-vertex distribution, and ``--replicate K``
ends the run by replicating the top-K vertices from the served access
counters — asserting the hot set is non-empty and that sample
union/intersection answers are bit-identical before and after
replication, then printing the modeled max-owner gather-traffic ratio.

``--impl`` picks the kernel implementation, as the JAX launcher's does:
``cuda`` (the default: the CUDA kernels on the card, their plain
versions on the CPU) or ``ref`` (the plain PyTorch versions on either
device, no kernel launched). ``--backend sharded --shards S`` serves a
sharded engine (``S`` row blocks; default one per visible card on the
card, one on the CPU), as the JAX launcher's flags do; ``--shards`` with
the local backend is an error.

    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --scale 10 --clients 6 --requests 40 --ingest-blocks 8
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve --smoke
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --smoke --continuous --stats
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --smoke --zipf 1.3 --replicate 16
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --smoke --impl ref
    PYTHONPATH=src python -m repro_torch.launch.sketch_serve \
        --smoke --device cpu --backend sharded --shards 2 \
        --zipf 1.3 --replicate 16
"""
from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from repro_torch import engine
from repro_torch.engine import base, placement, plans
from repro_torch.graph import generators as gen
from repro_torch.kernels import registry
from repro_torch.serve import ContinuousServer, QueryServer, RotationPolicy
from repro_torch.serve.loadgen import ZipfSampler


def _client(server, edges: np.ndarray, n: int, requests: int,
            max_batch: int, t_max: int, seed: int, errors: list,
            sampler=None, kinds=("union", "intersection", "degrees",
                                 "neighborhood")) -> None:
    """One client: mixed queries with jittering (power-law) batch sizes.

    ``kinds`` is the query mix, drawn uniformly per request — the launcher
    derives it from the engine family's serveable kinds (DESIGN.md §13),
    so an ADS run exercises the HIP distance queries instead of the
    set-algebra kinds its family does not answer. ``sampler`` (a
    :class:`repro_torch.serve.loadgen.ZipfSampler`) switches the
    union/intersection vertex ids from uniform/edge-derived draws to a
    Zipfian hot-vertex stream — the workload shape the placement policy
    targets (DESIGN.md §12).
    """
    rng = np.random.default_rng(seed)

    def draw(size):
        return (sampler.sample(rng, size) if sampler is not None
                else rng.integers(0, n, size=size))

    try:
        for i in range(requests):
            batch = int(rng.integers(1, max_batch + 1))
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "union":
                sets = [draw(int(rng.integers(1, 8)))
                        for _ in range(batch)]
                server.union_size(sets)
            elif kind == "intersection":
                if sampler is not None:
                    server.intersection_size(draw((batch, 2)))
                else:
                    idx = rng.integers(0, len(edges), size=batch)
                    server.intersection_size(edges[idx])
            elif kind == "neighborhood":
                # jittering horizons coalesce onto one panel set per epoch
                server.neighborhood(int(rng.integers(1, t_max + 1)))
            elif kind == "distance_histogram":
                server.distance_histogram(int(rng.integers(1, t_max + 1)))
            elif kind == "closeness":
                server.closeness(t_max)
            elif kind == "effective_diameter":
                server.effective_diameter(t_max, q=0.9)
            else:
                server.degrees()
    except Exception as e:  # noqa: BLE001 — surface in the main thread
        errors.append(e)


def main(argv: list[str] | None = None) -> None:
    """Entry point (see module docstring for the flags)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=int, default=10,
                    help="rmat scale: n ~ 2**scale vertices")
    ap.add_argument("--deg", type=int, default=8, help="rmat average degree")
    ap.add_argument("--p", type=int, default=8,
                    help="sketch prefix bits (r = 2**p registers)")
    ap.add_argument("--family", default="hll", choices=("hll", "ads"),
                    help="sketch family (DESIGN.md §13)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one) "
                         "or cpu (the kernels' plain PyTorch versions)")
    ap.add_argument("--impl", default="cuda", choices=("cuda", "ref"),
                    help="kernel implementation: cuda (the kernels on the "
                         "card) or ref (their plain versions, any device)")
    ap.add_argument("--backend", default="local",
                    choices=("local", "sharded"),
                    help="engine backend (sharded: --shards row blocks)")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards of the sharded backend (default: one per "
                         "visible card, one on the CPU)")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent query client threads")
    ap.add_argument("--requests", type=int, default=25,
                    help="requests per client")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="max per-request batch size (jitters 1..max)")
    ap.add_argument("--t-max", type=int, default=3,
                    help="max neighborhood horizon (requests jitter 1..t)")
    ap.add_argument("--ingest-blocks", type=int, default=4,
                    help="edge blocks streamed in WHILE clients query")
    ap.add_argument("--continuous", action="store_true",
                    help="serve from rotating snapshots (ContinuousServer: "
                         "writer ingests while readers never stall)")
    ap.add_argument("--zipf", type=float, default=None, metavar="S",
                    help="draw client vertex ids Zipf(S) instead of "
                         "uniform (hot-vertex workload, DESIGN.md §12)")
    ap.add_argument("--replicate", type=int, default=0, metavar="K",
                    help="after the client wave, replicate the top-K hot "
                         "vertices from the access counters and assert "
                         "served answers stay bit-identical")
    ap.add_argument("--stats", action="store_true",
                    help="dump the full stats structure as JSON at the end")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast configuration for CI")
    args = ap.parse_args(argv)
    args.t_max = base.validate_t_max(args.t_max)  # clear error, not an
    # opaque rng ValueError from inside a client thread
    if args.smoke:
        args.scale, args.clients = 8, 3
        args.requests, args.max_batch, args.ingest_blocks = 8, 16, 2

    fam = registry.family(args.family)
    cfg = fam.config_cls(p=args.p)
    # the mixed-kind fused plan is a serving construct, not a client
    # query; triangle is left to its dedicated launcher
    kinds = tuple(k for k in fam.query_kinds if k not in ("mixed",
                                                          "triangle"))
    if args.shards is not None and args.backend != "sharded":
        ap.error("--shards only applies to --backend sharded")
    if args.replicate and "union" not in fam.query_kinds:
        ap.error(f"--replicate probes union/intersection answers, which "
                 f"family {fam.name!r} does not serve")

    edges = gen.rmat(args.scale, args.deg, seed=0)
    n = int(edges.max()) + 1
    hold = len(edges) // 4 if args.ingest_blocks else 0  # live-ingest tail
    where = dict(impl=args.impl, device=args.device, backend=args.backend,
                 shards=args.shards)
    eng = engine.open(n, cfg, **where)
    eng.ingest(edges[: len(edges) - hold])
    mode = "continuous (snapshot rotation)" if args.continuous else \
        "epoch barrier"
    print(f"graph: n={n} m={len(edges)} (serving with {hold} edges held "
          f"back for live ingest); family={fam.name} backend={eng.backend} "
          f"shards={getattr(eng, 'shards', 1)} device={eng.device} "
          f"impl={eng.impl} mode={mode}")

    plans.reset_trace_counts()
    t0 = time.monotonic()
    errors: list = []
    if args.continuous:
        server = ContinuousServer(eng, rotation=RotationPolicy(every_blocks=1))
    else:
        server = QueryServer(eng)
    sampler = None if args.zipf is None else ZipfSampler(n, args.zipf)
    with server:
        threads = [threading.Thread(
            target=_client,
            args=(server, edges, n, args.requests, args.max_batch,
                  args.t_max, 17 + c, errors, sampler, kinds))
            for c in range(args.clients)]
        for t in threads:
            t.start()
        if hold:  # stream the held-back edges while clients are querying
            tail = edges[len(edges) - hold:]
            step = max(1, len(tail) // args.ingest_blocks)
            for s in range(0, len(tail), step):
                server.ingest(tail[s:s + step])
        for t in threads:
            t.join()
        if args.continuous:
            server.flush()  # apply + publish everything queued above
        rep_line = None
        if args.replicate:
            # workload-aware placement (DESIGN.md §12): the hot set the
            # client wave produced must be non-empty, and replicating it
            # must leave served answers bit-identical
            acc = server.stats()["access"]
            assert acc["top"], \
                "--replicate: expected a non-empty hot set after the wave"
            hot = np.asarray([v for v, _ in acc["top"]], np.int64)
            probe_sets = [hot, hot[: max(1, len(hot) // 2)]]
            probe_pairs = np.stack([hot, np.roll(hot, 1)], axis=1)
            pre_u = np.asarray(server.union_size(probe_sets))
            pre_i = np.asarray(server.intersection_size(probe_pairs))
            installed = server.replicate(
                policy=placement.PlacementPolicy(top_k=args.replicate))
            post_u = np.asarray(server.union_size(probe_sets))
            post_i = np.asarray(server.intersection_size(probe_pairs))
            assert np.array_equal(pre_u, post_u), \
                "union answers changed under replication"
            assert np.array_equal(pre_i, post_i), \
                "intersection answers changed under replication"
            counts = server.access_stats.counts()
            stream = np.repeat(np.arange(len(counts), dtype=np.int64),
                               counts)
            shards = getattr(eng, "shards", 1)
            off = placement.gather_traffic(stream, eng.n_pad, shards)
            on = placement.gather_traffic(stream, eng.n_pad, shards,
                                          hot_ids=installed)
            ratio = float(off.max()) / float(max(int(on.max()), 1))
            rep_line = (
                f"replicated {len(installed)} hot vertices "
                f"(top: {hot[:8].tolist()}); served answers bit-identical "
                f"pre/post; modeled max-owner gather traffic "
                f"{int(off.max())} -> {int(on.max())} rows "
                f"({ratio:.2f}x, shards={shards})")
        # deterministic served sample (the CI smoke contract): the final
        # answers ride the cached panels of the final epoch / snapshot
        _, glob = server.neighborhood(args.t_max)
        served_deg = np.asarray(server.degrees())
        stats = server.stats()
        panels = (server._slot.get() if args.continuous
                  else server.engine).panels_cached
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    if args.continuous:
        # rotation must never change an answer: post-flush served answers
        # are bit-identical to a direct engine call on the full edge set
        direct = engine.build(edges, n, cfg, **where)
        assert np.array_equal(served_deg, np.asarray(direct.degrees())), \
            "served degrees diverged from direct engine state"
        _, glob_direct = direct.neighborhood(args.t_max)
        assert np.array_equal(np.asarray(glob), np.asarray(glob_direct)), \
            "served neighborhood diverged from direct engine state"
        print("OK: served answers bit-identical to direct engine calls "
              "at the flushed snapshot version")
    print(f"neighborhood(t_max={args.t_max}) served: "
          f"Ñ(t)={np.array2string(np.asarray(glob), precision=0)} "
          f"({panels} D^t panels cached, t=1 included)")

    print(f"served {stats['requests_total']} requests from {args.clients} "
          f"clients in {wall:.2f}s ({stats['requests_total'] / wall:.1f} "
          f"req/s), final epoch={stats['epoch']}")
    for kind in ("degrees", "union", "intersection", "neighborhood",
                 "distance_histogram", "closeness", "effective_diameter",
                 "triangle"):
        s = stats.get(kind)
        if not s:
            continue
        print(f"  {kind:13s} requests={s['requests']:4d} "
              f"batches={s['batches']:4d} "
              f"max_coalesced={s['max_coalesced']:3d} "
              f"p50={s['p50_ms']:.1f}ms p99={s['p99_ms']:.1f}ms")
    if args.continuous:
        snap = stats["snapshot"]
        print(f"snapshot: version={snap['version']} "
              f"rotations={snap['rotations']} "
              f"staleness={snap['age_seconds'] * 1e3:.0f}ms "
              f"version_lag={snap['version_lag']}; "
              f"shed={stats['shed_total']} "
              f"deadline_misses={stats['deadline_misses']}")
    traces = stats["plan_traces"]
    cache = stats["plan_cache"]
    print(f"plans built per query kind (O(log max-batch) by shape "
          f"bucketing): {traces}")
    print(f"plan cache: {cache['hits']} hits / {cache['misses']} misses "
          f"(size {cache['size']}/{cache['maxsize']})")
    # the serving invariant: mixed client batch sizes ride few plans
    for kind in ("union", "intersection"):
        if kind in traces and kind in stats:
            max_b = args.max_batch * stats[kind]["max_coalesced"]
            bound = int(np.log2(max(max_b, 2))) + 2
            assert traces[kind] <= bound, (kind, traces[kind], bound)
    print("OK: plan count within the O(log batch) bound")
    if rep_line:
        print(f"OK: {rep_line}")
    if args.stats:
        # stats() sanitizes to native types (serve.server.to_native), so a
        # plain dumps works — no default=str silently stringifying numpy
        # scalars into values a consumer can't parse back
        print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
