#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the CUDA kernels of ``src/repro_torch/csrc`` from source, seven
   byte-layout launchers and six packed-layout ones;
3. graph: RMAT scale 22, edge factor 16, seed 0 (4.19M vertices, about
   64M undirected edges, the Graph500 Kronecker parameters), and the
   4,096 union sets ``{v} ∪ N(v)`` of seeded random vertices of degree
   1-63;
4. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   the bound (bytes this run's data needs over 3.35 TB/s) and, for
   accumulate, the ``scatter_reduce_`` yardstick. The estimate is also
   held on a sweep of p and ragged row counts in both layouts and timed
   on its own line at the triangle phase's block of 2^18 gathered rows.
   ``intersection_stats`` and ``union_estimate_stats`` are also timed as
   their C launchers alone (no wrapper), in both layouts; the pair
   kernel's byte sums of A and B must equal ``hll_estimate_stats`` of
   those rows bit for bit, and the union kernel is also held and timed
   on a skewed panel (4,096 sets ``{v} ∪ N(v)`` whose degrees follow the
   graph's own up to 1,023, a 4,096 x 1,024 panel).
   Accumulate runs the whole graph in one launch (every edge live, no
   mask) and is timed at
   the engine's launch shape, 2 x ``INGEST_BLOCK`` directed edges built
   on the card in the engine's order, on a fresh panel (ns per directed
   edge printed), and as a build's launches in a row, which must give
   the one-launch panel; propagate runs on the engine's dst-sorted
   routing, whose build (copy, orientations, stable sort on the card,
   slice by slice) is timed on a line of its own with the device memory
   it takes;
   ``hip_delta_rows`` on
   ``D^1``/``D^2`` of the scale-22 panel and on a sweep of ragged row
   counts with registers up to ``max_register`` and falling lanes, equal
   bit for bit; then each packed kernel on the packed scale-22 panel
   (512 MiB) at the same shapes, equal to its plain version bit for bit
   and to the byte kernel on the unpacked (clamped) panel, the packed
   accumulate equal to ``pack_rows`` of the byte panel and the packed
   propagate to ``pack_rows`` of the byte pass;
5. main path, with launch counters zeroed just before: ``engine.build``
   (``hll_accumulate`` launched once per ``INGEST_BLOCK`` chunk, 16
   times at scale 22), ``degrees`` (mean relative error against exact
   degrees), ``neighborhood(3)`` (``hll_propagate`` launched twice),
   ``intersection_size`` on 16,384 edge pairs with
   the MLE, ``union_size`` on the 4,096 sets (each must equal hop 2 of
   ``neighborhood(3)`` for its vertex) and ``query_batch`` over all three
   (bit for bit the per-kind answers); every kernel of the path must have
   launched; then the share of the pairs that the reference's
   Hessian-overflow flag holds still;
5s. serving, on the same graph, launch counters zeroed just before each
   served run: a ``QueryServer`` over a fresh byte engine, 8 client
   threads x 24 seeded requests (1/8 ``degrees``, 3/8 ``union_size`` of 8
   sets ``{v} ∪ N(v)``, 3/8 ``intersection_size`` of 64 edge pairs, 1/8
   ``neighborhood(3)``) with an ingest of 2^20 new edges half way as the
   epoch barrier, every answer equal to the direct call at its epoch bit
   for bit (accumulate, estimate, propagate, pair and set kernels
   launched); then a ``ContinuousServer`` (``RotationPolicy(
   every_blocks=4)``) whose writer ingests 16 blocks of 2^18 new edges,
   flushed every 4, while 4 reader threads query: every reader answer
   equal to the direct call at the snapshot version that served it, a
   snapshot taken before answering as it did throughout (its check's
   launches taken out of the phase's counts), the flushed registers
   equal to a one-shot build, one lease clone a rotation, the first
   snapshot's panel no longer shared;
   rotations, shed and deadline counts, per-kind p50/p99, the lease
   clone's time (CUDA events) against its bound and the phase's peak
   memory printed;
5b. packed main path, once the byte engine is freed, counters zeroed just
   before: the same steps with ``layout="packed"``, each timed, with peak
   memory and the same launch counts (then a short packed ``QueryServer``
   run, 8 x 8 requests, answers equal to the direct calls); the panel
   equal to ``pack_rows`` of the byte panel, every
   answer equal to the byte kernels' on the clamped panel bit for bit,
   ``pack_rows`` commuting with the propagate passes, the count of byte
   registers above 15 and of rows whose degrees differ from the byte
   engine's printed; every packed launcher of the path launched;
5c. packed durability, counters zeroed just before: ``save``/``load`` of
   the packed engine, ``load(layout="byte")`` equal to the exact unpack,
   and even/odd half builds merged equal to the one-shot packed build;
6. ADS, on the same graph once the main path's engine is freed, counters
   zeroed just before: ``engine.build(..., ADSConfig(p=8),
   family="ads")``, ``distance_histogram(6)``, ``closeness(6)``,
   ``effective_diameter(6, q=0.9)``, each timed; histograms non-negative
   and summing to ``glob``, ``C^1`` equal to ``degrees()``, the diameter
   in ``[0, 6]`` and equal to the curve's; repeats run no propagate pass
   and no kernel; ``hip_delta_rows`` launched 5 times; the per-vertex mean
   relative error of the curve against exact ball sizes of 32 seeded
   sources (a multi-source BFS with ``index_add_`` on the card) below
   ``3 * rel_std(8)``;
7. merge: the even- and odd-indexed edges built apart and merged equal
   the one-shot ADS panel bit for bit;
8. checkpoint: ``save`` the ADS engine under ``build/``, ``load`` it,
   registers and ``distance_histogram(6)`` bit for bit, and a further
   ingest into both engines gives the same registers;
8s. serving, continued: one served ``distance_histogram(6)`` on the ADS
   engine (cold), equal to the direct call, and its repeat served from a
   snapshot with no launch and no propagate pass; then the
   ``ContinuousServer``'s failover writer at RMAT scale 16 (the phase's
   cost is host checkpoint I/O, not kernels): checkpoints every 4 blocks
   under ``build/``, the writer killed at block 6, registers after
   ``flush`` equal to the run without faults, directory removed;
9. triangles, with launch counters zeroed just before: RMAT scale 20,
   edge factor 16, seed 0, ``engine.build`` and
   ``triangle_heavy_hitters(k=100, mode="edge")`` (finite values in
   descending order, real edges, a positive total, ``ertl_stats`` and
   ``hll_estimate_stats`` launched);
10. small reference: the same queries at RMAT scale 10 on the CPU (plain
    versions) and on the card, which must agree, the top-20 recall of
    the estimated triangle heavy hitters against exact counts (reported),
    and the ADS curve of both against each other (``rtol=1e-6``) and
    against exact ball sizes (the tolerances of ``tests/test_ads.py``);
    then the packed engine on both, triangles (edge and vertex) included,
    with counters zeroed just before the card's run (the engine path of
    ``ertl_stats_packed``), the card's answers also equal to the byte
    kernels' on the clamped panel bit for bit.

Then the kernels JSON line (every launcher launched on a counted path),
the card line, and the last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without that line; so does a run without a CUDA device or
outside the repository.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
N_PAIRS = 16384
N_SETS = 4096
ERTL_PAIRS = 1 << 18
T_MAX = 3
TRI_SCALE, TRI_K = 20, 100
ADS_T, ADS_SOURCES = 6, 32
SERVE_CLIENTS, SERVE_REQS, SERVE_SETS, SERVE_PAIRS = 8, 24, 8, 64
SERVE_INGEST = 1 << 20
CONT_BLOCKS, CONT_BLOCK, CONT_READERS = 16, 1 << 18, 4
FT_SCALE, FT_BLOCKS = 16, 12
SERVE_WAIT = 300  # seconds any serving wait may take before the smoke fails
DEVICE = "cuda"

SOURCES = {
    "hll_accumulate": ("src/repro_torch/csrc/hll_accumulate.cu",
                       "src/repro/kernels/hll_accumulate.py:77"),
    "hll_estimate_stats": ("src/repro_torch/csrc/hll_estimate.cu",
                           "src/repro/kernels/hll_estimate.py:45"),
    "hll_propagate": ("src/repro_torch/csrc/hll_propagate.cu",
                      "src/repro/kernels/hll_propagate.py:55"),
    "intersection_stats": ("src/repro_torch/csrc/intersection_stats.cu",
                           "src/repro/kernels/intersection_stats.py:75"),
    "union_estimate_stats": ("src/repro_torch/csrc/union_estimate.cu",
                             "src/repro/kernels/union_estimate.py:69"),
    "ertl_stats": ("src/repro_torch/csrc/ertl_stats.cu",
                   "src/repro/kernels/ertl_stats.py:55"),
    "hip_delta_rows": ("src/repro_torch/csrc/hip_delta.cu",
                       "src/repro/kernels/hip_delta.py:39"),
    # packed-layout variants: the Pallas kernels' packed bodies
    "hll_accumulate_packed": ("src/repro_torch/csrc/hll_accumulate.cu",
                              "src/repro/kernels/hll_accumulate.py:63"),
    "hll_estimate_stats_packed": ("src/repro_torch/csrc/hll_estimate.cu",
                                  "src/repro/kernels/hll_estimate.py:31"),
    "hll_propagate_packed": ("src/repro_torch/csrc/hll_propagate.cu",
                             "src/repro/kernels/hll_propagate.py:32"),
    "intersection_stats_packed": (
        "src/repro_torch/csrc/intersection_stats.cu",
        "src/repro/kernels/intersection_stats.py:47"),
    "union_estimate_stats_packed": ("src/repro_torch/csrc/union_estimate.cu",
                                    "src/repro/kernels/union_estimate.py:40"),
    "ertl_stats_packed": ("src/repro_torch/csrc/ertl_stats.cu",
                          "src/repro/kernels/ertl_stats.py:34"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, setup=None) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).

    ``setup`` (untimed) builds fresh arguments for each run.
    """
    pairs = []
    for _ in range(reps):
        args = setup() if setup is not None else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def launcher_ms(torch, name, args, reps: int = 20) -> float:
    """Median device time of C launcher ``name`` alone (no wrapper, no
    launch count) on ``args``, ``reps`` calls in a row."""
    from repro_torch.kernels import _build
    fn = getattr(_build.library(), name)

    def call():
        if fn(*args) != 0:
            fail(f"{name} failed to launch")
    return cuda_ms(torch, call, reps)


def pair_launcher_ms(torch, regs, pa, pb, q, layout) -> float:
    """``launcher_ms`` of intersection_stats on these pairs."""
    from repro_torch.kernels import _build
    b, w = pa.shape[0], regs.shape[1]
    stats = torch.empty((b, 5, q + 2), dtype=torch.float32,
                        device=regs.device)
    sz = torch.empty((b, 3, 2), dtype=torch.float32, device=regs.device)
    return launcher_ms(torch, _build.kernel_name("intersection_stats", layout),
                       (regs.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                        stats.data_ptr(), sz.data_ptr(), b, regs.shape[0],
                        2 * w if layout == "packed" else w, q,
                        torch.cuda.current_stream().cuda_stream))


def set_launcher_ms(torch, regs, ids, mask, layout) -> float:
    """``launcher_ms`` of union_estimate_stats on this set panel."""
    from repro_torch.kernels import _build
    b, w = ids.shape[0], regs.shape[1]
    out = torch.empty((b, 2), dtype=torch.float32, device=regs.device)
    return launcher_ms(torch, _build.kernel_name("union_estimate_stats",
                                                 layout),
                       (regs.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), b, regs.shape[0], ids.shape[1],
                        2 * w if layout == "packed" else w,
                        torch.cuda.current_stream().cuda_stream))


def compare_skewed_union(torch, np, regs, skew, layout):
    """union_estimate_stats against its plain version on the skewed panel:
    4,096 sets whose degrees follow the graph's own distribution up to
    1,023 (a 4,096 x 1,024 panel); timed on a line of its own."""
    from repro_torch.engine import plans
    from repro_torch.kernels import union_estimate
    ids_np, mask_np = plans.pad_sets(skew)
    ids = torch.from_numpy(ids_np).to(regs.device)
    mask = torch.from_numpy(mask_np).to(regs.device)
    got = union_estimate.union_estimate_stats(regs, ids, mask, layout=layout)
    want = union_estimate.plain(regs, ids, mask, layout=layout)
    torch.cuda.synchronize()
    exact = torch.equal(got, want) if layout == "packed" else (
        torch.equal(got[:, 1], want[:, 1]) and torch.allclose(
            got[:, 0], want[:, 0], rtol=1e-6, atol=0))
    if not exact:
        fail(f"union_estimate_stats ({layout}) differs from its plain "
             f"version on the skewed panel")
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs, ids, mask, layout=layout), 20)
    alone = set_launcher_ms(torch, regs, ids, mask, layout)
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(
        regs, ids, mask, layout=layout), 3)
    members = int(mask_np.sum())
    bnd = bound_ms(np.unique(ids_np[mask_np]).size * regs.shape[1]
                   + 5 * ids_np.size + 8 * ids_np.shape[0])
    log(f"kernel vs plain: union_estimate_stats ({layout}) on the skewed "
        f"panel: max abs err {float((got - want).abs().max())}, kernel "
        f"{ms:.4f} ms, launcher alone {alone:.4f} ms "
        f"({alone * 1e6 / members:.3f} ns a member row), plain "
        f"{plain_ms:.4f} ms, bound {bnd:.4f} ms (bytes); "
        f"{ids_np.shape[0]} x {ids_np.shape[1]} panel, {members} members")


def neighbor_sets(np, edges, n, rng, count=None, max_degree=63):
    """``{v} ∪ N(v)`` for ``count`` (default N_SETS) seeded random vertices
    of degree 1 to ``max_degree``, drawn uniformly, so their degrees
    follow the graph's own distribution below the cap.

    One vectorised pass over the edge list: the directed entries whose
    source was chosen are sorted by the source's slot and split per set.
    Returns (vertices int64[count], list of int64 id arrays).
    """
    count = N_SETS if count is None else count
    deg = np.bincount(edges.ravel(), minlength=n)
    verts = rng.choice(np.flatnonzero((deg >= 1) & (deg <= max_degree)),
                       count, replace=False)
    slot = np.full(n, -1, np.int64)
    slot[verts] = np.arange(count)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    keep = slot[src] >= 0
    order = np.argsort(slot[src[keep]], kind="stable")
    nbrs = dst[keep][order].astype(np.int64)
    parts = np.split(nbrs, np.cumsum(deg[verts])[:-1])
    return verts, [np.concatenate([[v], part]) for v, part in zip(verts, parts)]


def compare_kernels(torch, np, edges, n, pairs, sets, skew, report):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.engine import plans
    from repro_torch.kernels import ertl_stats, hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
    from repro_torch.kernels import union_estimate

    dev = torch.device(DEVICE)
    r, q = 1 << P, 64 - P
    n_pad = -(-n // 8) * 8
    directed = np.concatenate([edges, edges[:, ::-1]])
    rows = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    keys = torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev)

    # accumulate: the whole graph through the kernel and the plain version,
    # every edge live (mask=None, as the engine launches it)
    regs_k = torch.zeros((n_pad, r), dtype=torch.uint8, device=dev)
    regs_p = torch.zeros_like(regs_k)
    hll_accumulate.hll_accumulate(regs_k, rows, keys, p=P, seed=0)
    hll_accumulate.plain(regs_p, rows, keys, p=P, seed=0)
    torch.cuda.synchronize()
    err = int((regs_k.to(torch.int16) - regs_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_accumulate differs from its plain version (max {err})")
    del regs_p, rows, keys
    report(*accumulate_timing(torch, np, edges, n_pad, "byte", regs_k, err))

    # estimate: the built panel, then a sweep of p and ragged row counts
    out_k = hll_estimate.hll_estimate_stats(regs_k)
    out_p = hll_estimate.plain(regs_k)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("hll_estimate_stats differs from its plain version")
    err = float((out_k - out_p).abs().max())
    compare_estimate_sweep(torch, np)
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(regs_k), 10)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(regs_k), 3)
    report("hll_estimate_stats", err, ms, plain_ms,
           bound_ms(n_pad * r + n_pad * 8), None,
           f"{n_pad} rows; sweep of p 3-16 and ragged row counts equal")

    # propagate: the whole directed routing, as the engine routes it
    src, dst = routing_timing(torch, np, edges)
    prop_k = hll_propagate.hll_propagate(regs_k, src, dst)
    prop_p = hll_propagate.plain(regs_k, src, dst)
    torch.cuda.synchronize()
    err = int((prop_k.to(torch.int16) - prop_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_propagate differs from its plain version (max {err})")
    del prop_p
    ms = cuda_ms(torch, lambda: hll_propagate.hll_propagate(regs_k, src, dst),
                 5)
    plain_ms = cuda_ms(torch, lambda: hll_propagate.plain(regs_k, src, dst), 1)
    e_live = src.numel()
    report("hll_propagate", err, ms, plain_ms,
           bound_ms(2 * n_pad * r + 8 * e_live), None,
           f"{e_live} directed edges, dst-sorted routing")
    del src, dst
    compare_hip_delta(torch, np, regs_k, prop_k, report)
    del prop_k

    # intersection_stats: the main path's pairs
    ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st_k, sz_k = intersection_stats.intersection_stats(regs_k, pa, pb, q)
    st_p, sz_p = intersection_stats.plain(regs_k, pa, pb, q)
    est = hll_estimate.hll_estimate_stats(regs_k)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(sz_k[..., 1], sz_p[..., 1])
            and torch.allclose(sz_k[..., 0], sz_p[..., 0], rtol=1e-6, atol=0)):
        fail("intersection_stats differs from its plain version")
    if not (torch.equal(sz_k[:, 0, 0], est[pa.long(), 0])
            and torch.equal(sz_k[:, 1, 0], est[pb.long(), 0])):
        fail("intersection_stats' exact sums differ from hll_estimate_stats")
    err = max(float((st_k - st_p).abs().max()),
              float((sz_k - sz_p).abs().max()))
    ms = cuda_ms(torch, lambda: intersection_stats.intersection_stats(
        regs_k, pa, pb, q), 20)
    alone = pair_launcher_ms(torch, regs_k, pa, pb, q, "byte")
    plain_ms = cuda_ms(torch, lambda: intersection_stats.plain(
        regs_k, pa, pb, q), 3)
    rows_read = torch.unique(ids).numel()
    b = ids.shape[0]
    report("intersection_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 8 * b + 4 * b * (5 * (q + 2) + 6)), None,
           f"{b} pairs, {rows_read} distinct rows, launcher alone "
           f"{alone:.4f} ms; s of A and B equal hll_estimate_stats")

    # union_estimate_stats: the main path's padded set panel
    ids_np, mask_np = plans.pad_sets(sets)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    out_k = union_estimate.union_estimate_stats(regs_k, ids, mask)
    out_p = union_estimate.plain(regs_k, ids, mask)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("union_estimate_stats differs from its plain version")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs_k, ids, mask), 20)
    alone = set_launcher_ms(torch, regs_k, ids, mask, "byte")
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(regs_k, ids, mask),
                       3)
    rows_read = np.unique(ids_np[mask_np]).size
    report("union_estimate_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 5 * ids_np.size + 8 * ids_np.shape[0]),
           None, f"{ids_np.shape[0]} x {ids_np.shape[1]} set panel, "
                 f"{int(mask_np.sum())} members, {rows_read} distinct rows, "
                 f"launcher alone {alone:.4f} ms")
    compare_skewed_union(torch, np, regs_k, skew, "byte")

    # ertl_stats: 2^18 edge pairs gathered from the built panel
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int64)).to(dev)
    a, b = regs_k[ends[:, 0]], regs_k[ends[:, 1]]
    st_k = ertl_stats.ertl_stats(a, b, q)
    st_p = ertl_stats.plain(a, b, q)
    torch.cuda.synchronize()
    if not torch.equal(st_k, st_p):
        fail("ertl_stats differs from its plain version")
    err = float((st_k - st_p).abs().max())
    del st_k, st_p
    ms = cuda_ms(torch, lambda: ertl_stats.ertl_stats(a, b, q), 10)
    plain_ms = cuda_ms(torch, lambda: ertl_stats.plain(a, b, q), 3)
    report("ertl_stats", err, ms, plain_ms,
           bound_ms(ERTL_PAIRS * (2 * r + 4 * 5 * (q + 2))), None,
           f"{ERTL_PAIRS} gathered edge pairs")

    # estimate at the triangle phase's shape: one block of gathered rows
    out_k = hll_estimate.hll_estimate_stats(a)
    out_p = hll_estimate.plain(a)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("hll_estimate_stats differs from its plain version on the "
             "triangle block")
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(a), 20)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(a), 3)
    log(f"kernel vs plain: hll_estimate_stats at the triangle block: max abs "
        f"err {float((out_k - out_p).abs().max())}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound "
        f"{bound_ms(ERTL_PAIRS * (r + 8)):.4f} ms (bytes); {ERTL_PAIRS} "
        f"gathered rows")
    return regs_k.cpu()


def compare_estimate_sweep(torch, np):
    """hll_estimate_stats in both layouts against the plain versions at
    p 3-16 (packed 4-16) and row counts that leave the kernel's row groups
    ragged, with all-zero rows and byte registers up to 255 (the slow
    path): byte ``z`` exact and ``s`` within ``rtol=1e-6``; packed bit for
    bit, and equal to the byte kernel on the unpacked panel (both take
    the exact sum and round it once)."""
    from repro_torch.kernels import hll_estimate, packing
    rng = np.random.default_rng(SEED + 4)
    for p, m in ((3, 33), (4, 1), (6, 5), (8, 7), (8, 9), (8, 1001),
                 (9, 77), (10, 3), (12, 515), (14, 17), (16, 7)):
        full = rng.integers(0, 22, (m, 1 << p)).astype(np.uint8)
        full[::3] = 0
        byte = torch.from_numpy(full).to(DEVICE)
        wild = byte.clone()
        wild[1::3, ::5] = torch.from_numpy(rng.integers(
            100, 256, wild[1::3, ::5].shape).astype(np.uint8)).to(DEVICE)
        for panel in (byte, wild):
            got = hll_estimate.hll_estimate_stats(panel)
            want = hll_estimate.plain(panel)
            if not torch.equal(got[:, 1], want[:, 1]) or not torch.allclose(
                    got[:, 0], want[:, 0], rtol=1e-6, atol=0):
                fail(f"hll_estimate_stats differs from its plain version at "
                     f"p={p}, {m} rows")
        if p < 4:
            continue
        packed = packing.pack_rows(byte)
        got = hll_estimate.hll_estimate_stats(packed, layout="packed")
        if not torch.equal(got, hll_estimate.plain(packed, layout="packed")):
            fail(f"hll_estimate_stats_packed differs from its plain version "
                 f"at p={p}, {m} rows")
        if not torch.equal(got, hll_estimate.hll_estimate_stats(
                packing.unpack_rows(packed))):
            fail(f"hll_estimate_stats_packed differs from the byte kernel "
                 f"on the clamped panel at p={p}, {m} rows")


def accumulate_timing(torch, np, edges, n_pad, layout, built, err):
    """hll_accumulate at the engine's launch shape: each ``INGEST_BLOCK``
    chunk of undirected edges becomes 2 x ``INGEST_BLOCK`` directed edges
    built on the card by ``directed_block``, in the engine's order. Times
    one launch on a fresh panel (median over the first chunks), the plain
    version on the same, PyTorch's ``scatter_reduce_`` on pre-hashed
    indices (byte layout) and a build's launches in a row, whose panel
    must equal ``built`` (the one-launch panel). Returns ``report``'s
    arguments; ``err`` is the whole-graph comparison's."""
    from repro_torch.core.hashing import bucket_rho
    from repro_torch.engine.base import SketchEngine
    from repro_torch.engine.local import directed_block
    from repro_torch.kernels import hll_accumulate

    dev = torch.device(DEVICE)
    packed = layout == "packed"
    name = "hll_accumulate_packed" if packed else "hll_accumulate"
    w = (1 << P) // (2 if packed else 1)
    blk = SketchEngine.INGEST_BLOCK
    chunks = [directed_block(edges[s:s + blk], dev)
              for s in range(0, len(edges), blk)]
    n_dir = chunks[0][0].numel()
    reps = min(5, len(chunks))
    panel = torch.zeros((n_pad, w), dtype=torch.uint8, device=dev)
    it = iter(chunks[:reps] * 2)

    def fresh():
        panel.zero_()
        return next(it)

    ms = cuda_ms(torch, lambda ro, ke: hll_accumulate.hll_accumulate(
        panel, ro, ke, p=P, layout=layout), reps, fresh)
    plain_ms = cuda_ms(torch, lambda ro, ke: hll_accumulate.plain(
        panel, ro, ke, p=P, layout=layout), reps, fresh)
    panel.zero_()
    build_ms = cuda_ms(torch, lambda: [hll_accumulate.hll_accumulate(
        panel, ro, ke, p=P, layout=layout) for ro, ke in chunks], 1)
    if not torch.equal(panel, built):
        fail(f"{name}: the build's {len(chunks)} chunk launches differ from "
             f"the one-launch panel")
    rows0, keys0 = chunks[0]
    bkt = bucket_rho(keys0, P)[0]
    if packed:  # bytes touched
        idx = rows0.to(torch.int64) * w + bkt % w
    else:
        idx = rows0.to(torch.int64) * w + bkt
    touched = torch.unique(idx).numel()
    lib_ms = None
    if not packed:
        hashed = [(ro, *bucket_rho(ke, P)) for ro, ke in chunks[:reps]]
        it_lib = iter([(ro.to(torch.int64) * w + b, rho)
                       for ro, b, rho in hashed])

        def fresh_lib():
            panel.zero_()
            return next(it_lib)

        lib_ms = cuda_ms(torch, lambda i, v: panel.view(-1).scatter_reduce_(
            0, i, v, reduce="amax"), reps, fresh_lib)
    log(f"accumulate: {name}: one launch of {n_dir} directed edges "
        f"{ms:.4f} ms = {ms * 1e6 / n_dir:.3f} ns per directed edge; a "
        f"build's {len(chunks)} launches {build_ms:.3f} ms")
    return (name, err, ms, plain_ms, bound_ms(8 * n_dir + 2 * touched),
            lib_ms, f"one launch of {n_dir} directed edges (2 x "
                    f"INGEST_BLOCK, engine order, fresh panel), "
                    f"{ms * 1e6 / n_dir:.3f} ns/edge, {touched} registers "
                    f"touched; the build's {len(chunks)} launches "
                    f"{build_ms:.3f} ms, equal to the one-launch panel")


def routing_timing(torch, np, edges):
    """The engine's propagate routing (``directed_routing``: the edge list
    copied to the card once, both orientations and the stable dst sort
    built there slice by slice), timed three times on the host clock, one
    ``sort_routing`` of the whole routing with CUDA events, and the device
    memory the build takes at its peak and keeps. Prints one line;
    returns the routing."""
    from repro_torch.engine.local import directed_routing
    from repro_torch.kernels.hll_propagate import sort_routing

    dev = torch.device(DEVICE)
    secs = []
    routing = None
    for _ in range(3):
        routing = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        routing, t = timed(torch, lambda: directed_routing(edges, dev))
        secs.append(t)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    kept = (torch.cuda.memory_allocated() - base) / 2 ** 30
    e = torch.from_numpy(edges).to(dev)
    src, dst = torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]])
    del e
    sort_ms = cuda_ms(torch, lambda: sort_routing(src, dst), 3)
    del src, dst
    log(f"routing: directed_routing of {len(edges)} undirected edges "
        f"({2 * len(edges)} directed): {statistics.median(secs):.4f} s "
        f"median of {[round(t, 4) for t in secs]} (host clock); one stable "
        f"dst sort of the whole routing {sort_ms:.3f} ms (CUDA events); device memory "
        f"+{peak:.2f} GiB at its peak, {kept:.2f} GiB kept")
    return routing


def compare_hip_delta(torch, np, prev, cur, report):
    """hip_delta_rows against its plain version: D^1 -> D^2 of the main
    panel, then ragged row counts with registers up to max_register and
    lanes that fell. Exact equality (both sum exactly, round once)."""
    from repro_torch.kernels import hip_delta
    out_k = hip_delta.hip_delta_rows(prev, cur)
    out_p = hip_delta.plain(prev, cur)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail("hip_delta_rows differs from its plain version on D^1 -> D^2")
    err = float((out_k - out_p).abs().max())
    rows, r = prev.shape
    grew = int((out_k > 0).sum())
    rng = np.random.default_rng(SEED + 3)
    for p, m in ((4, 1), (8, 33), (8, 4097), (12, 515), (16, 7)):
        top = 65 - p
        a = rng.integers(0, top + 1, (m, 1 << p))
        b = np.clip(a + rng.integers(-3, 4, a.shape), 0, top)
        a_t, b_t = (torch.from_numpy(x.astype(np.uint8)).to(DEVICE)
                    for x in (a, b))
        if not torch.equal(hip_delta.hip_delta_rows(a_t, b_t),
                           hip_delta.plain(a_t, b_t)):
            fail(f"hip_delta_rows differs from its plain version at p={p}, "
                 f"{m} rows")
    ms = cuda_ms(torch, lambda: hip_delta.hip_delta_rows(prev, cur), 10)
    plain_ms = cuda_ms(torch, lambda: hip_delta.plain(prev, cur), 3)
    report("hip_delta_rows", err, ms, plain_ms,
           bound_ms(2 * rows * r + 4 * rows), None,
           f"D^1 -> D^2, {rows} rows, {grew} grew; sweep of p 4-16 equal")


def compare_packed_kernels(torch, np, edges, n, pairs, sets, skew, panel,
                           report):
    """Phase 4, packed layout: each packed kernel against its plain
    version on the card at the main path's shapes (the scale-22 panel
    packed, 512 MiB), every output equal bit for bit, and equal to the
    byte kernel on the unpacked (clamped) panel. ``panel`` is the byte
    panel on the host; returns its packed image, on the host."""
    from repro_torch.engine import plans
    from repro_torch.kernels import ertl_stats, hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
    from repro_torch.kernels import packing, union_estimate

    dev = torch.device(DEVICE)
    w, q = 1 << (P - 1), 64 - P
    n_pad = panel.shape[0]
    byte = panel.to(dev)
    want = packing.pack_rows(byte)

    def reg_err(a, b):
        """Max abs difference over the unpacked registers."""
        return int((packing.unpack_rows(a).to(torch.int16)
                    - packing.unpack_rows(b).to(torch.int16)).abs().max())

    directed = np.concatenate([edges, edges[:, ::-1]])
    rows = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    keys = torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev)

    # accumulate: the whole graph through the kernel and the plain version
    regs_k = torch.zeros((n_pad, w), dtype=torch.uint8, device=dev)
    regs_p = torch.zeros_like(regs_k)
    hll_accumulate.hll_accumulate(regs_k, rows, keys, p=P, seed=0,
                                  layout="packed")
    hll_accumulate.plain(regs_p, rows, keys, p=P, seed=0, layout="packed")
    torch.cuda.synchronize()
    err = reg_err(regs_k, regs_p)
    if err != 0:
        fail(f"hll_accumulate_packed differs from its plain version "
             f"(max {err})")
    if not torch.equal(regs_k, want):
        fail("hll_accumulate_packed differs from pack_rows of the byte panel")
    del regs_p, rows, keys
    report(*accumulate_timing(torch, np, edges, n_pad, "packed", regs_k,
                              err))

    # estimate: the packed panel; the byte kernel on the clamped panel
    clamped = packing.unpack_rows(regs_k)
    out_k = hll_estimate.hll_estimate_stats(regs_k, layout="packed")
    out_p = hll_estimate.plain(regs_k, layout="packed")
    out_b = hll_estimate.hll_estimate_stats(clamped)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_k, out_b)):
        fail("hll_estimate_stats_packed differs from its plain version or "
             "from the byte kernel on the clamped panel")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(
        regs_k, layout="packed"), 10)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(
        regs_k, layout="packed"), 3)
    report("hll_estimate_stats_packed", err, ms, plain_ms,
           bound_ms(n_pad * w + n_pad * 8), None,
           f"{n_pad} rows; equal to the byte kernel on the clamped panel")

    # propagate: the engine's routing; pack_rows commutes with the pass
    from repro_torch.engine.local import directed_routing
    src, dst = directed_routing(edges, dev)
    prop_k = hll_propagate.hll_propagate(regs_k, src, dst, layout="packed")
    prop_p = hll_propagate.plain(regs_k, src, dst, layout="packed")
    torch.cuda.synchronize()
    err = reg_err(prop_k, prop_p)
    if err != 0:
        fail(f"hll_propagate_packed differs from its plain version "
             f"(max {err})")
    del prop_p
    prop_b = hll_propagate.hll_propagate(byte, src, dst)
    if not torch.equal(packing.pack_rows(prop_b), prop_k):
        fail("pack_rows does not commute with the propagate pass")
    del prop_b, prop_k, byte
    ms = cuda_ms(torch, lambda: hll_propagate.hll_propagate(
        regs_k, src, dst, layout="packed"), 5)
    plain_ms = cuda_ms(torch, lambda: hll_propagate.plain(
        regs_k, src, dst, layout="packed"), 1)
    e_live = src.numel()
    report("hll_propagate_packed", err, ms, plain_ms,
           bound_ms(2 * n_pad * w + 8 * e_live), None,
           f"{e_live} directed edges, dst-sorted routing; pack_rows(byte "
           f"pass) equal")
    del src, dst

    # intersection_stats: the main path's pairs
    ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st_k, sz_k = intersection_stats.intersection_stats(regs_k, pa, pb, q,
                                                       layout="packed")
    st_p, sz_p = intersection_stats.plain(regs_k, pa, pb, q, layout="packed")
    st_b, sz_b = intersection_stats.intersection_stats(clamped, pa, pb, q)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(sz_k, sz_p)
            and torch.equal(st_k, st_b) and torch.equal(sz_k, sz_b)):
        fail("intersection_stats_packed differs from its plain version or "
             "from the byte kernel on the clamped panel")
    err = max(float((st_k - st_p).abs().max()),
              float((sz_k - sz_p).abs().max()))
    ms = cuda_ms(torch, lambda: intersection_stats.intersection_stats(
        regs_k, pa, pb, q, layout="packed"), 20)
    alone = pair_launcher_ms(torch, regs_k, pa, pb, q, "packed")
    plain_ms = cuda_ms(torch, lambda: intersection_stats.plain(
        regs_k, pa, pb, q, layout="packed"), 3)
    rows_read = torch.unique(ids).numel()
    b = ids.shape[0]
    report("intersection_stats_packed", err, ms, plain_ms,
           bound_ms(rows_read * w + 8 * b + 4 * b * (5 * (q + 2) + 6)), None,
           f"{b} pairs, {rows_read} distinct rows, launcher alone "
           f"{alone:.4f} ms")

    # union_estimate_stats: the main path's padded set panel
    ids_np, mask_np = plans.pad_sets(sets)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    out_k = union_estimate.union_estimate_stats(regs_k, ids, mask,
                                                layout="packed")
    out_p = union_estimate.plain(regs_k, ids, mask, layout="packed")
    out_b = union_estimate.union_estimate_stats(clamped, ids, mask)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_k, out_b)):
        fail("union_estimate_stats_packed differs from its plain version "
             "or from the byte kernel on the clamped panel")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: union_estimate.union_estimate_stats(
        regs_k, ids, mask, layout="packed"), 20)
    alone = set_launcher_ms(torch, regs_k, ids, mask, "packed")
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(
        regs_k, ids, mask, layout="packed"), 3)
    rows_read = np.unique(ids_np[mask_np]).size
    report("union_estimate_stats_packed", err, ms, plain_ms,
           bound_ms(rows_read * w + 5 * ids_np.size + 8 * ids_np.shape[0]),
           None, f"{ids_np.shape[0]} x {ids_np.shape[1]} set panel, "
                 f"{rows_read} distinct rows, launcher alone {alone:.4f} ms")
    compare_skewed_union(torch, np, regs_k, skew, "packed")

    # ertl_stats: 2^18 edge pairs gathered from the packed panel
    pick = np.random.default_rng(SEED + 1).choice(len(edges), ERTL_PAIRS,
                                                  replace=False)
    ends = torch.from_numpy(edges[pick].astype(np.int64)).to(dev)
    a, c = regs_k[ends[:, 0]], regs_k[ends[:, 1]]
    st_k = ertl_stats.ertl_stats(a, c, q, layout="packed")
    st_p = ertl_stats.plain(a, c, q, layout="packed")
    st_b = ertl_stats.ertl_stats(packing.unpack_rows(a),
                                 packing.unpack_rows(c), q)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(st_k, st_b)):
        fail("ertl_stats_packed differs from its plain version or from the "
             "byte kernel on the unpacked rows")
    err = float((st_k - st_p).abs().max())
    del st_k, st_p, st_b, clamped
    ms = cuda_ms(torch, lambda: ertl_stats.ertl_stats(a, c, q,
                                                      layout="packed"), 10)
    plain_ms = cuda_ms(torch, lambda: ertl_stats.plain(a, c, q,
                                                       layout="packed"), 3)
    report("ertl_stats_packed", err, ms, plain_ms,
           bound_ms(ERTL_PAIRS * (2 * w + 4 * 5 * (q + 2))), None,
           f"{ERTL_PAIRS} gathered edge pairs")
    return regs_k.cpu()


def main_path(torch, np, edges, n, pairs, verts, sets, panel):
    """Phase 5: the port's main path through its entry points."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.kernels import _build

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()

    def step(name, fn, extra=lambda out: ""):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"main: {name}: {secs:.3f} s, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"launches {_build.launch_counts()}{extra(out)}")
        return out, secs

    eng, secs = step("build", lambda: engine.build(
        edges, n, HLLConfig(p=P), device=DEVICE))
    launch_check("main", "hll_accumulate", _build.launch_counts(), 0,
                 -(-len(edges) // eng.INGEST_BLOCK), "build")
    log(f"main: build: {len(edges) / secs / 1e6:.2f} M undirected edges/s "
        f"({2 * len(edges) / secs / 1e6:.2f} M directed inserts/s)")
    if eng.device.type != DEVICE or not torch.equal(eng.regs.cpu(), panel):
        fail("engine.build's panel differs from the kernel-checked panel")

    exact = np.bincount(edges.ravel(), minlength=n).astype(np.float64)
    has = exact > 0

    def mre(deg):
        return float(np.mean(np.abs(deg[has] - exact[has]) / exact[has]))

    deg, _ = step("degrees", eng.degrees,
                  lambda d: f", mean relative error {mre(d):.4f}")
    if not (np.isfinite(deg).all() and deg.shape == (n,)):
        fail("degrees are not finite or have the wrong shape")
    if mre(deg) >= 3 * rel_std(P):
        fail(f"degree error {mre(deg):.4f} >= 3 x 1.04/sqrt(r)")

    before = _build.launch_counts()
    (loc, glob), _ = step("neighborhood", lambda: eng.neighborhood(T_MAX),
                          lambda o: f", global sizes {o[1].tolist()}")
    launch_check("main", "hll_propagate", _build.launch_counts(), before,
                 T_MAX - 1, f"neighborhood({T_MAX})")
    if loc.shape != (T_MAX, n) or not np.isfinite(loc).all():
        fail("neighborhood sizes are not finite or have the wrong shape")
    if not np.array_equal(loc[0], deg) or not np.all(np.diff(glob) > 0):
        fail("neighborhood: hop 1 must equal degrees and sizes must grow")

    est, _ = step("intersection_size",
                  lambda: eng.intersection_size(pairs, method="mle"),
                  lambda e: f", {len(pairs)} pairs, median estimate "
                            f"{np.median(e):.3f}")
    if est.shape != (len(pairs),) or not np.isfinite(est).all():
        fail("intersection estimates are not finite or have the wrong shape")

    uni, _ = step("union_size", lambda: eng.union_size(sets),
                  lambda u: f", {len(sets)} sets of up to "
                            f"{max(map(len, sets))} ids, median "
                            f"{np.median(u):.3f}")
    hop2 = loc[1][verts]
    if uni.shape != (len(sets),) or not np.allclose(uni, hop2, rtol=1e-5,
                                                    atol=0):
        fail("union_size({v} u N(v)) differs from hop 2 of neighborhood")
    log(f"main: union_size: max relative difference to hop 2 "
        f"{float(np.max(np.abs(uni - hop2) / hop2)):.3e}")

    batch, _ = step("query_batch", lambda: eng.query_batch(
        degrees=True, vertex_sets=sets, pairs=pairs, method="mle"))
    if not (np.array_equal(batch["degrees"], deg)
            and np.array_equal(batch["union"], uni)
            and np.array_equal(batch["intersection"], est)):
        fail("query_batch differs from the per-kind answers")
    log("main: query_batch: degrees, union and intersection equal the "
        "per-kind answers bit for bit")
    counts = _build.launch_counts()
    log(f"kernels: {counts}")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "hll_propagate", "intersection_stats",
                           "union_estimate_stats") if counts[k] == 0]
    if missing:
        fail(f"main-path kernels never launched: {missing}")
    overflow_share(torch, eng, pairs)
    return counts, deg


def launch_check(label, kernel, counts, before, want, what):
    """Fail unless ``kernel`` launched ``want`` times in ``what``:
    ``counts`` now, ``before`` the counts at its start (0: all zero)."""
    got = counts[kernel] - (before[kernel] if before else 0)
    log(f"{label}: launches: {what} launched {kernel} {got} times "
        f"(expected {want})")
    if got != want:
        fail(f"{label}: {what} launched {kernel} {got} times, not {want}")


def packed_path(torch, np, edges, n, pairs, verts, sets, panel, packed_panel,
                byte_deg):
    """Phase 5b: the main path on the packed layout, launch counters zeroed
    just before; then its answers against the byte kernels on the clamped
    panel, and the registers the clamp changed. ``panel`` and
    ``packed_panel`` are the byte panel and its packed image on the host,
    ``byte_deg`` the byte engine's degrees. Returns (engine, launch
    counts)."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig, rel_std
    from repro_torch.kernels import _build, packing

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    times = {}

    def step(name, fn):
        out, times[name] = timed(torch, fn)
        return out

    eng = step("build", lambda: engine.build(
        edges, n, HLLConfig(p=P), layout="packed", device=DEVICE))
    launch_check("packed", "hll_accumulate_packed", _build.launch_counts(),
                 0, -(-len(edges) // eng.INGEST_BLOCK), "build")
    deg = step("degrees", eng.degrees)
    before = _build.launch_counts()
    loc, glob = step("neighborhood", lambda: eng.neighborhood(T_MAX))
    launch_check("packed", "hll_propagate_packed", _build.launch_counts(),
                 before, T_MAX - 1, f"neighborhood({T_MAX})")
    est = step("intersection_size",
               lambda: eng.intersection_size(pairs, method="mle"))
    uni = step("union_size", lambda: eng.union_size(sets))
    batch = step("query_batch", lambda: eng.query_batch(
        degrees=True, vertex_sets=sets, pairs=pairs, method="mle"))
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = len(edges) / times["build"] / 1e6
    steps = ", ".join(f"{name} {secs:.3f} s" for name, secs in times.items())
    log(f"packed: {steps} (build {rate:.2f} M edges/s, neighborhood "
        f"t_max={T_MAX}); max_memory_allocated {peak:.2f} GiB; global sizes "
        f"{glob.tolist()}; launches {counts}")
    if not (eng.layout == "packed" and eng.regs.shape[1] == (1 << P) // 2
            and torch.equal(eng.regs.cpu(), packed_panel)):
        fail("packed: the packed build differs from pack_rows of the byte "
             "panel")
    if not (np.isfinite(deg).all() and np.isfinite(loc).all()
            and np.isfinite(est).all() and np.isfinite(uni).all()):
        fail("packed: answers are not finite")
    if not np.array_equal(loc[0], deg) or not np.all(np.diff(glob) > 0):
        fail("packed: hop 1 must equal degrees and sizes must grow")
    if not np.allclose(uni, loc[1][verts], rtol=1e-5, atol=0):
        fail("packed: union_size({v} u N(v)) differs from hop 2")
    if not (np.array_equal(batch["degrees"], deg)
            and np.array_equal(batch["union"], uni)
            and np.array_equal(batch["intersection"], est)):
        fail("packed: query_batch differs from the per-kind answers")
    exact = np.bincount(edges.ravel(), minlength=n).astype(np.float64)
    has = exact > 0
    mre = float(np.mean(np.abs(deg[has] - exact[has]) / exact[has]))
    if mre >= 3 * rel_std(P):
        fail(f"packed: degree error {mre:.4f} >= 3 x 1.04/sqrt(r)")
    missing = [k + "_packed" for k in (
        "hll_accumulate", "hll_estimate_stats", "hll_propagate",
        "intersection_stats", "union_estimate_stats")
        if counts[k + "_packed"] == 0]
    if missing:
        fail(f"packed: main-path kernels never launched: {missing}")

    # the byte kernels on the clamped panel give the same answers, and
    # pack_rows commutes with every propagate pass
    clamped = engine.LocalEngine.from_regs(
        packing.unpack_rows(eng.regs), n, HLLConfig(p=P), edges=edges,
        device=DEVICE)
    c_loc, _ = clamped.neighborhood(T_MAX)
    same = {"degrees": np.array_equal(clamped.degrees(), deg),
            "neighborhood": np.array_equal(c_loc, loc),
            "intersection_size": np.array_equal(
                clamped.intersection_size(pairs, method="mle"), est),
            "union_size": np.array_equal(clamped.union_size(sets), uni)}
    commute = all(torch.equal(packing.pack_rows(b), a) for a, b in zip(
        eng._panel_set.panels, clamped._panel_set.panels))
    del clamped
    if not all(same.values()) or not commute:
        fail(f"packed: answers differ from the byte kernels on the clamped "
             f"panel ({same}, panels commute: {commute})")
    saturated = int((panel > packing.SATURATION).sum())
    rows_sat = int((panel > packing.SATURATION).any(dim=1).sum())
    differ = int((deg != byte_deg).sum())
    log(f"packed: registers equal pack_rows of the byte panel; degrees, "
        f"neighborhood({T_MAX}), intersection_size and union_size equal the "
        f"byte kernels' on the clamped panel bit for bit; pack_rows commutes "
        f"with the {len(eng._panel_set.panels) - 1} propagate passes; "
        f"{saturated} of {panel.numel()} byte registers exceed 15 "
        f"({rows_sat} rows); degrees of {differ} of {n} rows differ from "
        f"the byte engine's; degree mean relative error {mre:.4f}")
    return eng, counts


def packed_durability(torch, np, edges, n, eng):
    """Phase 5c: save and load the packed scale-22 engine, load it as
    byte (exact unpack), and merge even/odd half builds. Returns the
    launch counts, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build, packing

    _build.reset_launch_counts()
    path = ROOT / "build" / "chip_smoke_packed_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        step, t_save = timed(torch, lambda: eng.save(str(path)))
        written = sum(f.stat().st_size for f in Path(step).iterdir())
        back, t_load = timed(torch, lambda: engine.load(str(path),
                                                        device=DEVICE))
        if not (back.layout == "packed" and torch.equal(back.regs, eng.regs)
                and back.m == eng.m):
            fail("packed checkpoint: the loaded engine differs")
        del back
        as_byte, t_cross = timed(torch, lambda: engine.load(
            str(path), layout="byte", device=DEVICE))
        if not (as_byte.layout == "byte" and torch.equal(
                as_byte.regs, packing.unpack_rows(eng.regs))):
            fail("packed checkpoint: load(layout='byte') is not the exact "
                 "unpack")
        del as_byte
    finally:
        shutil.rmtree(path, ignore_errors=True)
    (left, right), t_build = timed(torch, lambda: tuple(
        engine.build(edges[i::2], n, HLLConfig(p=P), layout="packed",
                     device=DEVICE) for i in (0, 1)))
    _, t_merge = timed(torch, lambda: left.merge(right))
    if not torch.equal(left.regs, eng.regs) or left.m != len(edges):
        fail("packed merge: the merged halves differ from the one-shot build")
    counts = _build.launch_counts()
    log(f"packed: save {t_save:.3f} s ({written / 2**20:.1f} MiB written), "
        f"load {t_load:.3f} s, load(layout='byte') {t_cross:.3f} s, both "
        f"bit for bit; two half builds {t_build:.3f} s, merge "
        f"{t_merge:.4f} s, equal to the one-shot build; launches {counts}")
    return counts


def timed(torch, fn):
    """(result, seconds) of ``fn`` on the host clock, ending in a sync."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exact_balls(torch, np, edges, n, sources, t_max):
    """int64[t_max, len(sources)]: |{y : d(s, y) <= t}| counting s itself,
    by a multi-source BFS on the card (a float reach panel [n, sources]
    grown by ``index_add_`` over the directed edges, one hop a step)."""
    dev = torch.device(DEVICE)
    src = torch.from_numpy(np.concatenate([edges[:, 0], edges[:, 1]])).to(
        dev, torch.int64)
    dst = torch.from_numpy(np.concatenate([edges[:, 1], edges[:, 0]])).to(
        dev, torch.int64)
    k = len(sources)
    reach = torch.zeros((n, k), dtype=torch.float32, device=dev)
    reach[torch.from_numpy(sources).to(dev), torch.arange(k, device=dev)] = 1
    sizes = []
    chunk = 1 << 24
    for _ in range(t_max):
        grown = reach.clone()
        for s0 in range(0, src.numel(), chunk):
            grown.index_add_(0, dst[s0:s0 + chunk], reach[src[s0:s0 + chunk]])
        reach = (grown > 0).to(torch.float32)
        sizes.append(reach.sum(dim=0))
    return torch.stack(sizes).to(torch.int64).cpu().numpy()


def ads_path(torch, np, edges, n):
    """Phase 6: the ADS family's distance queries at RMAT scale SCALE.

    Returns (engine, launch counts, distance histogram)."""
    from repro_torch import engine
    from repro_torch.core import ads
    from repro_torch.core.ads import ADSConfig
    from repro_torch.kernels import _build

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    eng, t_build = timed(torch, lambda: engine.build(
        edges, n, ADSConfig(p=P), family="ads", device=DEVICE))
    (hist, glob), t_hist = timed(torch,
                                 lambda: eng.distance_histogram(ADS_T))
    hist_counts = _build.launch_counts()
    close, t_close = timed(torch, lambda: eng.closeness(ADS_T))
    eff, t_eff = timed(torch, lambda: eng.effective_diameter(ADS_T, q=0.9))
    counts = _build.launch_counts()
    log(f"ads: build {t_build:.3f} s ({len(edges) / t_build / 1e6:.2f} M "
        f"edges/s); distance_histogram({ADS_T}) {t_hist:.3f} s, "
        f"closeness({ADS_T}) {t_close:.4f} s, effective_diameter({ADS_T}, "
        f"0.9) {t_eff:.4f} s = {eff:.4f}; global histogram "
        f"{glob.tolist()}; launches {counts}")
    if hist.shape != (ADS_T, n) or not np.isfinite(hist).all():
        fail("ads: histograms are not finite or have the wrong shape")
    if not ((hist >= 0).all() and np.array_equal(glob, hist.sum(axis=1))):
        fail("ads: histograms are negative or do not sum to glob")
    passes = eng.propagate_passes
    deg = eng.degrees()
    if not np.array_equal(hist[0], deg.astype(np.float64)):
        fail("ads: C^1 differs from degrees() of the same engine")
    curve = eng._hip_curve(ADS_T)  # the cached rows: no kernel runs
    if not (0.0 <= eff <= ADS_T and eff == ads.effective_diameter_from_curve(
            curve.sum(axis=1), 0.9)):
        fail(f"ads: effective diameter {eff} is outside [0, {ADS_T}] or "
             f"differs from the curve's")
    if not (np.isfinite(close).all() and close.shape == (n,)):
        fail("ads: closeness is not finite or has the wrong shape")
    before = _build.launch_counts()
    again, _ = eng.distance_histogram(ADS_T)
    eng.closeness(ADS_T)
    eng.effective_diameter(ADS_T, q=0.9)
    if (_build.launch_counts() != before or eng.propagate_passes != passes
            or not np.array_equal(again, hist)):
        fail("ads: repeat queries ran kernels or changed their answers")
    if hist_counts["hip_delta_rows"] != ADS_T - 1:
        fail(f"ads: hip_delta_rows launched {hist_counts['hip_delta_rows']}"
             f" times for distance_histogram({ADS_T}), not {ADS_T - 1}")
    missing = [k for k in ("hip_delta_rows", "hll_estimate_stats",
                           "hll_propagate", "hll_accumulate")
               if counts[k] == 0]
    if missing:
        fail(f"ads: kernels never launched: {missing}")
    log(f"ads: repeats of all three queries: 0 launches, 0 propagate "
        f"passes; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    deg_exact = np.bincount(edges.ravel(), minlength=n)
    rng = np.random.default_rng(SEED + 5)
    sources = rng.choice(np.flatnonzero(deg_exact >= 1), ADS_SOURCES,
                         replace=False)
    balls, t_bfs = timed(torch, lambda: exact_balls(
        torch, np, edges, n, sources, ADS_T))
    # Algorithm 2's target: y != s within t hops, plus s itself from t = 2
    truth = balls - 1 + (np.arange(1, ADS_T + 1) >= 2)[:, None]
    est = curve[:, sources]
    mre = float(np.mean(np.abs(est - truth) / truth))
    per_hop = np.mean(np.abs(est - truth) / truth, axis=1)
    log(f"ads: accuracy against exact balls of {ADS_SOURCES} sources "
        f"(BFS {t_bfs:.2f} s): per-vertex mean relative error {mre:.4f} "
        f"(limit {3 * ads.rel_std(P):.4f}), per hop "
        f"{np.round(per_hop, 4).tolist()}, mean exact ball "
        f"{np.round(truth.mean(axis=1), 1).tolist()}")
    if not mre < 3 * ads.rel_std(P):
        fail(f"ads: per-vertex error {mre:.4f} >= 3 x rel_std(p)")
    return eng, counts, hist


def merge_phase(torch, np, edges, n, ads_eng):
    """Phase 7: two half-graph engines merged equal the one-shot panel."""
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    (left, right), t_build = timed(torch, lambda: tuple(
        engine.build(edges[i::2], n, ADSConfig(p=P), device=DEVICE)
        for i in (0, 1)))
    _, t_merge = timed(torch, lambda: left.merge(right))
    counts = _build.launch_counts()
    if not torch.equal(left.regs, ads_eng.regs) or left.m != len(edges):
        fail("merge: the merged halves differ from the one-shot build")
    log(f"merge: two half builds {t_build:.3f} s, merge {t_merge:.4f} s; "
        f"registers equal the one-shot build bit for bit; launches {counts}")
    return counts


def checkpoint_phase(torch, np, n, ads_eng, hist):
    """Phase 8: save, load, repeat and resume the scale-22 ADS engine."""
    from repro_torch import engine
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    path = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        step, t_save = timed(torch, lambda: ads_eng.save(str(path)))
        written = sum(f.stat().st_size for f in Path(step).iterdir())
        back, t_load = timed(torch, lambda: engine.load(str(path),
                                                        device=DEVICE))
        if not (torch.equal(back.regs, ads_eng.regs) and back.m == ads_eng.m
                and back.family.name == "ads"):
            fail("checkpoint: the loaded engine differs from the saved one")
        (again, _), t_hist = timed(torch,
                                   lambda: back.distance_histogram(ADS_T))
        if not np.array_equal(again, hist):
            fail("checkpoint: distance_histogram differs after load")
        block = np.random.default_rng(SEED + 7).integers(0, n, (1 << 20, 2))
        back.ingest(block)
        ads_eng.ingest(block)
        if not torch.equal(back.regs, ads_eng.regs) or back.m != ads_eng.m:
            fail("checkpoint: ingest after load does not resume")
        counts = _build.launch_counts()
        log(f"checkpoint: save {t_save:.3f} s ({written / 2**20:.1f} MiB "
            f"written), load {t_load:.3f} s, registers equal; "
            f"distance_histogram({ADS_T}) after load {t_hist:.3f} s, bit for "
            f"bit; 2^20 further edges into both: registers equal; launches "
            f"{counts}")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts


def triangle_path(torch, np):
    """Phase 9: triangle heavy hitters at RMAT scale TRI_SCALE."""
    from repro_torch import engine
    from repro_torch.core import degreesketch
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    edges = generators.rmat(TRI_SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << TRI_SCALE
    log(f"triangles: graph rmat scale {TRI_SCALE} edge factor {EDGE_FACTOR} "
        f"seed {SEED}: n={n}, m={len(edges)}, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    total, vals, top = eng.triangle_heavy_hitters(TRI_K, mode="edge")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    log(f"triangles: build {t_build:.3f} s; triangle_heavy_hitters(k={TRI_K},"
        f" edge): {secs:.3f} s ({len(edges) / secs / 1e6:.3f} M edges/s), "
        f"edge block {degreesketch.EDGE_BLOCK}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
        f"{counts}, total {total:.1f}, top values {vals[:3].tolist()}")
    if not (np.isfinite(vals).all() and len(vals) == TRI_K
            and np.all(np.diff(vals) <= 0)):
        fail("triangle heavy hitters are not finite and descending")
    keys = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    if not np.isin(top[:, 0].astype(np.int64) * n + top[:, 1], keys).all():
        fail("triangle heavy hitters returned a pair that is not an edge")
    if not total > 0:
        fail(f"triangle total {total} is not positive")
    if counts["ertl_stats"] == 0 or counts["hll_estimate_stats"] == 0:
        fail(f"the triangle path skipped its kernels: {counts}")
    sample = np.random.default_rng(SEED).choice(len(edges), N_PAIRS,
                                                replace=False)
    overflow_share(torch, eng, edges[sample], "triangles", iters=30)
    return counts


def overflow_share(torch, eng, pairs, label="main: intersection_size",
                   iters=None):
    """Share of ``pairs`` whose Newton step the reference's Hessian-overflow
    flag rejects (kept for parity with the JAX package)."""
    from repro_torch.core import intersection
    ids = torch.as_tensor(pairs).to(eng.device, torch.int32)
    stats, sz = eng.kernels.intersection_stats(eng.regs, ids, eng.cfg)
    start, end = intersection.hessian_overflow_share(
        stats, sz, eng.cfg, iters or intersection.NEWTON_ITERS)
    log(f"{label}: Hessian-overflow flag on {start:.4f} of "
        f"{len(pairs)} pairs at the initializer, {end:.4f} at the final "
        f"iterate")


def small_reference(torch, np):
    """Phase 10: CPU (plain versions) and card agree at RMAT scale 10, in
    both layouts. Returns the launch counts of the packed card run."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators

    tiny = torch.maximum(torch.zeros(1, device=DEVICE),
                         torch.full((1,), 1e-38, device=DEVICE))
    if not bool(tiny[0] > 0):
        fail("the 1e-38 likelihood floor flushes to zero on the card")
    edges = generators.rmat(10, 8, seed=3)
    n = 1 << 10
    cpu = engine.build(edges, n, HLLConfig(p=P), device="cpu")
    gpu = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    if not torch.equal(cpu.regs, gpu.regs.cpu()):
        fail("small reference: registers differ between CPU and card")
    checks = {"degrees": (cpu.degrees(), gpu.degrees(), 1e-5),
              "neighborhood": (cpu.neighborhood(T_MAX)[0],
                               gpu.neighborhood(T_MAX)[0], 1e-5)}
    sample = edges[np.random.default_rng(3).choice(len(edges), 256,
                                                   replace=False)]
    deg = cpu.degrees()
    # |A u B| <= |A| + |B|: the terms of the difference, as in the tests
    scale = 2 * (deg[sample[:, 0]] + deg[sample[:, 1]])
    for method, rtol in (("ie", 1e-5), ("mle", 1e-4)):
        a = cpu.intersection_size(sample, method=method, iters=10)
        b = gpu.intersection_size(sample, method=method, iters=10)
        if not np.all(np.abs(a - b) <= rtol * (np.abs(a) + scale)):
            fail(f"small reference: intersection {method} differs")
    rng = np.random.default_rng(4)
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(100)]
    checks["union_size"] = (cpu.union_size(sets), gpu.union_size(sets), 1e-5)
    for name, (a, b, rtol) in checks.items():
        if not np.allclose(a, b, rtol=rtol, atol=0):
            fail(f"small reference: {name} differs between CPU and card")
    batch = gpu.query_batch(degrees=True, vertex_sets=sets, pairs=sample,
                            iters=10)
    if not (np.array_equal(batch["degrees"], gpu.degrees())
            and np.array_equal(batch["union"], gpu.union_size(sets))
            and np.array_equal(batch["intersection"], gpu.intersection_size(
                sample, iters=10))):
        fail("small reference: query_batch differs from per-kind answers")
    small_triangles(np, cpu, gpu, edges, n)
    small_ads(torch, np, edges, n)
    log("small reference: rmat10 p=8 CPU plain vs card kernels: registers "
        "identical, degrees/neighborhood/union rtol 1e-5, intersection ie "
        "1e-5 / mle 1e-4, query_batch bit for bit, triangles 1e-4 of the "
        "estimates' scale")
    return small_packed(torch, np, edges, n, sample, sets)


def small_packed(torch, np, edges, n, sample, sets):
    """The packed engine at RMAT scale 10 on the card, launch counters
    zeroed just before (its triangles are the engine path of
    ``ertl_stats_packed``), against the CPU's plain versions (the
    tolerances of the byte checks) and against the byte kernels on the
    clamped panel (bit for bit). Returns the launch counts."""
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import _build, packing

    cfg = HLLConfig(p=P)

    def answers(eng):
        return {"degrees": eng.degrees(),
                "neighborhood": eng.neighborhood(T_MAX)[0],
                "union_size": eng.union_size(sets),
                "ie": eng.intersection_size(sample, method="ie", iters=10),
                "mle": eng.intersection_size(sample, method="mle", iters=10),
                "edge": eng.triangle_heavy_hitters(20, mode="edge"),
                "vertex": eng.triangle_heavy_hitters(20, mode="vertex")}

    _build.reset_launch_counts()
    gpu = engine.build(edges, n, cfg, layout="packed", device=DEVICE)
    got = answers(gpu)
    batch = gpu.query_batch(degrees=True, vertex_sets=sets, pairs=sample,
                            iters=10)
    counts = _build.launch_counts()
    missing = [k for k, c in counts.items()
               if k.endswith("_packed") and c == 0]
    if missing:
        fail(f"small reference: packed kernels never launched: {missing}")
    if not (np.array_equal(batch["degrees"], got["degrees"])
            and np.array_equal(batch["union"], got["union_size"])
            and np.array_equal(batch["intersection"], got["mle"])):
        fail("small reference: packed query_batch differs from per-kind "
             "answers")
    cpu = engine.build(edges, n, cfg, layout="packed", device="cpu")
    if not torch.equal(cpu.regs, gpu.regs.cpu()):
        fail("small reference: packed registers differ between CPU and card")
    want = answers(cpu)
    for name in ("degrees", "neighborhood", "union_size"):
        if not np.allclose(got[name], want[name], rtol=1e-5, atol=0):
            fail(f"small reference: packed {name} differs between CPU and "
                 f"card")
    deg = want["degrees"]
    scale = 2 * (deg[sample[:, 0]] + deg[sample[:, 1]])
    for method, rtol in (("ie", 1e-5), ("mle", 1e-4)):
        if not np.all(np.abs(got[method] - want[method])
                      <= rtol * (np.abs(want[method]) + scale)):
            fail(f"small reference: packed intersection {method} differs")
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cfg, layout="packed"), edges)
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        (g_tot, g_vals, _), (c_tot, c_vals, _) = got[mode], want[mode]
        if not (abs(g_tot - c_tot) <= tol.sum() / 3
                and np.allclose(g_vals, c_vals, rtol=0, atol=atol)):
            fail(f"small reference: packed {mode} triangles differ")
    clamped = answers(engine.LocalEngine.from_regs(
        packing.unpack_rows(gpu.regs), n, cfg, edges=edges, device=DEVICE))
    def same(a, b):  # triangle answers are (total, values, ids) tuples
        if isinstance(a, tuple):
            return all(np.array_equal(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    differ = [name for name in got if not same(got[name], clamped[name])]
    if differ:
        fail(f"small reference: packed answers differ from the byte kernels "
             f"on the clamped panel: {differ}")
    log(f"small reference: packed rmat10 p={P}: registers identical CPU vs "
        f"card; degrees/neighborhood/union rtol 1e-5, intersection ie 1e-5 "
        f"/ mle 1e-4, triangles (edge, vertex) 1e-4 of the estimates' scale;"
        f" card answers equal the byte kernels' on the clamped panel bit for"
        f" bit; launches {counts}")
    return counts


def small_ads(torch, np, edges, n):
    """The ADS curve from the CPU's plain versions and from the card
    (``rtol=1e-6``), both against exact ball sizes with the tolerances of
    ``tests/test_ads.py``."""
    from repro_torch import engine
    from repro_torch.core import ads
    from repro_torch.core.ads import ADSConfig
    from repro_torch.graph import exact

    cpu = engine.build(edges, n, ADSConfig(p=P), device="cpu")
    gpu = engine.build(edges, n, ADSConfig(p=P), device=DEVICE)
    curves = {"cpu": cpu._hip_curve(ADS_T), "card": gpu._hip_curve(ADS_T)}
    if not np.allclose(curves["card"], curves["cpu"], rtol=1e-6, atol=0):
        fail("small reference: the ADS curve differs between CPU and card")
    truth = exact.neighborhood_truth(n, edges, ADS_T)
    truth_glob = truth.sum(axis=1).astype(np.float64)
    eff_exact = ads.effective_diameter_from_curve(truth_glob, 0.9)
    tol = ads.rel_std(P)
    mask = truth > 0
    for name, curve in curves.items():
        glob = curve.sum(axis=1)
        g_mre = float(np.mean(np.abs(glob - truth_glob)
                              / np.maximum(truth_glob, 1.0)))
        v_mre = float(np.mean(np.abs(curve[mask] - truth[mask])
                              / truth[mask]))
        eff = ads.effective_diameter_from_curve(glob, 0.9)
        log(f"small reference: ads {name}: global MRE {g_mre:.4f} (< "
            f"{2 * tol:.4f}), per-vertex {v_mre:.4f} (< {3 * tol:.4f}), "
            f"effective diameter {eff:.4f} vs exact {eff_exact:.4f}")
        if not (g_mre < 2 * tol and v_mre < 3 * tol
                and abs(eff - eff_exact) < 0.5):
            fail(f"small reference: the {name} ADS curve misses the exact "
                 f"ball sizes")


def small_triangles(np, cpu, gpu, edges, n):
    """Both triangle modes, CPU against card (1e-4 of each edge's
    estimates' scale, summed as the query sums them), and the top-20
    recall against exact counts (reported, not gated)."""
    from repro_torch.core import degreesketch as dsk
    from repro_torch.graph import exact

    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cpu.cfg), edges)
    deg = cpu.degrees()
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    truth = exact.exact_edge_triangles(n, edges)
    want_ids = {"edge": edges, "vertex": np.arange(n)}
    want_top = {"edge": truth, "vertex": exact.exact_vertex_triangles(
        n, edges, truth)}
    recall = {}
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        c_tot, c_vals, _ = cpu.triangle_heavy_hitters(20, mode=mode)
        g_tot, g_vals, g_ids = gpu.triangle_heavy_hitters(20, mode=mode)
        if not (abs(c_tot - g_tot) <= tol.sum() / 3
                and np.allclose(g_vals, c_vals, rtol=0, atol=atol)):
            fail(f"small reference: {mode} triangles differ")
        exact_top = want_ids[mode][np.argsort(-want_top[mode])[:20]]
        hits = {tuple(np.atleast_1d(x)) for x in g_ids} & {
            tuple(np.atleast_1d(x)) for x in exact_top}
        recall[mode] = len(hits) / 20
    log(f"small reference: triangles: estimated total {g_tot:.1f}, exact "
        f"{exact.exact_global_triangles(n, edges, truth)}; top-20 recall "
        f"against exact counts: edges {recall['edge']:.2f}, vertices "
        f"{recall['vertex']:.2f} (reported, not gated)")


# ------------------------------------------------------------------ serving
def run_threads(fn, count, timeout=SERVE_WAIT):
    """Run ``fn(i)`` on ``count`` threads; fail on an error or a thread
    still running after ``timeout`` seconds."""
    import threading
    errors = []

    def body(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive():
            fail(f"a serving thread ran past {timeout} s")
    if errors:
        fail(f"a serving thread failed: {errors[0]!r}")


def serving_requests(np, rng, edges, sets, clients, per_client):
    """Seeded client requests: per client a list of (kind, argument),
    1/8 degrees, 3/8 unions of SERVE_SETS sets from ``sets``, 3/8
    intersections of SERVE_PAIRS edge pairs, 1/8 neighborhood(T_MAX)."""
    mix = ["degrees"] + ["union"] * 3 + ["intersection"] * 3 + [
        "neighborhood"]
    out = []
    for _ in range(clients):
        reqs = []
        for _ in range(per_client):
            kind = mix[int(rng.integers(len(mix)))]
            arg = None
            if kind == "union":
                arg = [sets[i] for i in rng.integers(0, len(sets),
                                                     SERVE_SETS)]
            elif kind == "intersection":
                arg = edges[rng.integers(0, len(edges), SERVE_PAIRS)]
            reqs.append((kind, arg))
        out.append(reqs)
    return out


def ask(srv, kind, arg):
    """One client call of ``kind`` through a server (or an engine)."""
    if kind == "degrees":
        return srv.degrees()
    if kind == "union":
        return srv.union_size(arg)
    if kind == "intersection":
        return srv.intersection_size(arg)
    return srv.neighborhood(T_MAX)


def direct_answers(np, eng, reqs):
    """The direct engine answers to ``reqs`` (a flat list of (kind, arg)),
    unions and intersections each as one batched call, sliced back."""
    sets = [s for kind, arg in reqs if kind == "union" for s in arg]
    pairs = [arg for kind, arg in reqs if kind == "intersection"]
    uni = eng.union_size(sets) if sets else None
    inter = eng.intersection_size(np.concatenate(pairs)) if pairs else None
    deg = eng.degrees()
    hood = eng.neighborhood(T_MAX) if any(
        kind == "neighborhood" for kind, _ in reqs) else None
    out, u, i = [], 0, 0
    for kind, arg in reqs:
        if kind == "degrees":
            out.append(deg)
        elif kind == "union":
            out.append(uni[u:u + len(arg)])
            u += len(arg)
        elif kind == "intersection":
            out.append(inter[i:i + len(arg)])
            i += len(arg)
        else:
            out.append(hood)
    return out


def same_answer(np, got, want):
    if isinstance(want, tuple):
        return all(np.array_equal(g, w) for g, w in zip(got, want))
    return np.array_equal(got, want)


def kind_stats(stats):
    """``kind: n, p50/p99 ms`` for every kind a server's stats hold."""
    return "; ".join(
        f"{kind} {s['requests']} requests in {s['batches']} batches, p50 "
        f"{s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms"
        for kind, s in stats.items()
        if isinstance(s, dict) and "p50_ms" in s and s["requests"])


def query_server_phase(torch, np, edges, n, sets):
    """Serving 1: a QueryServer over a byte engine at RMAT scale SCALE,
    SERVE_CLIENTS client threads x SERVE_REQS seeded requests, an ingest
    of SERVE_INGEST new edges as the epoch barrier half way; every answer
    equal, bit for bit, to the direct call at its epoch. Returns the
    serving run's launch counts, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    rng = np.random.default_rng(SEED + 11)
    work = serving_requests(np, rng, edges, sets, SERVE_CLIENTS, SERVE_REQS)
    half = SERVE_REQS // 2
    new = rng.integers(0, n, (SERVE_INGEST, 2))
    t0 = time.perf_counter()
    direct = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    want = [direct_answers(np, direct,
                           [r for reqs in work for r in reqs[:half]])]
    direct.ingest(new)
    want.append(direct_answers(np, direct,
                               [r for reqs in work for r in reqs[half:]]))
    del direct
    t_direct = time.perf_counter() - t0
    torch.cuda.empty_cache()
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = [[None] * SERVE_REQS for _ in range(SERVE_CLIENTS)]
    plans.reset_trace_counts()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with QueryServer(eng) as srv:
        def clients(lo, hi):
            def client(c):
                for j in range(lo, hi):
                    got[c][j] = ask(srv, *work[c][j])
            run_threads(client, SERVE_CLIENTS)
        clients(0, half)
        epoch = srv.ingest(new)
        clients(half, SERVE_REQS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        stats = srv.stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flat = [[got[c][j] for c in range(SERVE_CLIENTS) for j in range(half)],
            [got[c][j] for c in range(SERVE_CLIENTS)
             for j in range(half, SERVE_REQS)]]
    bad = [(e, i) for e in (0, 1) for i, (g, w) in enumerate(
        zip(flat[e], want[e])) if not same_answer(np, g, w)]
    if epoch != 1 or bad:
        fail(f"serving: QueryServer answers differ from the direct calls "
             f"at their epoch: {len(bad)} of {SERVE_CLIENTS * SERVE_REQS} "
             f"(epoch {epoch})")
    log(f"serving: QueryServer, byte, rmat scale {SCALE}: {SERVE_CLIENTS} "
        f"clients x {SERVE_REQS} requests, an ingest of {SERVE_INGEST} "
        f"edges half way (epoch 0 -> 1): {secs:.2f} s "
        f"({stats['requests_total'] / secs:.1f} requests/s), every answer "
        f"equal to the direct call at its epoch bit for bit (direct calls "
        f"{t_direct:.2f} s); {kind_stats(stats)}; fused batches "
        f"{stats['fused_batches']}; plans built {stats['plan_traces']}; "
        f"max_memory_allocated {peak:.2f} GiB; launches {counts}")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "hll_propagate", "intersection_stats",
                           "union_estimate_stats") if counts[k] == 0]
    if missing:
        fail(f"serving: QueryServer never launched {missing}")
    return counts


def submit_continuous(srv, n, kind, arg):
    """Submit one degrees / union / intersection request to a
    ContinuousServer as its client methods do, and return the request:
    after ``wait()`` its ``epoch`` is the snapshot version that served
    it."""
    from repro_torch.engine import plans
    if kind == "degrees":
        payload = ()
    elif kind == "union":
        payload = plans.split_sets(arg, n)
    else:
        arr, scalar = plans.split_pairs(arg, n)
        payload = (arr, scalar, "mle", srv.engine._resolve_iters(None))
    return srv._submit(kind, payload, None)


def continuous_phase(torch, np, edges, n, sets, pairs):
    """Serving 2: a ContinuousServer over a byte engine at RMAT scale
    SCALE; the writer ingests CONT_BLOCKS blocks of CONT_BLOCK new edges
    (RotationPolicy(every_blocks=4), the source flushing every 4 blocks,
    so 4 rotations) while CONT_READERS reader threads
    serve degrees / unions / intersections. Every served answer equals
    the direct call at the snapshot version that served it; a snapshot
    taken before keeps its answers throughout; after flush the served
    registers equal a one-shot build; one lease clone a rotation. Returns
    the serving run's launch counts, zeroed just before, less the
    launches of the snapshot check made while the writer works."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import ContinuousServer, RotationPolicy
    import threading

    rng = np.random.default_rng(SEED + 12)
    new = rng.integers(0, n, (CONT_BLOCKS * CONT_BLOCK, 2))
    blocks = np.split(new, CONT_BLOCKS)
    eng = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    v0 = eng.version
    first = eng.snapshot()
    probe = (sets[:64], pairs[:1024])

    def answers(e):
        return (e.degrees(), e.union_size(probe[0]),
                e.intersection_size(probe[1]))

    _build.reset_launch_counts()
    want_first = answers(first)
    torch.cuda.synchronize()
    probe_counts = _build.launch_counts()  # subtracted for ``mid`` below
    torch.cuda.reset_peak_memory_stats()
    plans.reset_event_counts()
    _build.reset_launch_counts()
    stop = threading.Event()
    seen = [[] for _ in range(CONT_READERS)]  # (kind, arg, epoch, answer)
    t0 = time.perf_counter()
    with ContinuousServer(eng, rotation=RotationPolicy(every_blocks=4)) \
            as srv:
        def reader(i):
            r = np.random.default_rng(SEED + 100 + i)
            while not stop.is_set():
                kind = ("degrees", "union", "intersection")[i % 3]
                arg = None
                if kind == "union":
                    arg = [sets[k] for k in r.integers(0, len(sets),
                                                       SERVE_SETS)]
                elif kind == "intersection":
                    arg = edges[r.integers(0, len(edges), SERVE_PAIRS)]
                req = submit_continuous(srv, n, kind, arg)
                if not req.done.wait(timeout=SERVE_WAIT):
                    raise TimeoutError(f"{kind} not served in {SERVE_WAIT} s")
                seen[i].append((kind, arg, req.epoch, req.wait()))

        readers = threading.Thread(
            target=run_threads, args=(reader, CONT_READERS), daemon=True)
        readers.start()
        for g in range(0, CONT_BLOCKS, 4):  # a source that flushes every 4
            for blk in blocks[g:g + 4]:
                srv.ingest(blk)
            if g == 4:
                mid = answers(first)  # while the writer works
            srv.flush(timeout=SERVE_WAIT)
        secs = time.perf_counter() - t0
        stop.set()
        readers.join(timeout=SERVE_WAIT)
        if readers.is_alive():
            fail("serving: ContinuousServer readers did not stop")
        torch.cuda.synchronize()
        counts = {k: c - probe_counts.get(k, 0)
                  for k, c in _build.launch_counts().items()}
        stats = srv.stats()
        served_regs = srv._slot.get().regs
        writer = srv.engine
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    clones = plans.event_counts().get("lease_clone", 0)
    rotations = stats["snapshot"]["rotations"]
    clone_ms = cuda_ms(torch, lambda: writer.regs.clone(), 10)
    after = answers(first)
    # every reader answer against the direct call at its version: one
    # engine steps through the versions, ingesting the blocks as the
    # writer did, and answers each version's requests in one batch
    by_epoch = {}
    for got in seen:
        for kind, arg, epoch, answer in got:
            by_epoch.setdefault(epoch, []).append((kind, arg, answer))
    step = engine.build(edges, n, HLLConfig(p=P), device=DEVICE)
    wrong, applied = [], 0
    for epoch in sorted(by_epoch):
        if not v0 <= epoch <= v0 + CONT_BLOCKS:
            fail(f"serving: ContinuousServer served version {epoch}, "
                 f"outside [{v0}, {v0 + CONT_BLOCKS}]")
        for blk in blocks[applied:epoch - v0]:
            step.ingest(blk)
        applied = max(applied, epoch - v0)
        reqs = by_epoch[epoch]
        want = direct_answers(np, step, [(k, a) for k, a, _ in reqs])
        wrong += [(epoch, k) for (k, _, g), w in zip(reqs, want)
                  if not same_answer(np, g, w)]
    del step
    n_seen = sum(len(got) for got in seen)
    once = engine.build(np.concatenate([edges, new]), n, HLLConfig(p=P),
                        device=DEVICE)
    checks = {
        "every reader answer equal to the direct call at its version": (
            n_seen > 0 and not wrong),
        "snapshot answers during the stream": all(
            np.array_equal(a, b) for a, b in zip(mid, want_first)),
        "snapshot answers after the stream": all(
            np.array_equal(a, b) for a, b in zip(after, want_first)),
        "served registers equal a one-shot build": torch.equal(
            served_regs, once.regs),
        "one lease clone a rotation": clones == rotations >= 1,
        "the first snapshot's panel no longer shared": (
            first.regs.untyped_storage().data_ptr()
            != writer.regs.untyped_storage().data_ptr()),
    }
    del once
    log(f"serving: ContinuousServer, byte, rmat scale {SCALE}: "
        f"{CONT_BLOCKS} blocks of {CONT_BLOCK} edges in {secs:.2f} s while "
        f"{CONT_READERS} readers served {n_seen} requests at versions "
        f"{sorted(by_epoch)} ({len(wrong)} differ from the direct call); "
        f"rotations "
        f"{rotations}, lease clones {clones}, shed {stats['shed_total']}, "
        f"deadline misses {stats['deadline_misses']}; {kind_stats(stats)}; "
        f"lease clone of the {writer.regs.numel() / 2**30:.2f} GiB panel "
        f"{clone_ms:.4f} ms (CUDA events; bound "
        f"{bound_ms(2 * writer.regs.numel()):.4f} ms, bytes); "
        f"max_memory_allocated {peak:.2f} GiB; launches {counts}")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"serving: ContinuousServer: {bad}")
    log(f"serving: ContinuousServer: {', '.join(checks)}: all hold")
    missing = [k for k in ("hll_accumulate", "hll_estimate_stats",
                           "intersection_stats", "union_estimate_stats")
               if counts[k] == 0]
    if missing:
        fail(f"serving: ContinuousServer never launched {missing}")
    return counts


def packed_serving_phase(torch, np, eng, edges, sets):
    """Serving 3: a short QueryServer run (SERVE_CLIENTS x 8 requests) on
    the packed scale-SCALE engine, every answer equal to the direct call.
    Returns the serving run's launch counts, zeroed just before."""
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    work = serving_requests(np, np.random.default_rng(SEED + 13), edges,
                            sets, SERVE_CLIENTS, 8)
    want = direct_answers(np, eng, [r for reqs in work for r in reqs])
    got = [[None] * 8 for _ in range(SERVE_CLIENTS)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with QueryServer(eng) as srv:
        def client(c):
            for j in range(8):
                got[c][j] = ask(srv, *work[c][j])
        run_threads(client, SERVE_CLIENTS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _build.launch_counts()
        stats = srv.stats()
    flat = [g for row in got for g in row]
    bad = sum(not same_answer(np, g, w) for g, w in zip(flat, want))
    if bad:
        fail(f"serving: packed QueryServer: {bad} answers differ from the "
             f"direct calls")
    log(f"serving: QueryServer, packed: {SERVE_CLIENTS} clients x 8 "
        f"requests in {secs:.2f} s, every answer equal to the direct call "
        f"bit for bit; {kind_stats(stats)}; launches {counts}")
    missing = [k + "_packed" for k in ("hll_estimate_stats",
                                       "intersection_stats",
                                       "union_estimate_stats")
               if counts[k + "_packed"] == 0]
    if missing:
        fail(f"serving: packed QueryServer never launched {missing}")
    return counts


def ads_serving_phase(torch, np, ads_eng):
    """Serving 4: one served distance_histogram(ADS_T) on the scale-SCALE
    ADS engine (cold caches), equal to the direct call on a snapshot; its
    repeat served from a snapshot runs no kernel and no propagate pass.
    Returns the served call's launch counts, zeroed just before."""
    from repro_torch.engine import plans
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer

    view = ads_eng.snapshot()  # computes its own panels: the direct call
    want, want_glob = view.distance_histogram(ADS_T)
    del view
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    with QueryServer(ads_eng) as srv:
        (hist, glob), secs = timed(torch,
                                   lambda: srv.distance_histogram(ADS_T))
        counts = _build.launch_counts()
    snap = ads_eng.snapshot()
    plans.reset_event_counts()
    _build.reset_launch_counts()
    with QueryServer(snap) as srv:
        (again, again_glob), secs2 = timed(
            torch, lambda: srv.distance_histogram(ADS_T))
        repeat = (_build.launch_counts(), plans.event_counts())
    if not (np.array_equal(hist, want) and np.array_equal(glob, want_glob)
            and np.array_equal(again, want)
            and np.array_equal(again_glob, want_glob)):
        fail("serving: served distance_histogram differs from the direct "
             "call")
    if any(repeat[0].values()) or repeat[1].get("propagate_pass", 0):
        fail(f"serving: the repeat on a snapshot ran work: {repeat}")
    log(f"serving: ADS: served distance_histogram({ADS_T}) {secs:.3f} s "
        f"(cold), equal to the direct call bit for bit, launches {counts}; "
        f"repeated on a snapshot {secs2:.4f} s: 0 kernel launches, 0 "
        f"propagate passes")
    missing = [k for k in ("hip_delta_rows", "hll_propagate",
                           "hll_estimate_stats") if counts[k] == 0]
    if missing:
        fail(f"serving: served distance_histogram never launched {missing}")
    return counts


def failover_phase(torch, np):
    """Serving 5: the ContinuousServer's failover writer at RMAT scale
    FT_SCALE (its cost is host checkpoint I/O, not kernels): checkpoints
    every 4 blocks under build/, the writer killed at block 6, registers
    after flush equal the same run without faults; directory removed.
    Returns the launch counts of both runs, zeroed just before."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import _build
    from repro_torch.runtime.faults import FaultInjector, KillHost
    from repro_torch.runtime.ft import FTConfig
    from repro_torch.serve import ContinuousServer

    edges = generators.rmat(FT_SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << FT_SCALE
    blocks = np.array_split(edges, FT_BLOCKS)
    path = ROOT / "build" / "chip_smoke_ft"
    shutil.rmtree(path, ignore_errors=True)

    def run(ft, faults):
        with ContinuousServer(engine.open(n, HLLConfig(p=P), device=DEVICE),
                              ft=ft, faults=faults) as srv:
            for blk in blocks:
                srv.ingest(blk)
            srv.flush(timeout=SERVE_WAIT)
            out = (srv.engine.regs.clone(), srv.engine.m,
                   srv.stats()["runtime"])
        return out

    _build.reset_launch_counts()
    try:
        inj = FaultInjector(faults=(KillHost(host=0, at_block=6),))
        (regs, m, rt), secs = timed(torch, lambda: run(
            FTConfig(ckpt_dir=str(path), ckpt_every=4), inj))
        (want, want_m, _), secs0 = timed(torch, lambda: run(None, None))
    finally:
        shutil.rmtree(path, ignore_errors=True)
    counts = _build.launch_counts()
    if not (torch.equal(regs, want) and m == want_m == len(edges)
            and rt["recoveries"] == 1 and len(inj.fired) == 1):
        fail(f"serving: failover writer: registers or edge count differ "
             f"from the run without faults ({rt})")
    log(f"serving: failover writer, rmat scale {FT_SCALE} (cut from "
        f"{SCALE}: the phase's cost is host checkpoint I/O, not kernels): "
        f"{FT_BLOCKS} blocks, checkpoints every 4, writer killed at block "
        f"6: recoveries {rt['recoveries']}, last recovery "
        f"{rt['last_recovery_ms']:.1f} ms, checkpoints written "
        f"{rt['checkpoints_written']}; registers and m={m} equal the run "
        f"without faults bit for bit ({secs:.2f} s against {secs0:.2f} s); "
        f"directory removed; launches {counts}")
    if counts["hll_accumulate"] == 0:
        fail("serving: the failover writer never launched hll_accumulate")
    return counts


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    regs_used = [ln.strip() for ln in lib.with_suffix(".log").read_text()
                 .splitlines() if "registers" in ln] if lib.with_suffix(
                     ".log").exists() else []
    log(f"build: {time.perf_counter() - t0:.1f} s, {lib.name}; ptxas: "
        f"{' | '.join(regs_used)}")

    from repro_torch.graph import generators
    t0 = time.perf_counter()
    edges = generators.rmat(SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << SCALE
    rng = np.random.default_rng(SEED)
    pairs = edges[rng.choice(len(edges), N_PAIRS, replace=False)]
    verts, sets = neighbor_sets(np, edges, n, rng)
    log(f"graph: rmat scale {SCALE} edge factor {EDGE_FACTOR} seed {SEED}: "
        f"n={n}, m={len(edges)} undirected edges, {N_SETS} sets of "
        f"{min(map(len, sets))}-{max(map(len, sets))} ids, "
        f"{time.perf_counter() - t0:.1f} s on the host")

    rows = []

    def report(kname, err, ms, plain_ms, bnd, lib_ms, shape):
        rows.append({"name": kname, "route": "cuda",
                     "source": SOURCES[kname][0],
                     "replaces": SOURCES[kname][1], "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": "bytes",
                     "library_ms": lib_ms})
        log(f"kernel vs plain: {kname}: max abs err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms (bytes), library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}; {shape}")

    skew = neighbor_sets(np, edges, n, np.random.default_rng(SEED + 5),
                         max_degree=1023)[1]
    panel = compare_kernels(torch, np, edges, n, pairs, sets, skew, report)
    packed_panel = compare_packed_kernels(torch, np, edges, n, pairs, sets,
                                          skew, panel, report)
    del skew
    counts, byte_deg = main_path(torch, np, edges, n, pairs, verts, sets,
                                 panel)
    t_serve = time.perf_counter()
    phases = [counts, query_server_phase(torch, np, edges, n, sets),
              continuous_phase(torch, np, edges, n, sets, pairs)]
    t_serve = time.perf_counter() - t_serve
    torch.cuda.empty_cache()
    packed_eng, packed_counts = packed_path(
        torch, np, edges, n, pairs, verts, sets, panel, packed_panel,
        byte_deg)
    t0 = time.perf_counter()
    phases += [packed_counts,
               packed_serving_phase(torch, np, packed_eng, edges, sets)]
    t_serve += time.perf_counter() - t0
    phases.append(packed_durability(torch, np, edges, n, packed_eng))
    del panel, packed_panel, packed_eng
    ads_eng, ads_counts, hist = ads_path(torch, np, edges, n)
    phases += [ads_counts, merge_phase(torch, np, edges, n, ads_eng),
               checkpoint_phase(torch, np, n, ads_eng, hist)]
    t0 = time.perf_counter()
    phases += [ads_serving_phase(torch, np, ads_eng),
               failover_phase(torch, np)]
    t_serve += time.perf_counter() - t0
    log(f"serving: the five serving phases took {t_serve:.1f} s")
    del edges, ads_eng
    phases.append(triangle_path(torch, np))
    phases.append(small_reference(torch, np))
    for row in rows:
        row["launches"] = sum(c[row["name"]] for c in phases)
    idle = [row["name"] for row in rows if row["launches"] == 0]
    if idle:
        fail(f"kernels never launched on a counted path: {idle}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
