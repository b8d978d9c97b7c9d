#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the six CUDA kernels of ``src/repro_torch/csrc`` from source;
3. graph: RMAT scale 22, edge factor 16, seed 0 (4.19M vertices, about
   64M undirected edges, the Graph500 Kronecker parameters), and the
   4,096 union sets ``{v} ∪ N(v)`` of seeded random vertices of degree
   1-63;
4. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   the bound (bytes this run's data needs over 3.35 TB/s) and, for
   accumulate, the ``scatter_reduce_`` yardstick;
5. main path, with launch counters zeroed just before: ``engine.build``,
   ``degrees`` (mean relative error against exact degrees),
   ``neighborhood(3)``, ``intersection_size`` on 16,384 edge pairs with
   the MLE, ``union_size`` on the 4,096 sets (each must equal hop 2 of
   ``neighborhood(3)`` for its vertex) and ``query_batch`` over all three
   (bit for bit the per-kind answers); every kernel of the path must have
   launched; then the share of the pairs that the reference's
   Hessian-overflow flag holds still;
6. triangles, with launch counters zeroed just before: RMAT scale 20,
   edge factor 16, seed 0, ``engine.build`` and
   ``triangle_heavy_hitters(k=100, mode="edge")`` (finite values in
   descending order, real edges, a positive total, ``ertl_stats`` and
   ``hll_estimate_stats`` launched);
7. small reference: the same queries at RMAT scale 10 on the CPU (plain
   versions) and on the card, which must agree, and the top-20 recall of
   the estimated triangle heavy hitters against exact counts (reported).

Then the kernels JSON line, the card line, and the last line
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without that line; so does a run without a CUDA device or
outside the repository.
"""
from __future__ import annotations

import json
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


def neighbor_sets(np, edges, n, rng):
    """``{v} ∪ N(v)`` for N_SETS seeded random vertices of degree 1-63.

    One vectorised pass over the edge list: the directed entries whose
    source was chosen are sorted by the source's slot and split per set.
    Returns (vertices int64[N_SETS], list of int64 id arrays).
    """
    deg = np.bincount(edges.ravel(), minlength=n)
    verts = rng.choice(np.flatnonzero((deg >= 1) & (deg <= 63)), N_SETS,
                       replace=False)
    slot = np.full(n, -1, np.int64)
    slot[verts] = np.arange(N_SETS)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    keep = slot[src] >= 0
    order = np.argsort(slot[src[keep]], kind="stable")
    nbrs = dst[keep][order].astype(np.int64)
    parts = np.split(nbrs, np.cumsum(deg[verts])[:-1])
    return verts, [np.concatenate([[v], part]) for v, part in zip(verts, parts)]


def compare_kernels(torch, np, edges, n, pairs, sets, report):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.engine import plans
    from repro_torch.kernels import ertl_stats, hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
    from repro_torch.kernels import union_estimate
    from repro_torch.core.hashing import bucket_rho

    dev = torch.device(DEVICE)
    r, q = 1 << P, 64 - P
    n_pad = -(-n // 8) * 8
    directed = np.concatenate([edges, edges[:, ::-1]])
    rows = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    keys = torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev)
    live = torch.ones(rows.shape, dtype=torch.bool, device=dev)

    # accumulate: the whole graph through the kernel and the plain version
    regs_k = torch.zeros((n_pad, r), dtype=torch.uint8, device=dev)
    regs_p = torch.zeros_like(regs_k)
    hll_accumulate.hll_accumulate(regs_k, rows, keys, live, p=P, seed=0)
    hll_accumulate.plain(regs_p, rows, keys, live, p=P, seed=0)
    torch.cuda.synchronize()
    err = int((regs_k.to(torch.int16) - regs_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_accumulate differs from its plain version (max {err})")
    del regs_p
    # timing at the main path's block shape: 2 * INGEST_BLOCK directed edges
    blk = min(2 * 32768, len(directed) // 4)
    n_blk = min(16, len(directed) // blk)
    blocks = [slice(i * blk, (i + 1) * blk) for i in range(n_blk)]
    mask = torch.ones(blk, dtype=torch.bool, device=dev)
    fresh = [torch.zeros((n_pad, r), dtype=torch.uint8, device=dev)
             for _ in range(3)]
    it = iter(blocks * 3)

    def nxt(panel):
        sl = next(it)
        return panel, rows[sl], keys[sl]

    ms = cuda_ms(torch, lambda g, ro, ke: hll_accumulate.hll_accumulate(
        g, ro, ke, mask, p=P), n_blk, lambda: nxt(fresh[0]))
    plain_ms = cuda_ms(torch, lambda g, ro, ke: hll_accumulate.plain(
        g, ro, ke, mask, p=P), n_blk, lambda: nxt(fresh[1]))
    flat_idx = []
    for sl in blocks:
        b, rho = bucket_rho(keys[sl], P)
        flat_idx.append((rows[sl].to(torch.int64) * r + b, rho))
    it_lib = iter(flat_idx)
    lib_ms = cuda_ms(torch, lambda i, v: fresh[2].view(-1).scatter_reduce_(
        0, i, v, reduce="amax"), n_blk, lambda: next(it_lib))
    touched = torch.unique(flat_idx[0][0]).numel()
    report("hll_accumulate", err, ms, plain_ms,
           bound_ms(blk * 9 + 2 * touched), lib_ms,
           f"one block of {blk} directed edges, {touched} registers touched")
    del fresh, flat_idx

    # estimate: the built panel
    out_k = hll_estimate.hll_estimate_stats(regs_k)
    out_p = hll_estimate.plain(regs_k)
    torch.cuda.synchronize()
    if not torch.equal(out_k[:, 1], out_p[:, 1]) or not torch.allclose(
            out_k[:, 0], out_p[:, 0], rtol=1e-6, atol=0):
        fail("hll_estimate_stats differs from its plain version")
    err = float((out_k - out_p).abs().max())
    ms = cuda_ms(torch, lambda: hll_estimate.hll_estimate_stats(regs_k), 10)
    plain_ms = cuda_ms(torch, lambda: hll_estimate.plain(regs_k), 3)
    report("hll_estimate_stats", err, ms, plain_ms,
           bound_ms(n_pad * r + n_pad * 8), None, f"{n_pad} rows")

    # propagate: the whole directed routing, as the engine routes it
    src = torch.from_numpy(np.ascontiguousarray(directed[:, 0])).to(dev)
    dst = torch.from_numpy(np.ascontiguousarray(directed[:, 1])).to(dev)
    del rows, keys, live
    prop_k = hll_propagate.hll_propagate(regs_k, src, dst)
    prop_p = hll_propagate.plain(regs_k, src, dst)
    torch.cuda.synchronize()
    err = int((prop_k.to(torch.int16) - prop_p.to(torch.int16)).abs().max())
    if err != 0:
        fail(f"hll_propagate differs from its plain version (max {err})")
    del prop_k, prop_p
    ms = cuda_ms(torch, lambda: hll_propagate.hll_propagate(regs_k, src, dst),
                 3)
    plain_ms = cuda_ms(torch, lambda: hll_propagate.plain(regs_k, src, dst), 1)
    e_live = src.numel()
    report("hll_propagate", err, ms, plain_ms,
           bound_ms(2 * n_pad * r + 8 * e_live), None,
           f"{e_live} directed edges")
    del src, dst

    # intersection_stats: the main path's pairs
    ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st_k, sz_k = intersection_stats.intersection_stats(regs_k, pa, pb, q)
    st_p, sz_p = intersection_stats.plain(regs_k, pa, pb, q)
    torch.cuda.synchronize()
    if not (torch.equal(st_k, st_p) and torch.equal(sz_k[..., 1], sz_p[..., 1])
            and torch.allclose(sz_k[..., 0], sz_p[..., 0], rtol=1e-6, atol=0)):
        fail("intersection_stats differs from its plain version")
    err = max(float((st_k - st_p).abs().max()),
              float((sz_k - sz_p).abs().max()))
    ms = cuda_ms(torch, lambda: intersection_stats.intersection_stats(
        regs_k, pa, pb, q), 20)
    plain_ms = cuda_ms(torch, lambda: intersection_stats.plain(
        regs_k, pa, pb, q), 3)
    rows_read = torch.unique(ids).numel()
    b = ids.shape[0]
    report("intersection_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 8 * b + 4 * b * (5 * (q + 2) + 6)), None,
           f"{b} pairs, {rows_read} distinct rows")

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
    plain_ms = cuda_ms(torch, lambda: union_estimate.plain(regs_k, ids, mask),
                       3)
    rows_read = np.unique(ids_np[mask_np]).size
    report("union_estimate_stats", err, ms, plain_ms,
           bound_ms(rows_read * r + 5 * ids_np.size + 8 * ids_np.shape[0]),
           None, f"{ids_np.shape[0]} x {ids_np.shape[1]} set panel, "
                 f"{int(mask_np.sum())} members, {rows_read} distinct rows")

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

    (loc, glob), _ = step("neighborhood", lambda: eng.neighborhood(T_MAX),
                          lambda o: f", global sizes {o[1].tolist()}")
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
    missing = [k for k, c in counts.items() if c == 0 and k != "ertl_stats"]
    if missing:
        fail(f"main-path kernels never launched: {missing}")
    overflow_share(torch, eng, pairs)
    return counts


def triangle_path(torch, np):
    """Phase 6: triangle heavy hitters at RMAT scale TRI_SCALE."""
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
    """Phase 6: CPU (plain versions) and card agree at RMAT scale 10."""
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
    log("small reference: rmat10 p=8 CPU plain vs card kernels: registers "
        "identical, degrees/neighborhood/union rtol 1e-5, intersection ie "
        "1e-5 / mle 1e-4, query_batch bit for bit, triangles 1e-4 of the "
        "estimates' scale")


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

    panel = compare_kernels(torch, np, edges, n, pairs, sets, report)
    counts = main_path(torch, np, edges, n, pairs, verts, sets, panel)
    del edges, panel
    tri_counts = triangle_path(torch, np)
    small_reference(torch, np)
    for row in rows:
        row["launches"] = counts[row["name"]] + tri_counts[row["name"]]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
