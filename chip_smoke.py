#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

Run from the repository root, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one line each:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the four CUDA kernels of ``src/repro_torch/csrc`` from source;
3. graph: RMAT scale 22, edge factor 16, seed 0 (4.19M vertices, about
   60M undirected edges, the Graph500 Kronecker parameters);
4. kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   the bound (bytes this run's data needs over 3.35 TB/s) and, for
   accumulate, the ``scatter_reduce_`` yardstick;
5. main path, with launch counters zeroed just before: ``engine.build``,
   ``degrees`` (mean relative error against exact degrees),
   ``neighborhood(3)`` and ``intersection_size`` on 16,384 edge pairs
   with the MLE; every kernel must have launched; then the share of
   those pairs that the reference's Hessian-overflow flag holds still;
6. small reference: the same path at RMAT scale 10 on the CPU (plain
   versions) and on the card, which must agree.

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
T_MAX = 3
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


def compare_kernels(torch, np, edges, n, pairs, report):
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.engine import plans
    from repro_torch.kernels import hll_accumulate, hll_estimate
    from repro_torch.kernels import hll_propagate, intersection_stats
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
    return regs_k.cpu()


def main_path(torch, np, edges, n, pairs, panel):
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
    counts = _build.launch_counts()
    log(f"kernels: {counts}")
    if min(counts.values()) == 0:
        fail(f"a main-path kernel never launched: {counts}")
    overflow_share(torch, eng, pairs)
    return counts


def overflow_share(torch, eng, pairs):
    """Share of the main path's pairs whose Newton step the reference's
    Hessian-overflow flag rejects (kept for parity with the JAX package)."""
    from repro_torch.core import intersection
    ids = torch.as_tensor(pairs).to(eng.device, torch.int32)
    stats, sz = eng.kernels.intersection_stats(eng.regs, ids, eng.cfg)
    start, end = intersection.hessian_overflow_share(stats, sz, eng.cfg)
    log(f"main: intersection_size: Hessian-overflow flag on {start:.4f} of "
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
    for name, (a, b, rtol) in checks.items():
        if not np.allclose(a, b, rtol=rtol, atol=0):
            fail(f"small reference: {name} differs between CPU and card")
    log("small reference: rmat10 p=8 CPU plain vs card kernels: registers "
        "identical, degrees/neighborhood rtol 1e-5, intersection ie 1e-5 / "
        "mle 1e-4")


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
    log(f"graph: rmat scale {SCALE} edge factor {EDGE_FACTOR} seed {SEED}: "
        f"n={n}, m={len(edges)} undirected edges, "
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

    panel = compare_kernels(torch, np, edges, n, pairs, report)
    counts = main_path(torch, np, edges, n, pairs, panel)
    small_reference(torch, np)
    for row in rows:
        row["launches"] = counts[row["name"]]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
