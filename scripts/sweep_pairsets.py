#!/usr/bin/env python3
"""Time variants of the pair- and set-statistics kernels' design on one card.

    python3 scripts/sweep_pairsets.py EDGES_NPY [BASELINE_TREE]

Run it from a checkout's root. ``csrc/intersection_stats.cu`` and
``csrc/union_estimate.cu`` hold their design choices as constants; this
script compiles each source once per entry of its variant table (the
constants replaced in a copy under ``build/pairsets_sweep/``, one
``nvcc`` per copy, all started together, ``nvcc``'s register and spill
report kept beside each library; ``sweep_rowstats.build_variants``),
every launcher at its op's fallback block. The sets a block of the union
kernel and the most pairs a warp of the pair kernel are launch arguments
(``set_block`` and ``pair_block``, once the constants ``kWarps`` and
``kMaxPairsPerWarp``): their candidates are timed by
``kernels.autotune.sweep`` at every shape below
(``sweep_propagate.autotune_times``).
``BASELINE_TREE``, the root of another checkout (for example the parent
commit unpacked with ``git archive`` under ``build/``), adds that tree's
two sources as the variant ``baseline`` and that tree's two wrappers as
``baseline_wrapper``, beside this tree's wrappers as ``wrapper``.

Shapes, all at p=8 on the scale-22 graph (RMAT, edge factor 16, seed 0,
cached at ``EDGES_NPY`` by the first run, as ``scripts/time_main_path.py``
caches it), its panel built with ``HLLConfig(p=8)`` and that panel packed:

(a) the main path's: 16,384 edge pairs and 4,096 sets ``{v} ∪ N(v)`` of
    degree 1-63, drawn as ``chip_smoke.py`` draws them (4,096 x 64 panel);
(b) 2^18 edge pairs;
(c) 65,536 such sets;
(d) a skewed panel: 4,096 sets whose degrees follow the graph's own
    distribution up to 1,023 (4,096 x 1,024 panel).

Each variant's output must equal the plain version's (histograms, zero
counts and packed sums bit for bit, byte sums within ``rtol=1e-6``),
except the timing-only variants in ``TIMING_ONLY``. Times are CUDA-event
medians over ``REPS`` calls, taken in turns (every variant once per
round), each with the 50 MB L2 cache flushed before it, so rows come from
device memory as a query's do: ``launcher`` times the C launcher alone
(device time: the flush keeps the stream busy while it is enqueued);
``wrapper`` times the Python wrapper's call from an idle device (a
synchronize before it), so it includes the wrapper's host work; ``host``
is the host clock's median around the call alone (the launcher's ctypes
call and launch, or the whole wrapper), a CPU time. The
share of zero registers in the pairs' rows (from ``sz[:, :, 1]``), the
bytes bound of each shape (each input byte read once, each output byte
written once, over the H100's 3.35 TB/s, ``analysis.roofline.HW``) and the time per member row of the set
shapes are printed beside the times.

Prints the card's name and power limit, then one JSON line. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

from sweep_propagate import autotune_times
from sweep_rowstats import build_variants, call

REPS = 15
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
FLUSH_BYTES = 64 << 20     # more than the H100's 50 MB L2
#: source -> {variant: {constant: value}}; {} is the source as is
VARIANTS = {
    "intersection_stats.cu": {
        "as_is": {},
        "no_atomics": {"kHistAtomics": "false"},
        "min_blocks1": {"kMinBlocks": "1"},
        "loads2": {"kLoads": "2"},
        "threads128": {"kThreads": "128"},
    },
    "union_estimate.cu": {
        "as_is": {},
        "members2": {"kMembers": "2"},
        "members8": {"kMembers": "8"},
        "ahead1": {"kAhead": "1"},
        "shared": {"kOwnWindows": "0"},
        "owned": {"kOwnWindows": "1024"},
        "min_blocks8_members2": {"kMinBlocks": "8", "kMembers": "2"},
    },
}
#: variants that exist for timing only: their outputs are not checked
TIMING_ONLY = {"no_atomics"}
LAUNCHERS = {
    "intersection_stats.cu": ("intersection_stats",
                              "intersection_stats_packed"),
    "union_estimate.cu": ("union_estimate_stats",
                          "union_estimate_stats_packed"),
}


def baseline_wrappers(baseline: str):
    """(intersection_stats, union_estimate) wrapper modules of the tree at
    ``baseline``, imported apart from this tree's ``repro_torch``: this
    tree's modules are set aside while the baseline's load, then put
    back. The baseline's wrappers keep the modules they bound at import
    (its ``_build``, which builds its own ``csrc`` on first use)."""
    mine = {k: v for k, v in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, os.path.join(baseline, "src"))
    try:
        from repro_torch.kernels import intersection_stats, union_estimate
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules
                  if k == "repro_torch" or k.startswith("repro_torch.")]:
            del sys.modules[k]
        sys.modules.update(mine)
    return intersection_stats, union_estimate


def wrapper_host_steps(torch, regs, sets, dev, wrappers, reps: int = 300):
    """Host-clock medians (us) of each step of the union wrapper's call at
    shape (a), the steps that every wrapper of the port takes, and of each
    tree's whole wrapper (``wrappers``: name -> (pair, set) modules)."""
    from repro_torch.engine import plans
    from repro_torch.kernels import _build, autotune
    ids_np, mask_np = plans.pad_sets(sets)
    ids = torch.from_numpy(ids_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    lib = _build.library()
    out = torch.empty((ids.shape[0], 2), dtype=torch.float32, device=dev)
    args = (regs.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
            ids.shape[0], regs.shape[0], ids.shape[1], regs.shape[1],
            autotune.FALLBACK["union_estimate"]["set_block"],
            torch.cuda.current_stream().cuda_stream)

    def device_context():
        with torch.cuda.device(regs.device):
            pass
    steps = {
        "check_device": lambda: _build.check_device(regs, "regs"),
        "check_panel": lambda: _build.check_panel(regs, "byte"),
        "check_ids": lambda: _build.check_ids(ids[0], "ids", regs),
        "torch.empty": lambda: torch.empty((ids.shape[0], 2),
                                           dtype=torch.float32, device=dev),
        "stream_of": lambda: _build.stream_of(regs),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            regs.device).cuda_stream,
        "torch.cuda.device context": device_context,
        "torch.cuda.current_device": torch.cuda.current_device,
        "ctypes launcher call": lambda: lib.union_estimate_stats(*args),
        "_build.launch": lambda: _build.launch("union_estimate_stats",
                                               regs.device, *args),
    }
    for name, (_, sets_mod) in wrappers.items():
        steps[name] = (lambda m: lambda: m.union_estimate_stats(
            regs, ids, mask))(sets_mod)
    found = {}
    for name, fn in steps.items():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        found[name] = statistics.median(times)
    return found


def main(edges_path: str, baseline: str | None) -> int:
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_pairsets: no CUDA device available", file=sys.stderr)
        return 2
    from chip_smoke import neighbor_sets
    from repro_torch import engine
    from repro_torch.analysis.roofline import HW
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine import plans
    from repro_torch.graph import generators
    from repro_torch.kernels import _build, intersection_stats, packing
    from repro_torch.kernels import union_estimate

    if not os.path.exists(edges_path):
        np.save(edges_path, generators.rmat(SCALE, EDGE_FACTOR, seed=SEED))
    edges = np.load(edges_path)
    n = 1 << SCALE
    libs = build_variants(root, baseline, VARIANTS, LAUNCHERS,
                          "pairsets_sweep")
    wrappers = {"wrapper": (intersection_stats, union_estimate)}
    if baseline is not None:
        wrappers["baseline_wrapper"] = baseline_wrappers(baseline)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    byte = engine.build(edges, n, HLLConfig(p=P), device="cuda").regs
    panels = {"byte": byte, "packed": packing.pack_rows(byte)}
    r, q = 1 << P, 64 - P

    # the main path's draws first, from one generator, as chip_smoke.py
    rng = np.random.default_rng(SEED)
    main_pairs = edges[rng.choice(len(edges), 16384, replace=False)]
    main_sets = neighbor_sets(np, edges, n, rng)[1]
    rng = np.random.default_rng(SEED + 2)
    many_pairs = edges[rng.choice(len(edges), 1 << 18, replace=False)]
    many_sets = neighbor_sets(np, edges, n, rng, count=65536)[1]
    skew_sets = neighbor_sets(np, edges, n, rng, count=4096,
                              max_degree=1023)[1]

    def pair_case(pairs, layout):
        regs = panels[layout]
        ids = torch.from_numpy(plans.pad_pairs(pairs)[0]).to(dev)
        pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
        b, w = pa.shape[0], regs.shape[1]
        stats = torch.empty((b, 5, q + 2), dtype=torch.float32, device=dev)
        sz = torch.empty((b, 3, 2), dtype=torch.float32, device=dev)
        st_p, sz_p = intersection_stats.plain(regs, pa, pb, q, layout=layout)
        zeros = (sz_p[:, :, 1].mean(dim=0) / r).tolist()
        args = (regs.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                stats.data_ptr(), sz.data_ptr(), b, regs.shape[0], r, q,
                stream)

        def check(st, s):
            if layout == "packed":
                return torch.equal(st, st_p) and torch.equal(s, sz_p)
            return (torch.equal(st, st_p)
                    and torch.equal(s[..., 1], sz_p[..., 1])
                    and torch.allclose(s[..., 0], sz_p[..., 0], rtol=1e-6,
                                       atol=0))
        n_bytes = (torch.unique(ids).numel() * w + 8 * b
                   + 4 * b * (5 * (q + 2) + 6))
        info = {"pairs": b, "zero_share_a_b_union": zeros,
                "bound_ms": n_bytes / HW().hbm_bw * 1e3}
        return {
            "source": "intersection_stats.cu",
            "kernel": _build.kernel_name("intersection_stats", layout),
            "args": args,
            "check": lambda: check(stats, sz),
            "call": lambda mod: mod[0].intersection_stats(regs, pa, pb, q,
                                                          layout=layout),
            "check_call": lambda out: check(*out), "info": info,
            "op": "intersection_stats", "inputs": (regs, ids)}

    def set_case(sets, layout):
        regs = panels[layout]
        ids_np, mask_np = plans.pad_sets(sets)
        ids = torch.from_numpy(ids_np).to(dev)
        mask = torch.from_numpy(mask_np).to(dev)
        b, w = ids_np.shape[0], regs.shape[1]
        out = torch.empty((b, 2), dtype=torch.float32, device=dev)
        want = union_estimate.plain(regs, ids, mask, layout=layout)
        args = (regs.data_ptr(), ids.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b, regs.shape[0], ids_np.shape[1], r, stream)

        def check(got):
            if layout == "packed":
                return torch.equal(got, want)
            return torch.equal(got[:, 1], want[:, 1]) and torch.allclose(
                got[:, 0], want[:, 0], rtol=1e-6, atol=0)
        members = int(mask_np.sum())
        n_bytes = (np.unique(ids_np[mask_np]).size * w + 5 * ids_np.size
                   + 8 * b)
        info = {"panel": list(ids_np.shape), "members": members,
                "bound_ms": n_bytes / HW().hbm_bw * 1e3}
        return {
            "source": "union_estimate.cu",
            "kernel": _build.kernel_name("union_estimate_stats", layout),
            "args": args,
            "check": lambda: check(out),
            "call": lambda mod: mod[1].union_estimate_stats(
                regs, ids, mask, layout=layout),
            "check_call": check, "info": info,
            "op": "union_estimate", "inputs": (regs, ids, mask)}

    cases = {}
    for layout in ("byte", "packed"):
        cases[f"(a) {layout} 16384 pairs"] = pair_case(main_pairs, layout)
        cases[f"(a) {layout} 4096 sets"] = set_case(main_sets, layout)
        cases[f"(b) {layout} 262144 pairs"] = pair_case(many_pairs, layout)
        cases[f"(c) {layout} 65536 sets"] = set_case(many_sets, layout)
        cases[f"(d) {layout} 4096 skewed sets"] = set_case(skew_sets, layout)
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    times = {key: {} for key in cases}
    for rep in range(REPS + 1):  # round 0 warms up and checks
        for key, case in cases.items():
            runs = [(v, lib) for v, lib in libs[case["source"]].items()]
            runs += [(v, mod) for v, mod in wrappers.items()]
            for variant, what in runs:
                is_wrapper = variant in wrappers
                flush.sum()  # reads: the L2 then holds clean lines
                if is_wrapper:
                    torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                if is_wrapper:
                    out = case["call"](what)
                else:
                    err = call(what, case["kernel"], case["args"])
                host_us = (time.perf_counter() - t0) * 1e6
                end.record()
                if not is_wrapper and err != 0:
                    raise SystemExit(f"{case['kernel']} variant {variant}: "
                                     f"cudaError {err}")
                if rep == 0:
                    torch.cuda.synchronize()
                    ok = (case["check_call"](out) if is_wrapper
                          else variant in TIMING_ONLY or case["check"]())
                    if not ok:
                        raise SystemExit(f"{case['kernel']} {variant} "
                                         f"differs from the plain version "
                                         f"({key})")
                else:
                    times[key].setdefault(variant, []).append(
                        (start, end, host_us))
    torch.cuda.synchronize()
    host = wrapper_host_steps(torch, panels["byte"], main_sets, dev,
                              wrappers)
    blocks = autotune_times([(c["op"], key.split()[1], key, c["inputs"])
                             for key, c in cases.items()])
    results = {}
    for key, per in times.items():
        info = cases[key]["info"]
        print(f"{key}: {json.dumps(info)}", flush=True)
        for variant, events in per.items():
            ms = [s.elapsed_time(e) for s, e, _ in events]
            med = statistics.median(ms)
            res = {"median_ms": med, "min_ms": min(ms),
                   "bound_share": info["bound_ms"] / med,
                   "host_us": statistics.median(h for _, _, h in events)}
            line = (f"  {variant}: median {med:.4f} ms, min {min(ms):.4f} "
                    f"ms, {100 * res['bound_share']:.1f}% of the bound, host "
                    f"{res['host_us']:.1f} us")
            if "members" in info:
                res["ns_per_member"] = med * 1e6 / info["members"]
                line += f", {res['ns_per_member']:.2f} ns a member row"
            results[f"{key} / {variant}"] = res
            print(line, flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    for step, us in host.items():
        print(f"host: {step}: {us:.2f} us", flush=True)
    print(json.dumps({"card": card, "reps": REPS, "host_us": host,
                      "cases": {k: c["info"] for k, c in cases.items()},
                      "results": results, "autotune": blocks}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else None))
