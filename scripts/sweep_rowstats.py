#!/usr/bin/env python3
"""Time variants of the row-statistics kernels' design on one card.

    python3 scripts/sweep_rowstats.py EDGES_NPY [BASELINE_TREE]

Run it from a checkout's root. ``csrc/hll_estimate.cu`` and
``csrc/hip_delta.cu`` hold their design choices as constants: the load
width ``kVecBytes``, the loads of its row a lane has in flight
``kLoads`` (which sets the lanes per row: a p=8 row of 16 vectors takes
16 / kLoads lanes) and the persistent grid's ``kBlocksPerSM``. This
script compiles each source once per entry of its variant table (the
constants replaced in a copy under ``build/rowstats_sweep/``, each copy
built by its own ``nvcc``, all started together; ``nvcc``'s register and
spill report kept beside each library); every launcher runs at its op's
fallback block size. The block size is a launch argument (the op's
``row_block``, once the constant ``kThreads``): its candidates are timed
by ``kernels.autotune.sweep`` at each of the shapes below, one line a
shape (``sweep_propagate.autotune_times``). ``BASELINE_TREE``, the root
of another checkout (for example the parent commit unpacked with ``git
archive`` under ``build/``), adds that tree's two sources as the variant
``baseline``, the old design beside the new.

Shapes are the main path's: the scale-22 graph (RMAT, edge factor 16,
seed 0, cached at ``EDGES_NPY`` by the first run, as
``scripts/time_main_path.py`` caches it), its panel built with
``HLLConfig(p=8)`` (4,194,304 rows of 256 bytes) and that panel packed;
2^18 rows gathered from it at random edges' first endpoints, the
triangle phase's block; and for ``hip_delta_rows`` the panel as D^1
against one propagate pass of it as D^2. Each variant's output must
equal the library kernel's (zero counts, packed sums and HIP increments
bit for bit, byte harmonic sums within ``rtol=1e-6``). Times are
CUDA-event medians over ``REPS`` launches of the launcher alone, taken
in turns (every variant once per round), so drift spreads evenly.

Prints the card's name and power limit, then one JSON line. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

from sweep_propagate import autotune_times, takes_knob, variant_source

REPS = 15
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
TRIANGLE_BLOCK = 1 << 18
#: source -> the autotune op whose block its launchers take
SOURCE_OP = {"hll_estimate.cu": "estimate", "hip_delta.cu": "hip_delta",
             "intersection_stats.cu": "intersection_stats",
             "union_estimate.cu": "union_estimate"}
#: source -> {variant: {constant: value}}; {} is the source as is
VARIANTS = {
    "hll_estimate.cu": {
        "as_is": {},
        "loads1": {"kLoads": "1"},
        "loads2": {"kLoads": "2"},
        "loads8": {"kLoads": "8"},
        "vec8": {"kVecBytes": "8"},
        "blocks2": {"kBlocksPerSM": "2"},
        "blocks4": {"kBlocksPerSM": "4"},
    },
    "hip_delta.cu": {
        "as_is": {},
        "loads1": {"kLoads": "1"},
        "loads4": {"kLoads": "4"},
        "loads8": {"kLoads": "8"},
        "vec8": {"kVecBytes": "8"},
        "blocks2": {"kBlocksPerSM": "2"},
        "blocks4": {"kBlocksPerSM": "4"},
    },
}
LAUNCHERS = {"hll_estimate.cu": ("hll_estimate_stats",
                                 "hll_estimate_stats_packed"),
             "hip_delta.cu": ("hip_delta_rows",)}


def call(lib_block, kernel: str, args: tuple) -> int:
    """Launcher ``kernel`` of ``lib_block`` (a ``build_variants`` entry)
    on ``args`` (stream last, no block argument), with the op's fallback
    block put before the stream when its launcher takes one."""
    lib, block = lib_block
    fn = getattr(lib, kernel)
    if block is None:
        return fn(*args)
    return fn(*args[:-1], block, args[-1])


def build_variants(root: str, baseline: str | None, variants_of=VARIANTS,
                   launchers=LAUNCHERS, out_dir: str = "rowstats_sweep",
                   ) -> dict[str, dict[str, tuple]]:
    """{source: {variant: (library, block)}} for the table
    ``variants_of`` (source -> {variant: constants}), every library
    compiled together under ``build/<out_dir>/``
    (``_build.compile_library``; each report kept beside its library).
    ``block`` is the launcher argument the variant runs with: the op's
    fallback, or ``None`` for a baseline whose launchers take none."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from repro_torch.kernels import _build, autotune
    out = Path(root, "build", out_dir)
    shutil.rmtree(out, ignore_errors=True)
    jobs, blocks = {}, {}
    for source, variants in variants_of.items():
        csrc = Path(root, "src", "repro_torch", "csrc")
        (fallback,) = autotune.FALLBACK[SOURCE_OP[source]].values()
        texts = {}
        for name, consts in variants.items():
            blocks[(source, name)] = fallback
            texts[name] = variant_source((csrc / source).read_text(),
                                         consts)
        dirs = {name: csrc for name in variants}
        if baseline is not None:
            old = Path(baseline, "src", "repro_torch", "csrc")
            texts["baseline"] = (old / source).read_text()
            dirs["baseline"] = old
            blocks[(source, "baseline")] = (
                blocks[(source, "as_is")] if takes_knob(
                    texts["baseline"], launchers[source][0]) else None)
        for name, text in texts.items():
            d = out / f"{Path(source).stem}_{name}"
            d.mkdir(parents=True)
            shutil.copy(dirs[name] / "common.cuh", d)
            (d / source).write_text(text)
            jobs[(source, name)] = (d / source, d / f"lib_{name}.so")
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(zip(jobs, pool.map(
            lambda sl: _build.compile_library([sl[0]], sl[1]),
            jobs.values())))
    libs: dict[str, dict[str, tuple]] = {s: {} for s in variants_of}
    for (source, name), (_, path) in jobs.items():
        path.with_suffix(".log").write_text(logs[(source, name)])
        lib = ctypes.CDLL(str(path))
        block = blocks[(source, name)]
        for kernel in launchers[source]:
            fn = getattr(lib, kernel)
            types = list(_build.KERNELS[kernel])
            if block is None:
                types.pop(-2)  # an older launcher has no block argument
            fn.argtypes = types
            fn.restype = ctypes.c_int
        libs[source][name] = (lib, block)
    return libs


def main(edges_path: str, baseline: str | None) -> int:
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_rowstats: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels.inputs import directed_routing
    from repro_torch.graph import generators
    from repro_torch.kernels import hip_delta, hll_estimate, ops, packing

    if not os.path.exists(edges_path):
        np.save(edges_path, generators.rmat(SCALE, EDGE_FACTOR, seed=SEED))
    edges = np.load(edges_path)
    n = 1 << SCALE
    libs = build_variants(root, baseline)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    eng = engine.build(edges, n, HLLConfig(p=P), device="cuda")
    byte = eng.regs
    nxt = ops.propagate(byte, *directed_routing(edges, dev))
    pick = np.random.default_rng(SEED + 1).choice(len(edges), TRIANGLE_BLOCK,
                                                  replace=False)
    block = byte[torch.from_numpy(edges[pick, 0].astype(np.int64)).to(dev)]
    packed = packing.pack_rows(byte)
    r = 1 << P

    def estimate_case(regs, layout):
        out = torch.empty((regs.shape[0], 2), dtype=torch.float32,
                          device=dev)
        want = hll_estimate.hll_estimate_stats(regs, layout=layout)
        name = ("hll_estimate_stats_packed" if layout == "packed"
                else "hll_estimate_stats")
        args = (regs.data_ptr(), out.data_ptr(), regs.shape[0], r, stream)

        def check():
            if layout == "packed":
                return torch.equal(out, want)
            return torch.equal(out[:, 1], want[:, 1]) and torch.allclose(
                out[:, 0], want[:, 0], rtol=1e-6, atol=0)
        return name, args, check

    def hip_case():
        out = torch.empty(byte.shape[0], dtype=torch.float32, device=dev)
        want = hip_delta.hip_delta_rows(byte, nxt)
        args = (byte.data_ptr(), nxt.data_ptr(), out.data_ptr(),
                byte.shape[0], r, stream)
        return "hip_delta_rows", args, lambda: torch.equal(out, want)

    cases = {
        ("hll_estimate.cu", "byte, 4194304 rows"): estimate_case(byte, "byte"),
        ("hll_estimate.cu", "byte, 262144 rows"): estimate_case(block, "byte"),
        ("hll_estimate.cu", "packed, 4194304 rows"): estimate_case(
            packed, "packed"),
        ("hip_delta.cu", "D^1 -> D^2, 4194304 rows"): hip_case(),
    }
    times = {key: {v: [] for v in libs[key[0]]} for key in cases}
    for rep in range(REPS + 1):  # round 0 warms up and checks
        for key, (kernel, args, check) in cases.items():
            for variant, lib in libs[key[0]].items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = call(lib, kernel, args)
                end.record()
                if err != 0:
                    raise SystemExit(f"{kernel} variant {variant}: "
                                     f"cudaError {err}")
                if rep == 0:
                    torch.cuda.synchronize()
                    if not check():
                        raise SystemExit(f"{kernel} variant {variant} "
                                         f"differs from the library kernel "
                                         f"({key[1]})")
                else:
                    times[key][variant].append((start, end))
    torch.cuda.synchronize()
    results = {}
    for key, per in times.items():
        for variant, events in per.items():
            ms = [s.elapsed_time(e) for s, e in events]
            results[f"{key[0]} {key[1]} / {variant}"] = {
                "median_ms": statistics.median(ms), "min_ms": min(ms)}
            print(f"{key[0]} {key[1]} / {variant}: median "
                  f"{statistics.median(ms):.4f} ms, min {min(ms):.4f} ms "
                  f"over {REPS}", flush=True)
    blocks = autotune_times([
        ("estimate", "byte", "4194304 rows", (byte,)),
        ("estimate", "byte", "262144 rows", (block,)),
        ("estimate", "packed", "4194304 rows", (packed,)),
        ("hip_delta", "byte", "D^1 -> D^2", (byte, nxt))])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "results": results,
                      "autotune": blocks}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else None))
