#!/usr/bin/env python3
"""Time variants of the propagate kernel's design constants on one card.

    python3 scripts/sweep_propagate.py EDGES_NPY

Run it from a checkout's root. ``csrc/hll_propagate.cu`` holds its design
choices as constants: the edge-run length ``kRunEdges``, the batch of
source rows a lane loads before it folds them ``kBatch`` and the block
size ``kThreads``.
This script compiles the source once per entry of ``VARIANTS`` (the
constants replaced in a copy under ``build/propagate_sweep/``, each copy
built by its own ``nvcc``, all started together; ``nvcc``'s register and
spill report kept beside each library), then times each variant's byte
and packed launchers on the main path's shapes: the scale-22 graph (RMAT,
edge factor 16, seed 0, cached at ``EDGES_NPY`` by the first run, as
``scripts/time_main_path.py`` caches it), its panel built with
``HLLConfig(p=8)``, and the engine's routing (``directed_routing``).
Each variant's panel must equal the library kernel's bit for bit. Times
are CUDA-event medians over ``REPS`` launches of the launcher alone (no
clone, no order check).

Prints the card's name and power limit, then one JSON line. Exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

REPS = 5
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
#: name -> {constant: value} replaced in the source; {} is the source as is
VARIANTS = {
    "as_is": {},
    "run512": {"kRunEdges": "512"},
    "run2048": {"kRunEdges": "2048"},
    "batch4": {"kBatch": "4"},
    "batch6": {"kBatch": "6"},
    "batch12": {"kBatch": "12"},
    "threads128": {"kThreads": "128"},
    "threads512": {"kThreads": "512"},
}


def variant_source(text: str, consts: dict[str, str]) -> str:
    """The source with each named ``constexpr`` given a new value."""
    for name, value in consts.items():
        pattern = rf"(constexpr \w+ {name} = )[^;]+;"
        if not re.search(pattern, text):
            raise SystemExit(f"sweep_propagate: constant {name} not found")
        text = re.sub(pattern, rf"\g<1>{value};", text)
    return text


def build_variants(root: str) -> dict[str, ctypes.CDLL]:
    """One shared library per variant, all compiled together
    (``_build.compile_library``; each report kept beside its library)."""
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from repro_torch.kernels import _build
    csrc = Path(root, "src", "repro_torch", "csrc")
    text = (csrc / "hll_propagate.cu").read_text()
    out = Path(root, "build", "propagate_sweep")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(csrc / "common.cuh", out)
    libs = {}
    for name, consts in VARIANTS.items():
        src = out / f"hll_propagate_{name}.cu"
        src.write_text(variant_source(text, consts))
        libs[name] = (src, out / f"libprop_{name}.so")
    with ThreadPoolExecutor(len(libs)) as pool:
        logs = dict(zip(libs, pool.map(
            lambda sl: _build.compile_library([sl[0]], sl[1]),
            libs.values())))
    for name, (src, path) in libs.items():
        path.with_suffix(".log").write_text(logs[name])
        lib = ctypes.CDLL(str(path))
        for kernel in ("hll_propagate", "hll_propagate_packed"):
            fn = getattr(lib, kernel)
            fn.argtypes = list(_build.KERNELS[kernel])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(edges_path: str) -> int:
    root = os.getcwd()
    sys.path.insert(0, os.path.join(root, "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sweep_propagate: no CUDA device available",
              file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels.inputs import directed_routing
    from repro_torch.graph import generators
    from repro_torch.kernels import _build, hll_propagate

    if not os.path.exists(edges_path):
        np.save(edges_path, generators.rmat(SCALE, EDGE_FACTOR, seed=SEED))
    edges = np.load(edges_path)
    n = 1 << SCALE
    libs = build_variants(root)
    src, dst = directed_routing(edges, torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for layout in ("byte", "packed"):
        regs = engine.build(edges, n, HLLConfig(p=P), layout=layout,
                            device="cuda").regs
        want = hll_propagate.hll_propagate(regs, src, dst, layout=layout)
        name = _build.kernel_name("hll_propagate", layout)
        v, r = regs.shape[0], 1 << P
        for run, lib in libs.items():
            out = regs.clone()
            fn = getattr(lib, name)
            times = []
            for _ in range(REPS + 1):
                out.copy_(regs)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = fn(regs.data_ptr(), out.data_ptr(), src.data_ptr(),
                         dst.data_ptr(), src.numel(), v, r, stream)
                end.record()
                if err != 0:
                    raise SystemExit(f"{name} variant {run}: cudaError "
                                     f"{err}")
                times.append((start, end))
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"{name} variant {run} differs from the "
                                 f"library kernel")
            ms = [s.elapsed_time(e) for s, e in times[1:]]
            results[f"{layout}/{run}"] = {"median_ms": statistics.median(ms),
                                          "all_ms": ms}
            print(f"{name} variant {run}: median "
                  f"{statistics.median(ms):.4f} ms over {REPS}", flush=True)
        del regs, want
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"card": card, "edges": int(src.numel()),
                      "results": results}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
