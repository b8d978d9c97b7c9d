#!/usr/bin/env python3
"""Time the port's byte-layout main path on one card, step by step, so
that two checkouts of the repository can be compared in one call.

    python3 scripts/time_main_path.py EDGES_NPY

Run it from a checkout's root: that checkout's ``src`` goes first on the
path, so the same command times whichever tree it runs in. The graph is
the one ``chip_smoke.py`` drives, RMAT scale 22, edge factor 16, seed 0
(``repro_torch.graph.generators.rmat``), cached at ``EDGES_NPY`` by the
first run so that every checkout reads the same edges. The steps are the
smoke's main path with ``HLLConfig(p=8)``: ``engine.build``, ``degrees``,
``neighborhood(3)`` (the panel cache and the propagate routing dropped
before each run, as a new engine version drops them),
``intersection_size`` on 16,384 edge pairs with the MLE, ``union_size`` on
4,096 random sets of 1-63 ids, and ``query_batch`` over the three; then
the smoke's ADS and merge phases with ``ADSConfig(p=8)``: ``engine.build``
with ``family="ads"``, ``distance_histogram(6)`` (caches dropped before
each run), the two half builds of the even- and odd-indexed edges, and
their ``merge``. Each runs ``REPS`` times on the host clock, ending in a
device synchronize; the first run is reported apart from the median of
the others, because a first call pays one-time costs (library loading,
allocator growth). Each step also reports its peak device memory
(``max_memory_allocated``, reset before every run; the maximum over its
runs).

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

REPS = 5
SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
N_PAIRS, N_SETS, T_MAX = 16384, 4096, 3


def main(edges_path: str) -> int:
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_main_path: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators

    if not os.path.exists(edges_path):
        np.save(edges_path, generators.rmat(SCALE, EDGE_FACTOR, seed=SEED))
    edges = np.load(edges_path)
    n = 1 << SCALE
    rng = np.random.default_rng(SEED)
    pairs = edges[rng.choice(len(edges), N_PAIRS, replace=False)]
    sets = [rng.integers(0, n, rng.integers(1, 64)) for _ in range(N_SETS)]
    cfg = HLLConfig(p=P)
    times: dict[str, list[float]] = {}
    peaks: dict[str, float] = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        peaks[name] = max(peaks.get(name, 0.0),
                          torch.cuda.max_memory_allocated() / 2 ** 30)
        return out

    eng = None
    for _ in range(REPS):
        eng = None  # free the previous panel before the next build
        eng = timed("build", lambda: engine.build(edges, n, cfg,
                                                  device="cuda"))
    for _ in range(REPS):
        timed("degrees", eng.degrees)
    for _ in range(REPS):
        eng._invalidate_caches()
        timed("neighborhood", lambda: eng.neighborhood(T_MAX))
    for _ in range(REPS):
        timed("intersection_size",
              lambda: eng.intersection_size(pairs, method="mle"))
    for _ in range(REPS):
        timed("union_size", lambda: eng.union_size(sets))
    for _ in range(REPS):
        timed("query_batch", lambda: eng.query_batch(
            degrees=True, vertex_sets=sets, pairs=pairs, method="mle"))
    eng = None
    ads_cfg = ADSConfig(p=P)
    for _ in range(REPS):
        eng = None
        eng = timed("ads_build", lambda: engine.build(
            edges, n, ads_cfg, family="ads", device="cuda"))
    for _ in range(REPS):
        eng._invalidate_caches()
        timed("distance_histogram", lambda: eng.distance_histogram(6))
    eng = None
    for _ in range(REPS):
        halves = None
        halves = timed("merge_half_builds", lambda: [engine.build(
            edges[i::2], n, ads_cfg, family="ads", device="cuda")
            for i in (0, 1)])
        timed("merge", lambda: halves[0].merge(halves[1]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"tree": os.getcwd(), "card": card, "steps": {
        name: {"first": v[0], "median_rest": statistics.median(v[1:]),
               "all": v, "peak_gib": peaks[name]}
        for name, v in times.items()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
