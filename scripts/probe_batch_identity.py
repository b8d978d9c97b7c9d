#!/usr/bin/env python3
"""Check on one card that a row's answer does not depend on its batch.

    python3 scripts/probe_batch_identity.py

Run it from a checkout's root on a machine with a CUDA card. The serving
frontends coalesce requests into batches of any size, and promise answers
equal, bit for bit, to a direct call with the request alone; the eager
MLE tail (reductions per row, batched 3x3 solves) must then compute a
row the same way whatever batch it rides in. On an RMAT scale-16 graph
(edge factor 16, seed 5, p=8), for both register layouts, every request
of 1–200 pairs (sets) is answered alone and appended to batches of 1 to
70,000 other pairs (1 to 5,000 other sets); the script prints the count
of requests whose rows differ and exits non-zero if any does.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import engine  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

ALONE = (1, 3, 7, 8, 9, 33, 64, 200)
AROUND = (1, 7, 100, 1000, 5000, 20000, 70000)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_batch_identity: needs a CUDA card", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    edges = generators.rmat(16, 16, seed=5)
    n = 1 << 16
    bad = 0
    for layout in ("byte", "packed"):
        t0 = time.perf_counter()
        eng = engine.build(edges, n, HLLConfig(p=8), layout=layout)
        rng = np.random.default_rng(0)
        differ = {"intersection": 0, "union": 0}
        asked = {"intersection": 0, "union": 0}
        for k1 in ALONE:
            for k2 in AROUND:
                mine = edges[rng.integers(0, len(edges), k1)]
                other = edges[rng.integers(0, len(edges), k2)]
                both = eng.intersection_size(np.concatenate([other, mine]))
                differ["intersection"] += not np.array_equal(
                    both[k2:], eng.intersection_size(mine))
                asked["intersection"] += 1
                if k2 > 5000:
                    continue
                mine = [rng.integers(0, n, int(rng.integers(1, 64)))
                        for _ in range(k1)]
                other = [rng.integers(0, n, int(rng.integers(1, 64)))
                         for _ in range(k2)]
                both = eng.union_size(other + mine)
                differ["union"] += not np.array_equal(
                    both[k2:], eng.union_size(mine))
                asked["union"] += 1
        print(f"{layout}: requests {asked}; requests whose rows differ "
              f"with the batch: {differ} "
              f"({time.perf_counter() - t0:.1f} s)")
        bad += sum(differ.values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
