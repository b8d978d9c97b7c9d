"""Run one cell of the benchmark once and print its result line.

    python3 sketchbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's chips. The
last line of standard output is the result, one JSON object; the numbers
the output check compared, each beside its limit, are the last lines of
standard error and the result's last key. Exits non-zero, printing no
result, without the cell's cards, when the program cannot be imported,
or when the JAX package or JAX was loaded by the run's end.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from sketchbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), cell=cell, t_start=T_START)
    steps = sorted(1e3 * s for s in out.pop("step_s"))
    if steps:
        print(f"steps: {len(steps)}, ms mean {sum(steps) / len(steps):.1f} "
              f"min {steps[0]:.1f} median "
              f"{steps[len(steps) // 2]:.1f} p90 "
              f"{steps[int(0.9 * (len(steps) - 1))]:.1f} max {steps[-1]:.1f}",
              file=sys.stderr)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"host: peak RSS {rss:.2f} GiB", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
