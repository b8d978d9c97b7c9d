"""Readings that the output check's limits are set from.

    python3 sketchbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--seconds 0] [--out FILE]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, the window of ``--seconds``, at least one step), the numbers its
checks compare for the program, and the same numbers for the control:
the plain reference computed one precision below the configuration's
(``harness.CONTROL_BELOW``), judged in the program's place. One JSON line
a seed on standard output (and appended to ``--out``). Needs the cell's
cards.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from sketchbench import harness
    import torch
    cell = harness.find_cell(ROOT, args.workload)
    if torch.cuda.device_count() < cell.chips:
        print("calibrate: not enough CUDA devices", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, cell=cell, controls=True)
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "program": {k: v["value"] for k, v in out["checks"].items()},
            "control": out["control"], "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "steps": out["attempted"], "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
