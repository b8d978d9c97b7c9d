"""Shared helpers of the benchmark's CPU tests: the checkout's root and
``src`` on the path, and the cells cut to a size a test run can hold."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from sketchbench import harness  # noqa: E402

#: the small graph and request of the CPU tests
SCALE, PAIRS = 10, 512


def small_cell(workload: str, root: Path = ROOT, scale: int = SCALE,
               pairs: int = PAIRS) -> harness.Cell:
    """``workload`` as ``BENCHMARK.json`` has it, at RMAT ``scale`` and
    with ``pairs`` pairs a request."""
    cell = harness.find_cell(root, workload)
    cell.config = dict(cell.config, scale=scale)
    cell.traffic = copy.deepcopy(cell.traffic)
    for call in cell.traffic["calls"]:
        for arg in call.get("args", []):
            if isinstance(arg, dict) and "count" in arg:
                arg["count"] = pairs
    return cell


def run_small(workload: str, seed: int = 2 ** 31 + 7, trace: bool = False,
              controls: bool = False, **kw) -> dict:
    """One run of the small ``workload`` on the CPU."""
    return harness.run_cell(ROOT, workload, seed, 0.3, trace, device="cpu",
                            cell=small_cell(workload, **kw),
                            controls=controls)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided inside the test, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
