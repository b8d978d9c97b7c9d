"""The plain reference against the program at small sizes on the CPU, and
the benchmark's import isolation. The tests may import the program; the
reference may not."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import engine
from repro_torch.core import hashing
from repro_torch.core.hll import HLLConfig
from sketchbench.gen.rmat_torch import rmat
from sketchbench.reference import Reference, hashing as ref_hashing, mle
from sketchbench.reference import sketch

BENCH = Path(__file__).resolve().parents[1]
SCALE = 10
N = 1 << SCALE


def _config(layout: str) -> dict:
    return {"sketch": {"p": 8, "seed": 0}, "layout": layout}


@pytest.fixture(scope="module")
def graph():
    return rmat(SCALE, 16, 2 ** 31 + 1, 0.57, 0.19, 0.19, "cpu").numpy()


@pytest.mark.parametrize("p,seed", [(4, 0), (8, 0), (12, 7)])
def test_hash_matches_program(p, seed):
    keys = torch.randint(0, 2 ** 32, (4096,), dtype=torch.int64)
    b, r = ref_hashing.bucket_rho(keys, p, seed)
    pb, pr = hashing.bucket_rho(keys, p, seed)
    assert torch.equal(b, pb.to(torch.int64))
    assert torch.equal(r, pr.to(torch.int64))


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_registers_match_program(graph, layout):
    eng = engine.build(graph, N, HLLConfig(p=8), layout=layout, device="cpu")
    regs = eng.regs[:N]
    if layout == "packed":
        regs = sketch.unpack_split_half(regs)
    assert torch.equal(Reference(graph, N, _config(layout), "cpu").panel(),
                       regs)


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_hops_match_program(graph, layout):
    eng = engine.build(graph, N, HLLConfig(p=8), layout=layout, device="cpu")
    local, _ = eng.neighborhood(4)
    want = Reference(graph, N, _config(layout), "cpu").hop_estimates(4)
    np.testing.assert_allclose(local, want.double().numpy(), rtol=1e-6)


def test_propagate_is_a_register_max_over_neighbours(graph):
    e = torch.from_numpy(graph)
    panel = sketch.accumulate(e, N, 8, 0)
    src = torch.cat([e[:, 0], e[:, 1]]).long()
    dst = torch.cat([e[:, 1], e[:, 0]]).long()
    want = panel.clone().to(torch.int32)
    want.index_reduce_(0, dst, panel[src].to(torch.int32), "amax")
    assert torch.equal(sketch.Routing(e, N).propagate(panel),
                       want.to(torch.uint8))


def test_mle_matches_program(graph):
    eng = engine.build(graph, N, HLLConfig(p=8), device="cpu")
    pairs = graph[np.random.default_rng(3).integers(0, len(graph), 256)]
    got = eng.intersection_size(pairs, method="mle", iters=50)
    want, union, settled = Reference(graph, N, _config("byte"),
                                     "cpu").pair_mle(pairs, 50)
    gap = np.abs(got - want.numpy()) / np.maximum(union.numpy(), 1.0)
    assert gap.max() < 1e-5
    assert settled.dtype == torch.bool and settled.float().mean() > 0.5


def test_ascent_stopped_early_has_not_settled(graph):
    """Three Newton steps leave pairs moving; fifty settle most."""
    pairs = graph[np.random.default_rng(4).integers(0, len(graph), 256)]
    ref = Reference(graph, N, _config("byte"), "cpu")
    _, _, early = ref.pair_mle(pairs, 3)
    _, _, late = ref.pair_mle(pairs.copy(), 50)
    assert early.float().mean() < late.float().mean()


def test_solve3_is_a_solve():
    a = torch.randn(64, 3, 3, dtype=torch.float64) + 4 * torch.eye(3)
    g = torch.randn(64, 3, dtype=torch.float64)
    torch.testing.assert_close(mle._solve3(a, g), torch.linalg.solve(a, g))


# --------------------------------------------------------------- isolation
BANNED = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_no_jax_or_jax_package_import():
    bad = {str(p.relative_to(BENCH)): _imported_roots(p) & BANNED
           for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_never_imports_the_program():
    bad = {str(p.relative_to(BENCH)): _imported_roots(p)
           for p in (BENCH / "reference").rglob("*.py")}
    assert not {k: v for k, v in bad.items() if "repro_torch" in v}


def test_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch\nfrom repro.core import hll\n"
                 "import jaxlib.xla\n")
    assert _imported_roots(f) & BANNED == {"repro", "jaxlib"}
