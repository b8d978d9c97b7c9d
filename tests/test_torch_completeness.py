"""The port does all that the JAX package does, as a check: every module
under ``src/repro/`` has its counterpart under ``src/repro_torch/``, and
every public name of it (its ``__all__`` and the names its top level
defines without a leading underscore) exists in the counterpart, except
the deliberate gaps that ROADMAP lists under "Conventions", named one by
one in :data:`GAPS`. Each gap must still be a gap: the reference has the
name (``train_arg_shardings`` only in its ``__all__``) and the port does
not, so the list cannot outlive what it excuses.

Also the three plan helpers ported to close the surface
(``plans.normalize_pairs``, ``plans.pad_routing``, ``base.bucket``)
against the reference's on the same inputs.
"""
import ast
import importlib
import pathlib

import numpy as np
import pytest

from repro.engine import base as jbase
from repro.engine import plans as jplans
from repro_torch.engine import base, plans

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

#: module -> names the port leaves out on purpose (ROADMAP, Conventions)
GAPS = {
    # block constants: the port's launch shapes are autotune.FALLBACK
    "kernels.hll_accumulate": {"DEFAULT_EDGE_BLOCK"},
    "kernels.hll_propagate": {"DEFAULT_EDGE_BLOCK"},
    "kernels.hll_estimate": {"DEFAULT_ROW_BLOCK"},
    "kernels.hip_delta": {"DEFAULT_ROW_BLOCK"},
    "kernels.union_estimate": {"DEFAULT_SET_BLOCK"},
    "kernels.intersection_stats": {"DEFAULT_PAIR_BLOCK"},
    "kernels.ertl_stats": {"DEFAULT_PAIR_BLOCK"},
    # the port writes panels in place
    "kernels.ops": {"accumulate_donated"},
    # no impl or family registered from outside ops; no interpret mode
    "kernels.registry": {"register", "register_family", "interpret_mode",
                         "MASKED_OPS"},
    # unbatched kinds call their kernels directly
    "engine.plans": {"build_degrees_plan", "build_propagate_plan",
                     "build_merge_plan", "build_replica_gather_plan",
                     "build_hip_delta_plan"},
    # the JAX init_* functions: module constructors and init_params
    "models.layers": {"init_dense", "init_rmsnorm", "init_embedding",
                      "init_swiglu"},
    "models.attention": {"init_attention"},
    "models.moe": {"init_moe"},
    "models.ssm": {"init_mamba"},
    # a reference defect: in its __all__, never defined (ROADMAP Queue C)
    "models.sharding": {"train_arg_shardings"},
}


def _modules() -> list[str]:
    """Every module of the reference, dotted, relative to the package."""
    out = []
    for path in sorted(REF.rglob("*.py")):
        parts = list(path.relative_to(REF).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _public_names(rel: str) -> set[str]:
    """The reference module's ``__all__`` and its top level's public
    definitions, read from its source (nothing of it is imported)."""
    path = REF / (rel.replace(".", "/") if rel else "")
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names: set[str] = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names.update(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return {n for n in names if not n.startswith("_")}


MODULES = _modules()


def test_every_reference_module_is_listed():
    assert len(MODULES) > 80 and "launch.dryrun" in MODULES
    assert set(GAPS) <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES, ids=lambda m: m or "repro")
def test_module_and_public_names_exist_in_the_port(rel):
    port = importlib.import_module("repro_torch" + (f".{rel}" if rel else ""))
    gaps = GAPS.get(rel, set())
    missing = sorted(n for n in _public_names(rel) - gaps
                     if not hasattr(port, n))
    assert missing == [], f"repro_torch.{rel} lacks {missing}"
    for name in gaps:
        assert name in _public_names(rel), (rel, name)
        assert not hasattr(port, name), f"{rel}.{name} is no longer a gap"


def test_normalize_pairs_and_bucket_equal_the_reference():
    assert base.bucket is plans.bucket and "bucket" in base.__all__
    for size in (0, 1, 7, 8, 9, 1000, 1 << 20):
        assert base.bucket(size) == jbase.bucket(size)
    for pairs in ([3, 4], [[0, 1], [2, 3], [4, 0]],
                  np.arange(40).reshape(20, 2)):
        got, want = plans.normalize_pairs(pairs, 64), \
            jplans.normalize_pairs(pairs, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert np.asarray(g).dtype == np.asarray(w).dtype
    for bad in ([[0, 64]], [[0.5, 1.0]], [[1, 2, 3]]):
        with pytest.raises(ValueError):
            jplans.normalize_pairs(bad, 64)
        with pytest.raises(ValueError):
            plans.normalize_pairs(bad, 64)


@pytest.mark.parametrize("m", [0, 1, 8, 9, 300])
def test_pad_routing_equals_the_reference(m):
    rng = np.random.default_rng(m)
    src, dst = rng.integers(0, 50, (2, m))
    for g, w in zip(plans.pad_routing(src, dst),
                    jplans.pad_routing(src, dst)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
