"""The ``impl`` coordinate of the port: the kernel registry, the engine's
``impl=`` with the ``REPRO_TORCH_*`` defaults, plan keys and checkpoints.

Two impls are registered, "cuda" (the kernel wrappers: the kernel on a
CUDA tensor, its plain version on a CPU one) and "ref" (the plain
versions on any device). On the CPU both compute the same registers and
answers bit for bit; what differs is the route, which the tests observe
by replacing the wrappers. ``tests/test_torch_cuda.py`` holds "ref" on the
card against "cuda" there.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLLConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import plans  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import ops, registry  # noqa: E402

HLL_OPS = ("accumulate", "propagate", "estimate", "ertl_stats",
           "union_estimate", "intersection_stats")
WRAPPERS = ("hll_accumulate", "hll_propagate", "hll_estimate_stats",
            "union_estimate_stats", "_intersection_stats", "_ertl_stats",
            "hip_delta_rows")


@pytest.fixture(scope="module")
def graph():
    return generators.rmat(8, 8, seed=9), 1 << 8


PORT_VARS = ("REPRO_TORCH_IMPL", "REPRO_TORCH_LAYOUT", "REPRO_TORCH_FAMILY")
JAX_VARS = ("REPRO_IMPL", "REPRO_LAYOUT", "REPRO_FAMILY")


@pytest.fixture
def no_env(monkeypatch):
    for var in PORT_VARS + JAX_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture
def no_wrappers(monkeypatch):
    """Every kernel wrapper in ``ops`` replaced by one that fails: only
    the plain versions may run."""
    def forbid(name):
        def fail(*a, **kw):
            raise AssertionError(f"impl='ref' reached the wrapper {name}")
        return fail
    for name in WRAPPERS:
        monkeypatch.setattr(ops, name, forbid(name))


# --------------------------------------------------------------- registry
def test_every_op_has_both_impls():
    for op in HLL_OPS:
        assert registry.impls(op) == ["cuda", "ref"]
    for op in ("accumulate", "propagate", "estimate", "hip_delta"):
        assert registry.impls(op, "ads") == ["cuda", "ref"]
    assert registry.impls("hip_delta") == []
    assert registry.lookup("estimate", "ref").keywords == {"impl": "ref"}


def test_lookup_names_the_registered_impls():
    with pytest.raises(KeyError, match=r"pallas.*\['cuda', 'ref'\]"):
        registry.lookup("accumulate", "pallas")


def test_lookup_binds_the_ops_dispatch():
    """The registry is a view of ``kernels.ops``: a looked-up op and a
    kernel set's op both call ``ops.<op>`` with their impl."""
    calls = []
    regs = torch.zeros((8, 16), dtype=torch.uint8)
    cfg = HLLConfig(p=4)
    real = ops.estimate
    for impl in ops.IMPLS:
        want = real(regs, cfg, impl=impl)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "estimate", lambda *a, **kw: calls.append(kw)
                       or real(*a, **kw))
            got = registry.lookup("estimate", impl)(regs, cfg)
            ks = registry.resolve(cfg, "byte", impl)
            assert torch.equal(ks.estimate_rows(regs, cfg), got)
        assert torch.equal(got, want)
    assert calls == [{"impl": "cuda"}, {"impl": "cuda", "layout": "byte"},
                     {"impl": "ref"}, {"impl": "ref", "layout": "byte"}]


def test_lookup_rejects_an_op_of_another_family():
    with pytest.raises(KeyError, match=r"hip_delta.*impls.*\[\]"):
        registry.lookup("hip_delta", "cuda", "hll")
    assert registry.lookup("hip_delta", "ref", "ads").keywords == {
        "impl": "ref"}
    assert registry.impls("accumulate", "nope") == []


def test_resolve_fails_on_an_unknown_impl_naming_the_known():
    with pytest.raises(ValueError, match=r"'pallas'.*\['cuda', 'ref'\]"):
        registry.resolve(HLLConfig(p=4), impl="pallas")
    assert registry.resolve(HLLConfig(p=4), "packed", "ref") == \
        registry.KernelSet(impl="ref", layout="packed", family="hll")


def test_ops_reject_an_unknown_impl():
    regs = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="impl"):
        ops.estimate(regs, HLLConfig(p=4), impl="pallas")


# ----------------------------------------------------- engine and defaults
def test_engine_rejects_an_unknown_impl_before_any_work(graph, monkeypatch):
    edges, n = graph
    allocs = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: allocs.append(a))
    with pytest.raises(ValueError, match="cuda.*ref"):
        engine.build(edges, n, HLLConfig(p=4), impl="pallas", device="cpu")
    assert allocs == []


def test_defaults_read_the_environment_per_call(no_env, monkeypatch):
    assert (engine.default_impl(), engine.default_layout(),
            engine.default_family()) == ("cuda", "byte", "hll")
    eng = engine.open(16, device="cpu")
    assert (eng.impl, eng.layout, eng.family.name) == ("cuda", "byte", "hll")
    monkeypatch.setenv("REPRO_TORCH_IMPL", "ref")
    monkeypatch.setenv("REPRO_TORCH_LAYOUT", "packed")
    assert (engine.default_impl(), engine.default_layout()) == ("ref",
                                                                "packed")
    eng = engine.open(16, HLLConfig(p=4), device="cpu")
    assert (eng.impl, eng.layout) == ("ref", "packed")
    assert eng.kernels == registry.KernelSet("ref", "packed", "hll")
    monkeypatch.setenv("REPRO_TORCH_LAYOUT", "byte")
    monkeypatch.setenv("REPRO_TORCH_FAMILY", "ads")
    eng = engine.open(16, device="cpu")
    assert eng.family.name == "ads" and eng.cfg == ADSConfig()
    # explicit arguments win over the environment
    eng = engine.open(16, impl="cuda", family="hll", device="cpu")
    assert (eng.impl, eng.family.name) == ("cuda", "hll")
    monkeypatch.setenv("REPRO_TORCH_IMPL", "pallas")
    with pytest.raises(ValueError, match="pallas"):
        engine.open(16, device="cpu")


@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_the_jax_packages_variables_leave_the_port_alone(graph, tmp_path,
                                                         no_env, monkeypatch,
                                                         impl):
    """``REPRO_IMPL``/``REPRO_LAYOUT``/``REPRO_FAMILY`` belong to the JAX
    package (its CI legs set them for the whole test run): a port engine
    built without arguments under them is the default cuda/byte/HLL one,
    and its ingest goes through the kernel wrapper."""
    edges, n = graph
    monkeypatch.setenv("REPRO_IMPL", impl)
    monkeypatch.setenv("REPRO_LAYOUT", "packed")
    monkeypatch.setenv("REPRO_FAMILY", "ads")
    assert (engine.default_impl(), engine.default_layout(),
            engine.default_family()) == ("cuda", "byte", "hll")
    calls = []
    wrapper = ops.hll_accumulate
    monkeypatch.setattr(ops, "hll_accumulate",
                        lambda *a, **kw: calls.append(1) or wrapper(*a, **kw))
    eng = engine.build(edges, n, device="cpu")
    assert (eng.impl, eng.layout, eng.family.name) == ("cuda", "byte", "hll")
    assert eng.kernels == registry.KernelSet("cuda", "byte", "hll")
    assert calls == [1]
    eng.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu")
    assert (back.impl, back.layout) == ("cuda", "byte")


def test_ref_engine_runs_only_plain_versions(graph, no_env, no_wrappers):
    edges, n = graph
    pairs = edges[:40]
    sets = [np.arange(5), [3, 9, 200], edges[7]]
    for cfg, layout in ((HLLConfig(p=6), "byte"), (HLLConfig(p=6), "packed")):
        eng = engine.build(edges, n, cfg, layout=layout, impl="ref",
                           device="cpu")
        eng.degrees()
        eng.neighborhood(3)
        eng.union_size(sets)
        eng.intersection_size(pairs, iters=5)
        eng.query_batch(degrees=True, vertex_sets=sets, pairs=pairs, iters=5)
        eng.triangle_heavy_hitters(5, mode="edge", iters=5)
        eng.triangle_heavy_hitters(5, mode="vertex", iters=5)
    ads = engine.build(edges, n, ADSConfig(p=6), impl="ref", device="cpu")
    ads.distance_histogram(3)
    ads.closeness(3)


def test_ref_engine_equals_cuda_engine_on_the_cpu(graph):
    edges, n = graph
    pairs, sets = edges[:40], [np.arange(5), [3, 9, 200]]
    got = {}
    for impl in ("cuda", "ref"):
        eng = engine.build(edges, n, HLLConfig(p=6), impl=impl, device="cpu")
        got[impl] = [eng.regs.numpy(), eng.degrees(), *eng.neighborhood(3),
                     eng.union_size(sets), eng.intersection_size(pairs,
                                                                 iters=5),
                     *eng.triangle_heavy_hitters(5, iters=5)[1:]]
    for a, b in zip(got["cuda"], got["ref"]):
        np.testing.assert_array_equal(a, b)


def test_plan_key_carries_the_impl(graph):
    edges, n = graph
    plans.reset_trace_counts()
    cache = plans.global_cache()
    keys = set()
    sets = [np.arange(5), [3, 9, 200]]
    answers = []
    for impl in ("cuda", "ref", "cuda"):
        eng = engine.build(edges, n, HLLConfig(p=5), impl=impl, device="cpu")
        answers.append(eng.union_size(sets))
        keys |= {k for k in cache._entries if k.cfg == HLLConfig(p=5)
                 and k.query == "union"}
    assert {k.impl for k in keys} == {"cuda", "ref"}
    assert plans.trace_counts()["union"] == 2  # the third engine hits
    assert plans.PlanKey("union", impl="ref") != plans.PlanKey("union")
    np.testing.assert_array_equal(answers[0], answers[1])


# ------------------------------------------------------------ checkpoints
def test_ref_checkpoint_loads_in_the_jax_package(graph, tmp_path, no_env):
    edges, n = graph
    eng = engine.build(edges, n, HLLConfig(p=6), impl="ref", device="cpu")
    step = eng.save(str(tmp_path / "ck"))
    with open(os.path.join(step, "manifest.json")) as f:
        assert "impl" not in json.load(f)["extra"]
    back = jax_engine.load(str(tmp_path / "ck"))
    assert back.impl == "ref"
    np.testing.assert_array_equal(np.asarray(back.regs)[:n],
                                  eng.regs.numpy()[:n])
    np.testing.assert_allclose(np.asarray(back.degrees()), eng.degrees(),
                               rtol=1e-5)
    again = engine.load(str(tmp_path / "ck"), device="cpu")
    assert again.impl == "cuda"  # the port's default, not the saver's


def test_a_pallas_checkpoint_loads_with_the_callers_impl(graph, tmp_path,
                                                         no_env):
    edges, n = graph
    src = jax_engine.build(edges, n, JaxHLLConfig(p=6), impl="ref",
                           backend="local")
    src.save(str(tmp_path / "ref"))
    # re-hosted under the Pallas impl and saved again: no kernel runs
    pallas = jax_engine.load(str(tmp_path / "ref"), impl="pallas")
    step = pallas.save(str(tmp_path / "pallas"))
    with open(os.path.join(step, "manifest.json")) as f:
        assert json.load(f)["extra"]["impl"] == "pallas"
    for impl, want in ((None, "cuda"), ("ref", "ref"), ("cuda", "cuda")):
        eng = engine.load(str(tmp_path / "pallas"), impl=impl, device="cpu")
        assert eng.impl == want and eng.kernels.impl == want
        np.testing.assert_array_equal(eng.regs.numpy()[:n],
                                      np.asarray(src.regs)[:n])
        np.testing.assert_allclose(eng.degrees(), np.asarray(src.degrees()),
                                   rtol=1e-5)
    with pytest.raises(ValueError, match="pallas"):
        engine.load(str(tmp_path / "pallas"), impl="pallas", device="cpu")
