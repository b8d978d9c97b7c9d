"""Port parity: engine ``merge`` and checkpoints, both directions.

* ``merge`` of engines that each ingested part of the edges equals a
  one-shot build bit for bit, and the JAX reference's ``merge``;
* the port's ``save`` writes the JAX package's format: the reference's
  ``repro.engine.load(path)`` restores it with no overrides, and the
  port's ``engine.load`` restores the reference's checkpoints, including
  one saved by the sharded backend and one with a replica id set.

Registers must be byte-identical and answers from the same registers
identical (same package, same code); answers of the two packages on the
same registers agree to ``rtol=1e-5`` (float32 estimates summed in
another order), as in ``tests/test_torch_engine.py``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.core.ads import ADSConfig as JaxADSConfig  # noqa: E402
from repro.core.hll import HLLConfig as JaxHLLConfig  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.ckpt.checkpoint import FamilyMismatch  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.graph import generators  # noqa: E402

P = 6
FAMILIES = {"hll": (HLLConfig(p=P), JaxHLLConfig(p=P)),
            "ads": (ADSConfig(p=P), JaxADSConfig(p=P))}


@pytest.fixture(scope="module")
def graph():
    return generators.rmat(8, 8, seed=7), 1 << 8


def _port(edges, n, family):
    return engine.build(edges, n, FAMILIES[family][0], device="cpu")


def _jax(edges, n, family, **kw):
    kw.setdefault("backend", "local")
    return jax_engine.build(edges, n, FAMILIES[family][1], impl="ref",
                            layout="byte", family=family, **kw)


def _answers(eng):
    """Each family's main answers, as numpy arrays."""
    if eng.family.name == "ads":
        hist, glob = eng.distance_histogram(2)
        return [np.asarray(eng.degrees()), np.asarray(hist),
                np.asarray(glob), np.asarray(eng.closeness(2))]
    return [np.asarray(eng.degrees()), np.asarray(eng.neighborhood(2)[0])]


def _same_answers(a, b, rtol=0.0):
    for x, y in zip(_answers(a), _answers(b)):
        if rtol:
            np.testing.assert_allclose(x, y, rtol=rtol)
        else:
            np.testing.assert_array_equal(x, y)


def _regs(eng):
    regs = eng.regs
    regs = regs.numpy() if isinstance(regs, torch.Tensor) else np.asarray(regs)
    return regs[: eng.n]


# ------------------------------------------------------------------ merge
@pytest.mark.parametrize("family", ["hll", "ads"])
def test_merge_of_halves_equals_one_shot_build(graph, family):
    edges, n = graph
    left = _port(edges[0::2], n, family)
    right = _port(edges[1::2], n, family)
    version = left.version
    assert left.merge(right) is left
    assert left.version == version + 1
    full = _port(edges, n, family)
    assert torch.equal(left.regs, full.regs)
    _same_answers(left, full)
    np.testing.assert_array_equal(
        left.edges, np.concatenate([edges[0::2], edges[1::2]]))
    assert left.m == len(edges)
    want = _jax(edges[0::2], n, family).merge(_jax(edges[1::2], n, family))
    np.testing.assert_array_equal(_regs(left), _regs(want))
    assert torch.equal(right.regs, _port(edges[1::2], n, family).regs)


def test_merge_refuses_what_does_not_compose(graph):
    edges, n = graph
    hll = _port(edges, n, "hll")
    with pytest.raises(FamilyMismatch, match="(?s)ads.*hll"):
        hll.merge(_port(edges, n, "ads"))
    with pytest.raises(FamilyMismatch, match="(?s)hll.*ads"):
        _port(edges, n, "ads").merge(hll)
    for cfg in (HLLConfig(p=P + 1), HLLConfig(p=P, seed=3),
                HLLConfig(p=P, estimator="beta")):
        with pytest.raises(ValueError, match="config"):
            hll.merge(engine.build(edges, n, cfg, device="cpu"))
    with pytest.raises(ValueError, match="n="):
        hll.merge(engine.build(edges, n + 8, HLLConfig(p=P), device="cpu"))
    with pytest.raises(TypeError):
        hll.merge(object())
    assert torch.equal(hll.regs, _port(edges, n, "hll").regs)  # unchanged


def test_merge_stops_edge_tracking(graph):
    edges, n = graph
    eng = _port(edges[:100], n, "hll")
    bare = engine.LocalEngine.from_regs(
        _port(edges[100:], n, "hll").regs, n, HLLConfig(p=P), device="cpu")
    eng.merge(bare)
    assert eng.edges is None and eng.m == 0
    assert torch.equal(eng.regs, _port(edges, n, "hll").regs)
    with pytest.raises(ValueError, match="without edges"):
        eng.neighborhood(2)
    bare.merge(_port(edges[:100], n, "hll"))
    assert bare.edges is None


def test_merge_drops_the_panel_cache(graph):
    edges, n = graph
    eng = _port(edges[: len(edges) // 2], n, "hll")
    eng.neighborhood(2)
    eng.merge(_port(edges[len(edges) // 2:], n, "hll"))
    assert eng.panels_cached == 0
    np.testing.assert_array_equal(eng.neighborhood(2)[0],
                                  _port(edges, n, "hll").neighborhood(2)[0])


# ------------------------------------------------- port save, port load
@pytest.mark.parametrize("family", ["hll", "ads"])
def test_port_roundtrip_is_bit_identical(graph, tmp_path, family):
    edges, n = graph
    eng = _port(edges, n, family)
    path = eng.save(str(tmp_path / "ck"), step=3)
    assert path.endswith("step_3") and os.path.isdir(path)
    back = engine.load(str(tmp_path / "ck"), device="cpu")
    assert back.family.name == family and back.cfg == eng.cfg
    assert back.n == eng.n and back.m == eng.m
    assert torch.equal(back.regs, eng.regs)
    np.testing.assert_array_equal(back.edges, eng.edges)
    _same_answers(back, eng)


@pytest.mark.parametrize("family", ["hll", "ads"])
def test_port_mid_stream_save_resumes(graph, tmp_path, family):
    edges, n = graph
    half = len(edges) // 2
    eng = engine.open(n, FAMILIES[family][0], device="cpu")
    eng.ingest(edges[:half]).save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), family=family, device="cpu")
    back.ingest(edges[half:])
    full = _port(edges, n, family)
    assert torch.equal(back.regs, full.regs) and back.m == len(edges)
    _same_answers(back, full)


def test_load_picks_the_latest_step(graph, tmp_path):
    edges, n = graph
    _port(edges[:50], n, "hll").save(str(tmp_path), step=1)
    _port(edges, n, "hll").save(str(tmp_path), step=7)
    os.makedirs(tmp_path / ".tmp-step_9")  # a crashed writer's staging
    os.makedirs(tmp_path / "step_8")  # no manifest: not trusted
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert engine.load(str(tmp_path), device="cpu").m == len(edges)
    assert engine.load(str(tmp_path), step=1, device="cpu").m == 50
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        engine.load(str(tmp_path / "missing"), device="cpu")


# ------------------------------------------ across the two packages
@pytest.mark.parametrize("family", ["hll", "ads"])
def test_port_checkpoint_loads_in_jax_without_overrides(graph, tmp_path,
                                                        family):
    edges, n = graph
    eng = _port(edges, n, family)
    eng.save(str(tmp_path / "ck"))
    back = jax_engine.load(str(tmp_path / "ck"))
    assert back.family.name == family and back.backend == "local"
    assert back.impl == "ref" and back.layout == "byte"
    np.testing.assert_array_equal(_regs(back), _regs(eng))
    np.testing.assert_array_equal(np.asarray(back.edges), eng.edges)
    _same_answers(back, _jax(edges, n, family))
    _same_answers(back, eng, rtol=1e-5)


@pytest.mark.parametrize("backend", ["local", "sharded"])
@pytest.mark.parametrize("family", ["hll", "ads"])
def test_jax_checkpoint_loads_in_the_port(graph, tmp_path, family, backend):
    edges, n = graph
    kw = {"shards": 1} if backend == "sharded" else {}
    want = _jax(edges, n, family, backend=backend, **kw)
    want.save(str(tmp_path / "ck"))
    back = engine.load(str(tmp_path / "ck"), device="cpu")
    assert back.family.name == family and back.backend == "local"
    np.testing.assert_array_equal(_regs(back), _regs(want))
    np.testing.assert_array_equal(back.edges, np.asarray(want.edges))
    _same_answers(back, _port(edges, n, family))
    _same_answers(back, want, rtol=1e-5)


def test_replica_ids_cross_both_ways(graph, tmp_path):
    """A replica id set is installed by load, written back, and
    reinstalled by the reference's load."""
    edges, n = graph
    want = _jax(edges, n, "hll")
    want.replicate(np.array([9, 2, 40]))
    want.save(str(tmp_path / "a"))
    back = engine.load(str(tmp_path / "a"), device="cpu")
    np.testing.assert_array_equal(back.replicated_ids, [2, 9, 40])
    _same_answers(back, _port(edges, n, "hll"))
    back.save(str(tmp_path / "b"))
    again = jax_engine.load(str(tmp_path / "b"))
    np.testing.assert_array_equal(again.replicated_ids, [2, 9, 40])
    np.testing.assert_array_equal(_regs(again), _regs(want))


def test_manifest_matches_the_jax_format(graph, tmp_path):
    """The same leaves, shapes and dtypes, and the reference's ``extra``
    keys minus ``impl``."""
    edges, n = graph
    _port(edges, n, "ads").save(str(tmp_path / "port"))
    _jax(edges, n, "ads").save(str(tmp_path / "jax"))
    mine = ckpt.read_manifest(str(tmp_path / "port"), 0)
    with open(tmp_path / "jax" / "step_0" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine["leaves"] == theirs["leaves"]
    assert set(mine["extra"]) == set(theirs["extra"]) - {"impl"}
    assert {k: v for k, v in theirs["extra"].items() if k != "impl"} == \
        mine["extra"]
    for key in mine["leaves"]:
        a = np.load(tmp_path / "port" / "step_0" / f"{key}.npy")
        b = np.load(tmp_path / "jax" / "step_0" / f"{key}.npy")
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- refusals
def test_load_family_mismatch_names_both(graph, tmp_path):
    edges, n = graph
    _port(edges, n, "ads").save(str(tmp_path / "ads"))
    _jax(edges, n, "hll").save(str(tmp_path / "hll"))
    with pytest.raises(FamilyMismatch, match="(?s)'ads'.*'hll'"):
        engine.load(str(tmp_path / "ads"), family="hll", device="cpu")
    with pytest.raises(FamilyMismatch, match="(?s)'hll'.*'ads'"):
        engine.load(str(tmp_path / "hll"), family="ads", device="cpu")
    assert engine.load(str(tmp_path / "ads"), family="ads",
                       device="cpu").family.name == "ads"


def test_packed_checkpoint_loads(graph, tmp_path):
    """A packed checkpoint of the JAX package loads packed, registers bit
    for bit (the packed refusal of earlier slices is gone)."""
    edges, n = graph
    ref = jax_engine.build(edges, n, JaxHLLConfig(p=P), impl="ref",
                           layout="packed")
    ref.save(str(tmp_path))
    back = engine.load(str(tmp_path), device="cpu")
    assert back.layout == "packed" and back.regs.shape[1] == (1 << P) // 2
    np.testing.assert_array_equal(back.regs.numpy(), np.asarray(ref.regs))
    np.testing.assert_array_equal(back.edges, np.asarray(ref.edges))


def test_non_engine_and_view_dtype_checkpoints_raise(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "plain"), 0,
                         {"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not a sketch-engine"):
        engine.load(str(tmp_path / "plain"), device="cpu")
    assert ckpt.manifest_family(None) == "hll"
    # the JAX package stores a bfloat16 leaf as a uint16 view
    path = ckpt.save_checkpoint(str(tmp_path / "view"), 0,
                                {"w": np.zeros(3, np.uint16)})
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["leaves"]["w"]["dtype"] = "bfloat16"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt.restore_checkpoint(str(tmp_path / "view"), 0)


def test_save_is_atomic_and_overwrites(tmp_path):
    tree = {"b": np.arange(4, dtype=np.int64), "a": np.ones((2, 2), np.uint8)}
    ckpt.save_checkpoint(str(tmp_path), 0, tree, extra={"k": 1})
    ckpt.save_checkpoint(str(tmp_path), 0, {"a": np.zeros(1, np.uint8)})
    assert sorted(os.listdir(tmp_path)) == ["step_0"]
    back = ckpt.restore_checkpoint(str(tmp_path), 0)
    assert list(back) == ["a"] and back["a"].tolist() == [0]
    assert "extra" not in ckpt.read_manifest(str(tmp_path), 0)
