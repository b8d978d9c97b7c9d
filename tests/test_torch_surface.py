"""The port's public surface against the JAX package's: names the
reference exports and the README names.

* ``repro_torch.engine.UnsupportedQuery`` is the class the engine raises,
  and a query kind the ADS family does not serve raises it, as the JAX
  engine raises its own for the same call;
* ``kernels.registry``'s ``OPS``, ``LAYOUTS``, ``families()`` and the
  family protocol ``SketchFamily`` equal the reference's. The port has
  no ``register_family`` (ROADMAP, conventions): its families' ops are
  branches of ``kernels.ops``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import engine as jax_engine  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.engine import base  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402


def _graph():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 40, (120, 2)).astype(np.int32)
    return edges[edges[:, 0] != edges[:, 1]], 40


def test_unsupported_query_is_exported():
    assert engine.UnsupportedQuery is base.UnsupportedQuery
    assert "UnsupportedQuery" in engine.__all__
    assert issubclass(engine.UnsupportedQuery, ValueError)
    assert "UnsupportedQuery" in jax_engine.__all__


@pytest.mark.parametrize("kind", ["intersection_size", "union_size"])
def test_ads_engine_raises_unsupported_query(kind):
    """An HLL-only kind on an ADS engine raises UnsupportedQuery in both
    packages, before any kernel runs."""
    edges, n = _graph()
    arg = edges[:4] if kind == "intersection_size" else [[0, 1], [2]]
    port = engine.build(edges, n, family="ads", device="cpu")
    with pytest.raises(engine.UnsupportedQuery):
        getattr(port, kind)(arg)
    ref = jax_engine.build(edges, n, family="ads", impl="ref")
    with pytest.raises(jax_engine.UnsupportedQuery):
        getattr(ref, kind)(arg)


def test_registry_names_match_the_reference():
    assert registry.OPS == jax_registry.OPS
    assert registry.LAYOUTS == jax_registry.LAYOUTS
    assert registry.families() == jax_registry.families() == ["ads", "hll"]
    for name in ("OPS", "LAYOUTS", "SketchFamily", "families", "family",
                 "family_of"):
        assert name in registry.__all__ and name in jax_registry.__all__
    assert not hasattr(registry, "register_family")


@pytest.mark.parametrize("name", ["hll", "ads"])
def test_families_follow_the_protocol(name):
    """Each family is a SketchFamily with the reference's coordinates."""
    fam, ref = registry.family(name), jax_registry.family(name)
    assert isinstance(fam, registry.SketchFamily)
    assert fam.name == ref.name == name
    assert tuple(fam.ops) == tuple(ref.ops)
    assert tuple(fam.layouts) == tuple(ref.layouts)
    assert tuple(fam.query_kinds) == tuple(ref.query_kinds)
    assert registry.family_of(fam.default_config()) is fam
