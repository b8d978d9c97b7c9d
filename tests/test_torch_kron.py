"""Port parity: the Kronecker tools (``graph.generators`` factors and
products, ``graph.exact.kron_edge_triangles``) against the JAX package's.

Pure numpy on both sides: the same names and seeds must give the same
arrays, and the O(m) Kronecker triangle formula must equal the
adjacency-intersection counts (``exact_edge_triangles``) on every named
power.
"""
import numpy as np
import pytest

from repro.graph import exact as jax_exact
from repro.graph import generators as jax_gen
from repro_torch.graph import exact, generators

NAMES = ["wheel16", "clique8", "community24", "grid6"]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", NAMES)
def test_named_factor_matches_jax(name, seed):
    got, n = generators.named_factor(name, seed)
    want, n_want = jax_gen.named_factor(name, seed)
    assert n == n_want and got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_named_factor_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="unknown factor"):
        generators.named_factor("torus9")


@pytest.mark.parametrize("name", NAMES)
def test_kronecker_power_matches_jax(name):
    got, n = generators.kronecker_power(name, seed=1)
    want, n_want = jax_gen.kronecker_power(name, seed=1)
    assert n == n_want
    np.testing.assert_array_equal(got, want)


def test_kronecker_edges_of_two_factors_match_jax():
    f1, n1 = generators.named_factor("wheel16")
    f2, n2 = generators.named_factor("community24", seed=2)
    r1 = generators.rmat(5, 4, seed=7)
    for a, na, b, nb in ((f1, n1, f2, n2), (f2, n2, f1, n1),
                         (r1, 32, f1, n1)):
        got = generators.kronecker_edges(a, na, b, nb)
        np.testing.assert_array_equal(
            got, jax_gen.kronecker_edges(a, na, b, nb))
        assert got.max() < na * nb and np.all(got[:, 0] < got[:, 1])


@pytest.mark.parametrize("name", NAMES)
def test_kron_edge_triangles_match_jax_and_exact(name):
    f, nf = generators.named_factor(name)
    ke, n = generators.kronecker_power(name)
    got = exact.kron_edge_triangles(f, nf, ke)
    assert got.dtype == np.int64 and got.shape == (len(ke),)
    np.testing.assert_array_equal(got, jax_exact.kron_edge_triangles(f, nf,
                                                                     ke))
    np.testing.assert_array_equal(got, exact.exact_edge_triangles(n, ke))


def test_kron_edge_triangles_of_an_rmat_factor():
    """The smoke's construction, cut to an RMAT scale-5 factor: the formula
    equals the adjacency counts, and the global count is a third of it."""
    f = generators.rmat(5, 8, seed=0)
    ke = generators.kronecker_edges(f, 32, f, 32)
    got = exact.kron_edge_triangles(f, 32, ke)
    truth = exact.exact_edge_triangles(32 * 32, ke)
    np.testing.assert_array_equal(got, truth)
    assert exact.exact_global_triangles(32 * 32, ke, got) == got.sum() // 3
