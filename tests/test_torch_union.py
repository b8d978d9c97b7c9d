"""Port parity: union queries — the ``union_estimate_stats`` kernel's plain
version, ``union_size`` and ``query_batch`` — against the JAX reference
(``repro/kernels/ref.py`` and engines with ``impl="ref"``; the Pallas
union body does not run on this JAX, ROADMAP Queue C).

Tolerances and why:

* zero counts ``z`` exact (integer counts); harmonic sums ``s`` to
  ``rtol=1e-6``: float32 sums of the same exact terms in another order,
  as in ``tests/test_torch_kernels.py``. XLA's CPU ``exp2`` is off by up
  to 2e-6 relative for exponents of 13 and more, where the port builds
  ``2^-x`` exactly, so panels with registers that high are held against
  exact float64 sums instead of JAX's;
* Flajolet union estimates to ``rtol=1e-5``, as degrees in
  ``tests/test_torch_engine.py``; LogLogBeta to ``1e-4``, because XLA's
  CPU log and pow are approximate and the degree-7 beta polynomial
  amplifies it (``test_estimate_beta_matches_jax_ops``);
* ``query_batch`` equals the same engine's per-kind calls bit for bit
  (``np.array_equal``); against JAX it keeps the per-kind tolerances
  (intersection ``ie`` 1e-5 of the estimates' scale, ``mle`` 1e-4 of
  its value alone).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jax_engine  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine import convert, plans  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import _build, ops, union_estimate  # noqa: E402

ITERS = 10
CASES = [(8, 8, 0), (9, 4, 1), (8, 12, 2)]  # (rmat scale, p, seed)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes a plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _sets_panel(rng, v, b, lanes):
    """Ragged (ids, mask) with fully masked rows and duplicate ids."""
    ids = rng.integers(0, v, (b, lanes)).astype(np.int32)
    lens = rng.integers(0, lanes + 1, b)
    lens[:: 5] = 0  # fully masked rows
    mask = np.arange(lanes)[None, :] < lens[:, None]
    if lanes > 1:
        ids[1::3, 1] = ids[1::3, 0]  # duplicates inside a set
    ids[~mask] = 0  # padding slots name row 0, as pad_sets leaves them
    return ids, mask


@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("b,lanes", [(1, 1), (37, 8), (64, 64)])
@pytest.mark.parametrize("hi", [13, 66])
def test_union_estimate_plain_matches_jax_ref(p, b, lanes, hi):
    rng = np.random.default_rng(p * 1000 + b + lanes + hi)
    v = 60
    regs = rng.integers(0, hi, (v, 1 << p)).astype(np.uint8)
    regs[0] = hi - 1  # heavy row 0: a padding slot merging it would show
    ids, mask = _sets_panel(rng, v, b, lanes)
    s_j, z_j = (np.asarray(x) for x in jax_ref.union_estimate_ref(
        jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(mask)))
    got = union_estimate.union_estimate_stats(
        torch.from_numpy(regs), torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (b, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 1].numpy(), z_j)
    merged = np.where(mask[:, :, None], regs[ids], 0).max(axis=1)
    exact = np.exp2(-merged.astype(np.float64)).sum(axis=1)
    np.testing.assert_allclose(got[:, 0].numpy(), exact if hi > 13 else s_j,
                               rtol=1e-6, atol=0)
    empty = ~mask.any(axis=1)
    np.testing.assert_array_equal(got[empty].numpy(),
                                  np.full((empty.sum(), 2), 1 << p, np.float32))


def test_union_plain_chunks_agree(monkeypatch):
    """The chunked plain version gives the same bits at any chunk size."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(5)
    regs = torch.from_numpy(rng.integers(0, 30, (40, 64)).astype(np.uint8))
    ids, mask = (torch.from_numpy(x) for x in _sets_panel(rng, 40, 50, 16))
    whole = union_estimate.plain(regs, ids, mask)
    monkeypatch.setattr(ref, "UNION_CHUNK_BYTES", 3 * 16 * 64)
    assert torch.equal(union_estimate.plain(regs, ids, mask), whole)


@pytest.mark.parametrize("estimator,rtol", [("flajolet", 1e-5),
                                            ("beta", 1e-4)])
def test_union_estimate_ops_matches_jax(estimator, rtol):
    rng = np.random.default_rng(7)
    regs = rng.integers(0, 25, (50, 256)).astype(np.uint8)
    ids, mask = _sets_panel(rng, 50, 40, 16)
    want = np.asarray(jax_ops.union_estimate(
        jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(mask),
        JaxConfig(p=8, estimator=estimator), impl="ref"))
    got = ops.union_estimate(torch.from_numpy(regs), torch.from_numpy(ids),
                             torch.from_numpy(mask),
                             HLLConfig(p=8, estimator=estimator))
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=1e-6)


def test_union_wrapper_checks_inputs():
    regs = torch.zeros((8, 16), dtype=torch.uint8)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    mask = torch.ones((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        union_estimate.union_estimate_stats(regs, ids.long(), mask)
    with pytest.raises(ValueError):
        union_estimate.union_estimate_stats(regs, ids, mask[:, :2])
    with pytest.raises(ValueError):
        union_estimate.union_estimate_stats(regs, ids[:, :0], mask[:, :0])
    with pytest.raises(ValueError, match="packed"):  # packed r=8 < 16
        union_estimate.union_estimate_stats(regs[:, :4].contiguous(), ids,
                                            mask, layout="packed")


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"rmat{c[0]}-p{c[1]}")
def pair(request):
    """(JAX reference engine, port engine on the CPU built from its numpy
    state, edges, n, rng)."""
    scale, p, seed = request.param
    edges, n = generators.rmat(scale, 8, seed=seed), 1 << scale
    ref = jax_engine.build(edges, n, JaxConfig(p=p), impl="ref",
                           layout="byte", backend="local")
    cfg = ref.cfg
    port = convert.from_numpy_state(
        np.asarray(ref.regs), n,
        {"p": cfg.p, "seed": cfg.seed, "estimator": cfg.estimator}, edges,
        device="cpu")
    return ref, port, edges, n, np.random.default_rng(seed)


def _ragged(rng, n, count, longest):
    return [rng.integers(0, n, rng.integers(1, longest + 1))
            for _ in range(count)]


def test_union_size_matches_jax(pair):
    ref, port, _, n, rng = pair
    one = rng.integers(0, n, 9)
    got = port.union_size(one)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, float(ref.union_size(one)), rtol=1e-5)
    ragged = _ragged(rng, n, 21, 40)
    got = port.union_size(ragged)
    assert got.shape == (21,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref.union_size(ragged)),
                               rtol=1e-5)
    rect = rng.integers(0, n, (13, 5)).astype(np.uint16)
    np.testing.assert_allclose(port.union_size(rect),
                               np.asarray(ref.union_size(rect)), rtol=1e-5)


def test_union_of_one_vertex_is_its_degree(pair):
    _, port, _, n, _ = pair
    got = port.union_size([np.array([v]) for v in range(n)])
    np.testing.assert_allclose(got, port.degrees(), rtol=1e-6)


def test_empty_set_is_zero(pair):
    ref, port, *_ = pair
    sets = [np.array([], np.int64), np.array([3, 4])]
    got = port.union_size(sets)
    assert got[0] == 0.0
    np.testing.assert_allclose(got, np.asarray(ref.union_size(sets)),
                               rtol=1e-5)


def test_union_rejects_bad_ids(pair):
    _, port, _, n, _ = pair
    for bad in (np.array([0, n]), np.array([-1, 2]), [np.array([1]),
                                                      np.array([n + 7])],
                np.array([0.5, 2.0]), [np.array([1.0])],
                np.zeros((2, 2, 2), np.int64), []):
        with pytest.raises(ValueError):
            port.union_size(bad)


def test_pad_sets_masks_padding():
    sets, scalar = plans.split_sets([np.array([5, 6, 7]), np.array([2])], 10)
    assert not scalar
    ids, mask = plans.pad_sets(sets)
    assert ids.shape == (8, 8) and ids.dtype == np.int32
    assert mask.sum() == 4 and mask[0, :3].all() and mask[1, 0]
    assert (ids[~mask] == 0).all()
    ids2, mask2, n_real, scalar2 = plans.normalize_sets(np.arange(9), 10)
    assert ids2.shape == (8, 16) and n_real == 1 and scalar2
    assert mask2[0].sum() == 9


@pytest.mark.parametrize("method,rtol", [("ie", 1e-5), ("mle", 1e-4)])
def test_query_batch_equals_per_kind_and_jax(pair, method, rtol):
    ref, port, edges, n, rng = pair
    sets = _ragged(rng, n, 19, 30)
    pairs = edges[rng.choice(len(edges), 33, replace=False)]
    got = port.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                           method=method, iters=ITERS)
    assert set(got) == {"degrees", "union", "intersection"}
    assert np.array_equal(got["degrees"], port.degrees())
    assert np.array_equal(got["union"], port.union_size(sets))
    assert np.array_equal(got["intersection"], port.intersection_size(
        pairs, method=method, iters=ITERS))
    want = ref.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                           method=method, iters=ITERS)
    np.testing.assert_allclose(got["degrees"], want["degrees"], rtol=1e-5)
    np.testing.assert_allclose(got["union"], want["union"], rtol=1e-5)
    deg = np.asarray(ref.degrees())
    scale = (deg[pairs[:, 0]] + deg[pairs[:, 1]]
             + np.asarray(ref.union_size([list(pr) for pr in pairs])))
    if method == "mle":  # held to its value alone (measured worst 1.1e-5)
        scale = 0.0
    w = np.asarray(want["intersection"])
    assert np.all(np.abs(got["intersection"] - w)
                  <= rtol * (np.abs(w) + scale))


def test_query_batch_single_kinds(pair):
    _, port, edges, n, rng = pair
    sets = _ragged(rng, n, 3, 5)
    assert port.query_batch() == {}
    only = port.query_batch(vertex_sets=sets)
    assert set(only) == {"union"}
    assert np.array_equal(only["union"], port.union_size(sets))
    only = port.query_batch(pairs=edges[:4], method="ie")
    assert set(only) == {"intersection"}
    assert np.array_equal(only["intersection"],
                          port.intersection_size(edges[:4], method="ie"))
    with pytest.raises(ValueError):
        port.query_batch(pairs=edges[:4], method="exact")
    with pytest.raises(ValueError):
        port.query_batch(degrees=True, vertex_sets=[np.array([n])])


def test_degree_sketch_union_matches_jax():
    from repro.core import degreesketch as jax_dsk
    from repro_torch.core import degreesketch as dsk
    edges, n = generators.rmat(8, 8, seed=4), 1 << 8
    ref = jax_engine.build(edges, n, JaxConfig(p=8), impl="ref",
                           layout="byte", backend="local")
    regs = np.array(ref.regs)
    jsk = jax_dsk.DegreeSketch(regs=jnp.asarray(regs), n=n, cfg=ref.cfg)
    sk = dsk.DegreeSketch(regs=torch.from_numpy(regs), n=n, cfg=HLLConfig(p=8))
    xs = np.array([3, 17, 40, 41, 200])
    np.testing.assert_allclose(float(sk.union_size(xs)),
                               float(jsk.union_size(jnp.asarray(xs))),
                               rtol=1e-5)
    np.testing.assert_allclose(sk.degrees().numpy(),
                               np.asarray(jsk.degrees()), rtol=1e-5)
