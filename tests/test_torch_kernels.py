"""Port parity: the plain versions of the four main-path kernels.

Each plain PyTorch version (what a wrapper runs for a CPU tensor) is held
against the JAX package's plain reference, ``repro/kernels/ref.py`` and
the ``ops`` "ref" registrations, on the same numpy inputs. Tolerances:

* register panels (accumulate, propagate) byte-identical;
* zero counts and Eq. 19 histograms exactly equal (integer counts);
* harmonic sums ``s`` to ``rtol=1e-6``, the tolerance
  ``tests/test_kernels.py`` holds the JAX kernels to: float32 sums of the
  same exact terms taken in another order.

The CUDA kernels themselves cannot run without a card; ``chip_smoke.py``
holds them against these plain versions on the H100.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hll as jax_hll  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.hll_accumulate import hll_accumulate  # noqa: E402
from repro_torch.kernels.hll_estimate import hll_estimate_stats  # noqa: E402
from repro_torch.kernels.hll_propagate import hll_propagate  # noqa: E402
from repro_torch.kernels.intersection_stats import (  # noqa: E402
    intersection_stats)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes a plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _panel(rng, v, p, hi=30):
    return rng.integers(0, hi, size=(v, 1 << p)).astype(np.uint8)


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("e", [1, 100, 3000])
def test_accumulate_ref_matches_jax(p, e):
    rng = np.random.default_rng(p * 7 + e)
    v = 40
    regs = _panel(rng, v, p)
    rows = rng.integers(0, v, e).astype(np.int32)
    buckets = rng.integers(0, 1 << p, e).astype(np.int32)
    rhos = rng.integers(0, 60, e).astype(np.uint8)
    want = np.asarray(jax_ref.hll_accumulate_ref(
        jnp.asarray(regs), rows, buckets, rhos))
    got = ref.hll_accumulate_ref(torch.from_numpy(regs.copy()),
                                 torch.from_numpy(rows),
                                 torch.from_numpy(buckets),
                                 torch.from_numpy(rhos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,seed", [(8, 0), (10, 3)])
def test_accumulate_wrapper_matches_jax_ops(p, seed):
    """Hash, mask parking and scatter-max together (``ops.py:77-87``)."""
    rng = np.random.default_rng(p + seed)
    v, e = 64, 2048
    regs = np.zeros((v, 1 << p), np.uint8)
    rows = rng.integers(0, v, e).astype(np.int32)
    keys = rng.integers(0, 2 ** 32, e, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(e) > 0.25
    want = np.asarray(jax_ops.accumulate(
        jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(keys),
        JaxConfig(p=p, seed=seed), mask=jnp.asarray(mask), impl="ref"))
    panel = torch.from_numpy(regs.copy())
    out = ops.accumulate(panel, torch.from_numpy(rows), torch.from_numpy(keys),
                         HLLConfig(p=p, seed=seed), mask=torch.from_numpy(mask))
    assert out is panel  # updated in place, as the JAX path donates it
    np.testing.assert_array_equal(out.numpy(), want)


def test_accumulate_masked_edges_are_no_ops():
    """Masked edges never touch the panel, whatever row they name."""
    cfg = HLLConfig(p=6)
    regs = torch.zeros((8, cfg.r), dtype=torch.uint8)
    rows = torch.tensor([3, 5, 7], dtype=torch.int32)
    keys = torch.tensor([11, 12, 13], dtype=torch.uint32)
    mask = torch.zeros(3, dtype=torch.bool)
    hll_accumulate(regs, rows, keys, mask, p=cfg.p)
    assert int(regs.sum()) == 0


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("v,e", [(8, 5), (64, 700)])
def test_propagate_ref_matches_jax(p, v, e):
    rng = np.random.default_rng(p * 13 + v + e)
    regs = _panel(rng, v, p)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    mask = rng.random(e) > 0.3
    want = np.asarray(jax_ref.hll_propagate_ref(
        jnp.asarray(regs), src, dst, jnp.asarray(mask)))
    got = ref.hll_propagate_ref(torch.from_numpy(regs), torch.from_numpy(src),
                                torch.from_numpy(dst), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_propagate_wrapper_matches_jax_ops_with_padding():
    """Slots routed (0, 0) are no-ops, as the JAX package's masked slots
    (``ops.py:178-180``): the port's routing of the live slots with the
    masked ones parked on (0, 0) gives the JAX masked pass."""
    rng = np.random.default_rng(5)
    v, e = 32, 200
    regs = _panel(rng, v, 8)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    mask = rng.random(e) > 0.5
    want = np.asarray(jax_ops.propagate(
        jnp.asarray(regs), jnp.asarray(src), jnp.asarray(dst),
        mask=jnp.asarray(mask), impl="ref"))
    panel = torch.from_numpy(regs)
    parked = [torch.from_numpy(np.where(mask, x, 0).astype(np.int32))
              for x in (src, dst)]
    got = ops.propagate(panel, *parked)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(panel.numpy(), regs)  # input untouched


def _any_order_routing(rng, v, e, case):
    """(src, dst, mask) numpy routing of e edges over v rows: "mask" is
    dst-sorted with a mask, "unsorted" in random order with none, "both"
    in random order with a mask."""
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if case == "mask":
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    mask = None if case == "unsorted" else rng.random(e) > 0.4
    return src, dst, mask


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("case", ["mask", "unsorted", "both"])
def test_ops_propagate_any_order_and_mask_matches_jax_ops(layout, case):
    """``ops.propagate`` with a mask and/or an unsorted ``dst`` equals the
    JAX package's ``ops.propagate(..., impl="ref")`` byte for byte."""
    from repro_torch.kernels import packing
    rng = np.random.default_rng(len(case) + 17 * (layout == "packed"))
    v, e, p = 40, 600, 6
    regs = _panel(rng, v, p, hi=20 if layout == "packed" else 30)
    if layout == "packed":
        regs = packing.pack_rows(torch.from_numpy(regs)).numpy()
    src, dst, mask = _any_order_routing(rng, v, e, case)
    want = np.asarray(jax_ops.propagate(
        jnp.asarray(regs), jnp.asarray(src), jnp.asarray(dst),
        mask=None if mask is None else jnp.asarray(mask), impl="ref",
        layout=layout))
    got = ops.propagate(torch.from_numpy(regs), torch.from_numpy(src),
                        torch.from_numpy(dst),
                        None if mask is None else torch.from_numpy(mask),
                        layout=layout)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, regs)


def test_propagate_reads_the_frozen_panel():
    """On the path 0-1-2, one pass reaches one hop only.

    An in-place merge that processed edge (1 -> 0) after (2 -> 1) would
    carry vertex 2's register into vertex 0 within a single pass.
    """
    regs = torch.zeros((4, 16), dtype=torch.uint8)
    regs[2, 5] = 9  # only vertex 2 holds anything
    src = torch.tensor([2, 1], dtype=torch.int32)  # 2 -> 1, then 1 -> 0
    dst = torch.tensor([1, 0], dtype=torch.int32)
    one = hll_propagate(regs, src, dst)
    assert int(one[1, 5]) == 9 and int(one[0, 5]) == 0
    two = hll_propagate(one, src, dst)
    assert int(two[0, 5]) == 9


@pytest.mark.parametrize("p", [4, 8, 10])
@pytest.mark.parametrize("n", [1, 37, 300])
def test_estimate_ref_matches_jax(p, n):
    rng = np.random.default_rng(p * 3 + n)
    regs = _panel(rng, n, p, hi=66)
    s_j, z_j = jax_ref.hll_estimate_ref(jnp.asarray(regs), 0.0)
    out = hll_estimate_stats(torch.from_numpy(regs))
    assert out.shape == (n, 2) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(s_j), rtol=1e-6)
    np.testing.assert_array_equal(out[:, 1].numpy(), np.asarray(z_j))


@pytest.mark.parametrize("p", [6, 8])
def test_estimate_flajolet_matches_jax_ops(p):
    rng = np.random.default_rng(p)
    regs = _panel(rng, 50, p, hi=12)
    regs[:10] = 0  # empty and sparse rows take linear counting
    regs[10:20] = np.where(rng.random((10, 1 << p)) < 0.9, 0, regs[10:20])
    want = np.asarray(jax_ops.estimate(jnp.asarray(regs), JaxConfig(p=p),
                                       impl="ref"))
    got = ops.estimate(torch.from_numpy(regs), HLLConfig(p=p))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("p", [6, 8])
def test_estimate_beta_matches_jax_ops(p):
    """LogLogBeta from the estimate kernel's (s, z) equals what the JAX
    engine's beta path computes per register (``hll.estimate``), to
    ``rtol=1e-4``: XLA's CPU ``log`` and powers are approximate (about
    1e-6 relative), and the degree-7 polynomial in ``log(z + 1)``, whose
    terms alternate in sign, amplifies that for sparse rows at p=6."""
    rng = np.random.default_rng(p + 100)
    regs = _panel(rng, 50, p, hi=12)
    regs[:10] = 0
    regs[10:20] = np.where(rng.random((10, 1 << p)) < 0.9, 0, regs[10:20])
    want = np.asarray(jax_hll.estimate(jnp.asarray(regs),
                                       JaxConfig(p=p, estimator="beta")))
    got = ops.estimate(torch.from_numpy(regs),
                       HLLConfig(p=p, estimator="beta"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("v,b", [(8, 1), (64, 65), (32, 128)])
def test_intersection_stats_ref_matches_jax(p, v, b):
    """Values up to 69 include bytes above q + 1, which count in no bin."""
    rng = np.random.default_rng(p * 53 + v + b)
    regs = _panel(rng, v, p, hi=70)
    pairs = rng.integers(0, v, size=(b, 2)).astype(np.int32)
    q = 64 - p
    st_j, sz_j = jax_ref.intersection_stats_ref(
        jnp.asarray(regs), pairs[:, 0], pairs[:, 1], q)
    st_t, sz_t = intersection_stats(torch.from_numpy(regs),
                                    torch.from_numpy(pairs[:, 0].copy()),
                                    torch.from_numpy(pairs[:, 1].copy()), q)
    assert st_t.shape == (b, 5, q + 2) and sz_t.shape == (b, 3, 2)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(sz_t[:, :, 0].numpy(), np.asarray(sz_j)[:, :, 0],
                               rtol=1e-6)
    np.testing.assert_array_equal(sz_t[:, :, 1].numpy(),
                                  np.asarray(sz_j)[:, :, 1])


def test_intersection_stats_chunks_agree():
    """More pairs than one chunk of the plain version: chunking is exact."""
    rng = np.random.default_rng(9)
    regs = torch.from_numpy(_panel(rng, 16, 4))
    pairs = torch.from_numpy(rng.integers(0, 16, (ref.PAIR_CHUNK + 3, 2))
                             .astype(np.int32))
    st, sz = ops.intersection_stats(regs, pairs, HLLConfig(p=4))
    tail = slice(ref.PAIR_CHUNK - 2, None)
    st2, sz2 = ops.intersection_stats(regs, pairs[tail].contiguous(),
                                      HLLConfig(p=4))
    np.testing.assert_array_equal(st[tail].numpy(), st2.numpy())
    np.testing.assert_array_equal(sz[tail].numpy(), sz2.numpy())


def test_padded_pairs_gather_row_zero():
    """Padding pairs (0, 0) read row 0's sketch against itself."""
    cfg = HLLConfig(p=6)
    regs = torch.zeros((4, cfg.r), dtype=torch.uint8)
    regs[0, :3] = 2
    pairs = torch.zeros((2, 2), dtype=torch.int32)
    st, sz = ops.intersection_stats(regs, pairs, cfg)
    assert float(st[0, 4, 2]) == 3 and float(st[0, 4, 0]) == cfg.r - 3
    assert float(st[0, :4].sum()) == 0  # no a<b / a>b registers
    assert float(sz[0, 0, 1]) == float(sz[0, 2, 1]) == cfg.r - 3


@pytest.mark.parametrize("fn,args", [
    (hll_estimate_stats, ()),
    (hll_propagate, ("ids", "ids")),
])
def test_wrappers_reject_packed_layout(fn, args):
    """A packed row must be a power of two >= 8 bytes (r >= 16, p >= 4),
    for the kernels' word reads; a narrower packed panel and an unknown
    layout raise."""
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="packed row width 4"):
        fn(torch.zeros((8, 4), dtype=torch.uint8), *(ids for _ in args),
           layout="packed")
    with pytest.raises(ValueError, match="layout"):
        fn(torch.zeros((8, 16), dtype=torch.uint8), *(ids for _ in args),
           layout="nibble")


def test_wrappers_check_dtypes_and_shapes():
    regs = torch.zeros((8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        hll_estimate_stats(regs.to(torch.int32))
    with pytest.raises(ValueError):
        hll_propagate(regs, torch.zeros(3, dtype=torch.int64),
                      torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        hll_accumulate(regs, torch.zeros(2, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.uint32),
                       torch.ones(2, dtype=torch.bool), p=4)
    with pytest.raises(ValueError):
        hll_accumulate(regs, torch.zeros(2, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.uint32),
                       torch.ones(2, dtype=torch.bool), p=5)  # r != 2^p
    with pytest.raises(ValueError, match="power of two >= 8"):
        hll_estimate_stats(torch.zeros((8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="aligned"):
        hll_estimate_stats(torch.zeros(8 * 16 + 1, dtype=torch.uint8)[1:]
                           .view(8, 16))
