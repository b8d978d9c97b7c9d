"""Port parity: the packed 4-bit register layout, helper by helper.

``repro_torch.kernels.packing`` against ``repro.kernels.packing``, and the
packed plain versions of the six HLL kernels (``repro_torch.kernels.ref``
with ``layout="packed"``) against the JAX package's ``ops`` "ref"
registrations on packed panels, over seeded numpy inputs with p in
[4, 16], ragged row counts and register values above the 15 a lane
holds. Tolerances:

* panels, lane placement, saturation, nibble maxima, histograms and zero
  counts exactly equal (integer data);
* harmonic sums ``s`` bit for bit equal to the exact sum (numpy float64
  over the unpacked registers, rounded to float32 once): the port sums
  packed rows exactly in integers. Against the reference ``rtol=1e-6``,
  the byte tests' tolerance: the reference sums XLA's float32 ``exp2``,
  which is off by up to 2.03e-6 relative at integer arguments of 13 and
  more (``tests/test_torch_union.py``), in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import packing as jax_packing  # noqa: E402
from repro_torch.kernels import _build, packing, ref  # noqa: E402
from repro_torch.kernels.hll_accumulate import hll_accumulate  # noqa: E402
from tests._hypothesis_compat import given, settings, st  # noqa: E402

PS = (4, 5, 8, 11, 16)


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes a plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _panel(rng, rows, p, hi=64):
    """uint8[rows, 2^p] over the full 6-bit register domain by default."""
    return rng.integers(0, hi, size=(rows, 1 << p)).astype(np.uint8)


def _packed(rng, rows, p):
    """Arbitrary packed bytes uint8[rows, 2^(p-1)]."""
    return rng.integers(0, 256, size=(rows, 1 << (p - 1))).astype(np.uint8)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- constants
def test_constants_and_row_width_match_reference():
    assert packing.LAYOUTS == jax_packing.LAYOUTS
    assert packing.LANE_BITS == jax_packing.LANE_BITS
    assert packing.LANES_PER_BYTE == jax_packing.LANES_PER_BYTE
    assert packing.SATURATION == jax_packing.SATURATION == 15
    for r in (16, 256, 1 << 16):
        for layout in packing.LAYOUTS:
            assert packing.row_width(r, layout) == jax_packing.row_width(
                r, layout)
    with pytest.raises(ValueError):
        packing.row_width(255, "packed")
    with pytest.raises(ValueError):
        packing.row_width(256, "nibble")
    assert packing.validate_layout("packed") == "packed"
    with pytest.raises(ValueError):
        packing.validate_layout("u4")


def test_split_half_lane_placement():
    """Byte j holds register j (low nibble) and j + r/2 (high nibble)."""
    row = np.arange(8, dtype=np.uint8)[None, :]
    got = packing.pack_rows(_t(row)).numpy()
    want = np.array([[0 | (4 << 4), 1 | (5 << 4), 2 | (6 << 4),
                      3 | (7 << 4)]], np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jax_packing.pack_rows(jnp.asarray(row))))
    np.testing.assert_array_equal(packing.unpack_rows(_t(want)).numpy(), row)


# ------------------------------------------------- pack / unpack identities
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_pack_rows_matches_reference(p, rows):
    """Saturation included: values up to 63 clamp to 15, as in JAX."""
    x = _panel(np.random.default_rng(p * 100 + rows), rows, p)
    got = packing.pack_rows(_t(x)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_packing.pack_rows(jnp.asarray(x))))
    back = packing.unpack_rows(_t(got)).numpy()
    np.testing.assert_array_equal(back, np.minimum(x, packing.SATURATION))


@pytest.mark.parametrize("p", PS)
def test_unpack_rows_matches_reference(p):
    y = _packed(np.random.default_rng(p), 17, p)
    got = packing.unpack_rows(_t(y)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_packing.unpack_rows(jnp.asarray(y))))
    np.testing.assert_array_equal(packing.pack_rows(_t(got)).numpy(), y)


@settings(max_examples=30, deadline=None)
@given(p=st.integers(4, 16), rows=st.integers(1, 9),
       seed=st.integers(0, 2 ** 16))
def test_pack_unpack_identities(p, rows, seed):
    """unpack(pack(x)) == min(x, 15); exact below saturation; pack(unpack(y))
    == y for arbitrary packed bytes."""
    rng = np.random.default_rng(seed)
    x = _panel(rng, rows, p)
    back = packing.unpack_rows(packing.pack_rows(_t(x))).numpy()
    np.testing.assert_array_equal(back, np.minimum(x, 15))
    small = _panel(rng, rows, p, hi=16)
    np.testing.assert_array_equal(
        packing.unpack_rows(packing.pack_rows(_t(small))).numpy(), small)
    y = _packed(rng, rows, p)
    np.testing.assert_array_equal(
        packing.pack_rows(packing.unpack_rows(_t(y))).numpy(), y)


# -------------------------------------------------------------- nibble max
def test_nibble_max_trap():
    """A byte-wise max of 0x10 and 0x01 gives 0x10; the merge is 0x11."""
    a = torch.tensor([[0x10, 0xF0, 0x0F, 0x00]], dtype=torch.uint8)
    b = torch.tensor([[0x01, 0x0F, 0xF0, 0x00]], dtype=torch.uint8)
    assert packing.max_rows(a, b).tolist() == [[0x11, 0xFF, 0xFF, 0x00]]
    assert packing.merge_rows(a, b, "packed").tolist() == [[0x11, 0xFF, 0xFF,
                                                            0x00]]
    assert packing.merge_rows(a, b, "byte").tolist() == [[0x10, 0xF0, 0xF0,
                                                          0x00]]
    assert torch.maximum(a, b).tolist() != packing.max_rows(a, b).tolist()


@pytest.mark.parametrize("p", PS)
def test_max_rows_matches_reference(p):
    rng = np.random.default_rng(p + 5)
    a, b = _packed(rng, 9, p), _packed(rng, 9, p)
    got = packing.max_rows(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_packing.max_rows(
        jnp.asarray(a), jnp.asarray(b))))
    for layout in packing.LAYOUTS:
        np.testing.assert_array_equal(
            packing.merge_rows(_t(a), _t(b), layout).numpy(),
            np.asarray(jax_packing.merge_rows(jnp.asarray(a), jnp.asarray(b),
                                              layout)))


@pytest.mark.parametrize("p", PS)
def test_pack_commutes_with_max(p):
    """Saturation commutes with the merge, for values above 15 too."""
    rng = np.random.default_rng(p + 11)
    a, b = _panel(rng, 9, p), _panel(rng, 9, p)
    merged_packed = packing.max_rows(packing.pack_rows(_t(a)),
                                     packing.pack_rows(_t(b)))
    np.testing.assert_array_equal(
        merged_packed.numpy(),
        packing.pack_rows(torch.maximum(_t(a), _t(b))).numpy())


# -------------------------------------------------------- scatter and convert
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_scatter_max_rows_matches_reference(p, layout):
    rng = np.random.default_rng(p * 3 + len(layout))
    rows = 11
    width = packing.row_width(1 << p, layout)
    regs = rng.integers(0, 256, (rows, width)).astype(np.uint8)
    dst = rng.integers(0, rows, 3 * rows).astype(np.int32)
    dst[:4] = 2  # duplicate destinations
    src_rows = rng.integers(0, 256, (3 * rows, width)).astype(np.uint8)
    got = packing.scatter_max_rows(_t(regs), _t(dst), _t(src_rows), layout)
    want = jax_packing.scatter_max_rows(jnp.asarray(regs), jnp.asarray(dst),
                                        jnp.asarray(src_rows), layout=layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout == "packed":  # the unpacked oracle: scatter, then repack
        full = _t(packing.unpack_rows(_t(regs)).numpy())
        oracle = packing.scatter_max_rows(
            full, _t(dst), packing.unpack_rows(_t(src_rows)), "byte")
        np.testing.assert_array_equal(got.numpy(),
                                      packing.pack_rows(oracle).numpy())


@pytest.mark.parametrize("p", PS)
def test_to_layout_matches_reference(p):
    rng = np.random.default_rng(p + 21)
    x = _panel(rng, 5, p)
    for src, dst in (("byte", "packed"), ("packed", "byte"),
                     ("byte", "byte"), ("packed", "packed")):
        data = x if src == "byte" else _packed(rng, 5, p)
        got = packing.to_layout(_t(data), src, dst).numpy()
        want = np.asarray(jax_packing.to_layout(jnp.asarray(data), src, dst))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        packing.to_layout(_t(x), "byte", "nibble")


# ------------------------------------------- packed plain kernel versions
def _s_close(got, want, regs):
    """``got`` equals the exact sum over unpacked ``regs`` bit for bit and
    the reference's ``want`` to rtol=1e-6."""
    exact = np.exp2(-regs.astype(np.float64)).sum(axis=-1).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _unpack(x):
    return packing.unpack_rows(_t(x)).numpy()


@pytest.mark.parametrize("p", [4, 8, 12])
def test_packed_accumulate_matches_reference(p):
    """Hash, mask parking, clamp to 15 and the nibble scatter-max together
    (``ops.py:77-90``); registers of 16 and above must saturate."""
    from repro.core.hll import HLLConfig as JaxConfig
    rng = np.random.default_rng(p + 40)
    v, e = 37, 5000
    regs = packing.pack_rows(_t(_panel(rng, v, p, hi=20))).numpy()
    rows = rng.integers(0, v, e).astype(np.int32)
    rows[:300] = 3  # many inserts into one row: duplicate registers
    keys = rng.integers(0, 2 ** 32, e, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(e) > 0.2
    want = np.asarray(jax_ops.accumulate(
        jnp.asarray(regs), jnp.asarray(rows), jnp.asarray(keys),
        JaxConfig(p=p, seed=5), mask=jnp.asarray(mask), impl="ref",
        layout="packed"))
    got = hll_accumulate(_t(regs.copy()), _t(rows), _t(keys), _t(mask), p=p,
                         seed=5, layout="packed")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [4, 8, 12])
def test_packed_accumulate_ref_saturates(p):
    """Direct inserts with rho above 15: the lane keeps 15, the neighbour
    nibble is untouched."""
    w = 1 << (p - 1)
    regs = torch.zeros((2, w), dtype=torch.uint8)
    regs[1, 0] = 0x30  # register w of row 1 holds 3
    rows = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    buckets = torch.tensor([0, 0, w + 1, w - 1], dtype=torch.int32)
    rhos = torch.tensor([20, 7, 9, 0], dtype=torch.uint8)
    ref.hll_accumulate_ref(regs, rows, buckets, rhos, layout="packed")
    full = packing.unpack_rows(regs)
    assert int(full[1, 0]) == 15 and int(full[1, w]) == 3
    assert int(full[1, w + 1]) == 9 and int(full[0].sum()) == 0


@pytest.mark.parametrize("p", [4, 8, 12])
def test_packed_propagate_matches_reference(p):
    rng = np.random.default_rng(p + 50)
    v, e = 60, 700
    regs = _packed(rng, v, p)
    regs[rng.random(v) < 0.3] = 0
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[::9] = src[::9]
    mask = rng.random(e) > 0.1
    want = np.asarray(jax_ops.propagate(
        jnp.asarray(regs), jnp.asarray(src), jnp.asarray(dst),
        mask=jnp.asarray(mask), impl="ref", layout="packed"))
    got = ref.hll_propagate_ref(_t(regs), _t(src), _t(dst), _t(mask),
                                layout="packed")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [4, 8, 9, 12, 16])
@pytest.mark.parametrize("n", [1, 45])
def test_packed_estimate_matches_reference(p, n):
    rng = np.random.default_rng(p * 10 + n)
    regs = _packed(rng, n, p)
    regs[: n // 3] = 0
    s_w, z_w = jax_ops._estimate_stats_ref(jnp.asarray(regs), layout="packed")
    s, z = ref.hll_estimate_ref(_t(regs), layout="packed")
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_w))
    _s_close(s.numpy(), np.asarray(s_w), _unpack(regs))
    empty = (regs == 0).all(axis=1)
    assert (s.numpy()[empty] == float(1 << p)).all()


@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("lanes", [1, 9])
def test_packed_union_matches_reference(p, lanes):
    rng = np.random.default_rng(p + lanes)
    v, b = 50, 23
    regs = _packed(rng, v, p)
    regs[0] = 0xFF  # a masked lane that read its padding id would show
    ids = rng.integers(0, v, (b, lanes)).astype(np.int32)
    lens = rng.integers(0, lanes + 1, b)
    lens[::5] = 0
    mask = np.arange(lanes)[None, :] < lens[:, None]
    ids[~mask] = 0
    s_w, z_w = jax_ops._union_estimate_ref(
        jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(mask),
        layout="packed")
    s, z = ref.union_estimate_ref(_t(regs), _t(ids), _t(mask),
                                  layout="packed")
    np.testing.assert_array_equal(z.numpy(), np.asarray(z_w))
    merged = np.where(mask[:, :, None], _unpack(regs)[ids], 0).max(axis=1)
    _s_close(s.numpy(), np.asarray(s_w), merged)


@pytest.mark.parametrize("p", [4, 8, 12])
def test_packed_intersection_stats_match_reference(p):
    rng = np.random.default_rng(p + 70)
    v, b, q = 40, 31, 64 - p
    regs = _packed(rng, v, p)
    pa = rng.integers(0, v, b).astype(np.int32)
    pb = rng.integers(0, v, b).astype(np.int32)
    pb[::4] = pa[::4]
    st_w, sz_w = jax_ops._intersection_stats_ref(
        jnp.asarray(regs), jnp.asarray(pa), jnp.asarray(pb), q,
        layout="packed")
    st_, sz = ref.intersection_stats_ref(_t(regs), _t(pa), _t(pb), q,
                                         layout="packed")
    np.testing.assert_array_equal(st_.numpy(), np.asarray(st_w))
    assert float(st_[:, :, 16:].abs().sum()) == 0  # bins 16..q+1 empty
    np.testing.assert_array_equal(sz[..., 1].numpy(),
                                  np.asarray(sz_w)[..., 1])
    a, c = _unpack(regs)[pa], _unpack(regs)[pb]
    _s_close(sz[..., 0].numpy(), np.asarray(sz_w)[..., 0],
             np.stack([a, c, np.maximum(a, c)], axis=1))


@pytest.mark.parametrize("p", [4, 8, 12])
def test_packed_ertl_stats_match_reference(p):
    rng = np.random.default_rng(p + 80)
    e, q = 29, 64 - p
    a, b = _packed(rng, e, p), _packed(rng, e, p)
    b[::3] = a[::3]
    want = np.asarray(jax_ops._ertl_stats_ref(jnp.asarray(a), jnp.asarray(b),
                                              q, layout="packed"))
    got = ref.ertl_stats_ref(_t(a), _t(b), q, layout="packed")
    np.testing.assert_array_equal(got.numpy(), want)
    # the byte version on the unpacked rows gives the same histograms
    np.testing.assert_array_equal(
        got.numpy(), ref.ertl_stats_ref(packing.unpack_rows(_t(a)),
                                        packing.unpack_rows(_t(b)), q).numpy())
