"""The CUDA kernels against their plain versions, on the card.

These need a CUDA card and ``nvcc``; without a card each test skips with
the reason (decided inside the fixture, never at import). On a machine
with one, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest`` because the suite's conftest imports the JAX package,
which the port's machine need not have; this file imports only the port.)
Shapes sweep what ``chip_smoke.py``'s single p=8 run does not: other
precisions, ragged sizes, masked edges and set lanes, self-loops,
duplicate edges and ids, register bytes above q + 1, hop panels whose
registers fell, and the packed layout's six kernels (p = 4-16, registers
at and above 15 before packing, the nibble-merge trap, exact sums); the
pair kernel on zero-heavy, all-zero, all-equal and foreign rows (its
byte sums equal the estimate kernel's bit for bit), and the union kernel
on a 1,024-member set among singletons and on one-lane panels; the
two-panel propagate launchers on panels of other row counts, self-index
pairs, hub segments across run boundaries and an empty routing, and the
sharded engine on the card (1 and 4 shards) against the local one.
Tolerances as in ``tests/test_torch_kernels.py``: panels, histograms and
zero counts exact, harmonic sums ``rtol=1e-6`` (packed sums exact), HIP
increments exact (both sum exactly and round once); the card engine
against the CPU engine as the CPU parity tests hold the port to JAX
(estimates 1e-5, MLE 1e-4 of the estimates' scale).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ertl_stats, hip_delta  # noqa: E402
from repro_torch.kernels import hll_accumulate, hll_estimate  # noqa: E402
from repro_torch.kernels import hll_propagate  # noqa: E402
from repro_torch.kernels import intersection_stats, union_estimate  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """The card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run only on the card)")
    return torch.device("cuda")


def _panel(rng, v, p, hi, dev):
    return torch.from_numpy(rng.integers(0, hi, (v, 1 << p))
                            .astype(np.uint8)).to(dev)


def _launched(name, fn):
    before = _build.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("p,seed", [(4, 0), (8, 1), (12, 7), (16, 12345)])
def test_accumulate_matches_plain(dev, p, seed):
    rng = np.random.default_rng(p)
    v, e = 333, 50_001
    regs = _panel(rng, v, p, 4, dev)
    rows = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, e, dtype=np.uint64)
                            .astype(np.uint32)).to(dev)
    mask = torch.from_numpy(rng.random(e) > 0.2).to(dev)
    want = hll_accumulate.plain(regs.clone(), rows, keys, mask, p=p,
                                seed=seed)
    got = _launched("hll_accumulate", lambda: hll_accumulate.hll_accumulate(
        regs, rows, keys, mask, p=p, seed=seed))
    assert got.data_ptr() == regs.data_ptr()  # in place
    assert torch.equal(got, want)


def _sorted_inserts(rng, v, e):
    """Row-sorted rows (a few rows, long runs) and random keys."""
    rows = np.sort(rng.integers(0, v, e)).astype(np.int32)
    keys = rng.integers(0, 2 ** 32, e, dtype=np.uint64).astype(np.uint32)
    return rows, keys


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 16])
def test_accumulate_match_groups_match_plain(dev, layout, p):
    """Row-sorted inserts into 3 rows: a warp's 32 lanes mostly share a
    row, so many lanes update one word and the match groups are large;
    the edge count is not a multiple of a tile."""
    rng = np.random.default_rng(p + 31)
    w = (1 << p) // (2 if layout == "packed" else 1)
    regs = torch.zeros((3, w), dtype=torch.uint8, device=dev)
    rows, keys = _sorted_inserts(rng, 3, 40_001)
    rows_t, keys_t = (torch.from_numpy(x).to(dev) for x in (rows, keys))
    want = hll_accumulate.plain(regs.clone(), rows_t, keys_t, p=p, seed=2,
                                layout=layout)
    got = _launched(_build.kernel_name("hll_accumulate", layout),
                    lambda: hll_accumulate.hll_accumulate(
                        regs, rows_t, keys_t, p=p, seed=2, layout=layout))
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("e", [1, 127, 129, 50_003])
def test_accumulate_without_mask_matches_masks(dev, layout, e):
    """mask=None equals an all-true mask; a mixed mask equals the plain
    version; edge counts off the 128-edge tile and the 4-edge thread."""
    rng = np.random.default_rng(e)
    p, v = 8, 97
    w = (1 << p) // (2 if layout == "packed" else 1)
    rows, keys = _sorted_inserts(rng, v, e)
    rows_t, keys_t = (torch.from_numpy(x).to(dev) for x in (rows, keys))
    name = _build.kernel_name("hll_accumulate", layout)

    def run(mask):
        regs = torch.zeros((v, w), dtype=torch.uint8, device=dev)
        return _launched(name, lambda: hll_accumulate.hll_accumulate(
            regs, rows_t, keys_t, mask, p=p, layout=layout))

    ones = torch.ones(e, dtype=torch.bool, device=dev)
    assert torch.equal(run(None), run(ones))
    mixed = torch.from_numpy(rng.random(e) < 0.5).to(dev)
    want = hll_accumulate.plain(
        torch.zeros((v, w), dtype=torch.uint8, device=dev), rows_t, keys_t,
        mixed, p=p, layout=layout)
    assert torch.equal(run(mixed), want)


@pytest.mark.parametrize("p", [3, 4, 8, 12])
@pytest.mark.parametrize("n", [1, 1001])
def test_estimate_matches_plain(dev, p, n):
    rng = np.random.default_rng(p * 10 + n)
    regs = _panel(rng, n, p, 66, dev)
    regs[: n // 3] = 0
    got = _launched("hll_estimate_stats",
                    lambda: hll_estimate.hll_estimate_stats(regs))
    want = hll_estimate.plain(regs)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-6, atol=0)


# The row-statistics kernels (estimate, hip_delta) give each row a group
# of 1-32 lanes, 32-1 rows a warp, by row width; these row counts leave
# every such group ragged at every p: 32 / g +- 1 rows for each g.
RAGGED_ROWS = (1, 2, 3, 5, 7, 9, 15, 17, 31, 33, 1001)


def _offset(t):
    """``t``'s copy 8 bytes off 16-byte alignment (the 8-byte loads)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[8:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 8
    return out


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", list(range(4, 17)))
def test_estimate_ragged_rows_match_plain(dev, layout, p):
    """Both layouts at every p, every ragged row count, all-zero rows,
    byte registers up to 255 (words that take exp2f) and panels that
    allow only 8-byte loads: byte ``z`` exact and ``s`` within
    ``rtol=1e-6``; packed bit for bit, and equal to the byte kernel on
    the unpacked panel (both round the exact sum once)."""
    from repro_torch.kernels import packing
    rng = np.random.default_rng(p * 31 + (layout == "packed"))
    name = _build.kernel_name("hll_estimate_stats", layout)
    for n in RAGGED_ROWS:
        full = rng.integers(0, 22, (n, 1 << p)).astype(np.uint8)
        full[::3] = 0
        if layout == "byte":
            full[1::3, ::7] = rng.integers(100, 256, full[1::3, ::7].shape)
        regs = torch.from_numpy(full).to(dev)
        if layout == "packed":
            regs = packing.pack_rows(regs)
        want = hll_estimate.plain(regs, layout=layout)
        for panel in (regs, _offset(regs)):
            got = _launched(name, lambda: hll_estimate.hll_estimate_stats(
                panel, layout=layout))
            assert torch.equal(got[:, 1], want[:, 1]), n
            if layout == "packed":
                assert torch.equal(got, want), n
            else:
                torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-6,
                                           atol=0)
        assert bool((got[::3, 1] == float(1 << p)).all())
        if layout == "packed":
            assert torch.equal(got, hll_estimate.hll_estimate_stats(
                packing.unpack_rows(regs)))


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_estimate_triangle_block_matches_plain(dev, layout):
    """2^18 + 3 rows at p=8, the triangle phase's block and a ragged
    tail, on a persistent grid that strides over many row groups."""
    from repro_torch.kernels import packing
    rng = np.random.default_rng(18)
    regs = _panel(rng, (1 << 18) + 3, 8, 30, dev)
    if layout == "packed":
        regs = packing.pack_rows(regs)
    got = _launched(_build.kernel_name("hll_estimate_stats", layout),
                    lambda: hll_estimate.hll_estimate_stats(regs,
                                                            layout=layout))
    want = hll_estimate.plain(regs, layout=layout)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-6, atol=0)
    if layout == "packed":
        assert torch.equal(got, want)


def _routing(src, dst, dev):
    """A numpy routing on the card, sorted by dst as the kernel needs."""
    return hll_propagate.sort_routing(
        *(torch.from_numpy(np.asarray(x, np.int32)).to(dev)
          for x in (src, dst)))


@pytest.mark.parametrize("p", [3, 8, 12])
def test_propagate_matches_plain(dev, p):
    rng = np.random.default_rng(p)
    v, e = 500, 20_000
    regs = _panel(rng, v, p, 40, dev)
    regs[rng.random(v) < 0.3] = 0  # empty sketches
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[::7] = src[::7]  # self-loops
    src[1::9], dst[1::9] = 5, 9  # one heavily duplicated edge
    src_t, dst_t = _routing(src, dst, dev)
    got = _launched("hll_propagate",
                    lambda: hll_propagate.hll_propagate(regs, src_t, dst_t))
    assert torch.equal(got, hll_propagate.plain(regs, src_t, dst_t))
    assert not torch.equal(got, regs)


def test_propagate_reads_the_frozen_panel(dev):
    regs = torch.zeros((4, 16), dtype=torch.uint8, device=dev)
    regs[2, 5] = 9
    # 2 -> 0, then 0 -> 1: the first hop sorts first, so a kernel that
    # gathered from ``out`` would carry the 9 on to row 1.
    src = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    dst = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    one = hll_propagate.hll_propagate(regs, src, dst)
    assert int(one[0, 5]) == 9 and int(one[1, 5]) == 0


# Routings shaped against the pull's edge runs (512-2048 edges each): a
# hub's in-edges spread over many runs, segments longer than any run so
# every one crosses a run boundary, and a stretch of self-edges longer
# than a run. Panels at p = 4-16, both layouts, equal to the plain version
# bit for bit.

def _run_routings(rng, v):
    """{name: (src, dst)} numpy routings over v rows (unsorted)."""
    other = rng.integers(0, v, (1_000, 2))
    other[:, 1] = rng.integers(5, v, 1_000)  # no other edge enters 3 or 4
    star_src = rng.integers(0, v, 6_000)
    lens = rng.integers(2_049, 2_500, 3)  # every segment > any run
    long_dst = np.repeat(rng.choice(v, 3, replace=False), lens)
    selfs = np.repeat([3, 4], 1_100)  # sorts first: routing[:2200]
    return {
        "star": (np.concatenate([star_src, other[:, 0]]),
                 np.concatenate([np.full(6_000, 7), other[:, 1]])),
        "straddling": (rng.integers(0, v, lens.sum()), long_dst),
        "self_edges": (np.concatenate([selfs, other[:, 0]]),
                       np.concatenate([selfs, other[:, 1]])),
    }


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
@pytest.mark.parametrize("case", ["star", "straddling", "self_edges"])
def test_propagate_edge_runs_match_plain(dev, layout, p, case):
    rng = np.random.default_rng(p * 7 + len(case))
    v = 300
    if layout == "packed":
        regs = _packed_panel(rng, v, p, dev)
    else:
        regs = _panel(rng, v, p, 40, dev)
    regs[rng.random(v) < 0.2] = 0
    src_t, dst_t = _routing(*_run_routings(rng, v)[case], dev)
    if case == "self_edges":  # the first run holds only self-edges
        assert torch.equal(src_t[:2_048], dst_t[:2_048])
    name = _build.kernel_name("hll_propagate", layout)
    got = _launched(name, lambda: hll_propagate.hll_propagate(
        regs, src_t, dst_t, layout=layout))
    assert torch.equal(got, hll_propagate.plain(regs, src_t, dst_t,
                                                layout=layout))


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_propagate_rejects_unsorted_dst(dev, layout):
    regs = torch.zeros((8, 16), dtype=torch.uint8, device=dev)
    src = torch.tensor([1, 2, 3], dtype=torch.int32, device=dev)
    dst = torch.tensor([0, 4, 2], dtype=torch.int32, device=dev)
    before = _build.launch_counts()
    with pytest.raises(ValueError, match="non-decreasing"):
        hll_propagate.hll_propagate(regs, src, dst, layout=layout)
    assert _build.launch_counts() == before
    s, d = hll_propagate.sort_routing(src, dst)
    assert d.tolist() == [0, 2, 4] and s.tolist() == [1, 3, 2]
    hll_propagate.hll_propagate(regs, s, d, layout=layout)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("case", ["mask", "unsorted", "both", "misaligned"])
def test_ops_propagate_any_order_and_mask(dev, layout, case):
    """``ops.propagate`` on the card takes what the reference takes: a
    mask, an unsorted ``dst``, both, and (``misaligned``: both, on a panel
    8 bytes off 16-byte alignment) a panel the kernel cannot read as it
    lies. It launches the kernel and equals the CPU pass (the inputs of
    ``tests/test_torch_kernels.py``'s parity test against the JAX
    ``ops.propagate(impl="ref")``)."""
    from repro_torch.kernels import ops, packing
    rng = np.random.default_rng(len(case) + 17 * (layout == "packed"))
    v, e, p = 40, 600, 6
    full = rng.integers(0, 20 if layout == "packed" else 30, (v, 1 << p))
    regs = torch.from_numpy(full.astype(np.uint8))
    if layout == "packed":
        regs = packing.pack_rows(regs)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if case == "mask":
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    mask = None if case == "unsorted" else rng.random(e) > 0.4
    cpu = [None if x is None else torch.from_numpy(x)
           for x in (src, dst, mask)]
    want = ops.propagate(regs, *cpu, layout=layout)
    card = regs.to(dev)
    if case == "misaligned":
        buf = torch.zeros(card.numel() + 8, dtype=torch.uint8, device=dev)
        card = buf[8:].view(card.shape)
        card.copy_(regs)
        assert card.data_ptr() % 16 == 8
    args = [None if x is None else x.to(dev) for x in cpu]
    got = _launched(_build.kernel_name("hll_propagate", layout),
                    lambda: ops.propagate(card, *args, layout=layout))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(card.cpu(), regs)  # the input is left as it was


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
def test_intersection_stats_match_plain(dev, p, b):
    rng = np.random.default_rng(p * 100 + b)
    v, q = 257, 64 - p
    regs = _panel(rng, v, p, 70, dev)  # bytes above q + 1 count in no bin
    ids = torch.from_numpy(rng.integers(0, v, (b, 2)).astype(np.int32)).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st, sz = _launched("intersection_stats",
                       lambda: intersection_stats.intersection_stats(
                           regs, pa, pb, q))
    st_p, sz_p = intersection_stats.plain(regs, pa, pb, q)
    assert torch.equal(st, st_p)
    assert torch.equal(sz[..., 1], sz_p[..., 1])
    torch.testing.assert_close(sz[..., 0], sz_p[..., 0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
@pytest.mark.parametrize("lanes", [1, 64])
def test_union_estimate_matches_plain(dev, p, b, lanes):
    rng = np.random.default_rng(p * 1000 + b + lanes)
    v = 257
    regs = _panel(rng, v, p, 70, dev)
    regs[0] = 69  # a masked lane that read its padding id 0 would show
    ids = rng.integers(0, v, (b, lanes)).astype(np.int32)
    lens = rng.integers(0, lanes + 1, b)
    lens[::7] = 0  # fully masked sets
    mask = np.arange(lanes)[None, :] < lens[:, None]
    if lanes > 1:
        ids[::3, 1] = ids[::3, 0]  # duplicate ids
    ids[~mask] = 0
    ids_t = torch.from_numpy(ids).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    got = _launched("union_estimate_stats",
                    lambda: union_estimate.union_estimate_stats(
                        regs, ids_t, mask_t))
    want = union_estimate.plain(regs, ids_t, mask_t)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-6, atol=0)
    empty = torch.from_numpy(~mask.any(axis=1)).to(dev)
    assert bool((got[empty] == float(1 << p)).all())
    again = union_estimate.union_estimate_stats(regs, ids_t, mask_t)
    assert torch.equal(again, got)  # fixed reduction order: same bits


def _accumulated_panel(p, dev, layout, case):
    """A small RMAT graph's accumulate on the card (mostly zero registers
    at p >= 8), or its variants: every row zero, every row equal to the
    fullest row, or byte registers above q + 1 sprinkled in (packing
    clamps them to 15)."""
    from repro_torch.graph import generators
    from repro_torch.kernels import packing
    edges = generators.rmat(9, 8, seed=p)
    directed = np.concatenate([edges, edges[:, ::-1]])
    regs = torch.zeros((1 << 9, 1 << p), dtype=torch.uint8, device=dev)
    hll_accumulate.hll_accumulate(
        regs, torch.from_numpy(directed[:, 0].copy()).to(dev),
        torch.from_numpy(directed[:, 1].astype(np.uint32)).to(dev), p=p,
        seed=0)
    if case == "zero":
        regs.zero_()
    elif case == "equal":
        regs[:] = regs[int((regs > 0).sum(1).argmax())]
    elif case == "foreign":
        regs[1::7, ::3] = 70 + (64 - p)
    return packing.pack_rows(regs) if layout == "packed" else regs


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("case", ["accumulated", "zero", "equal", "foreign"])
def test_intersection_stats_pair_classes_match_plain(dev, layout, p, case):
    """Zero-heavy, all-zero, all-equal and foreign rows at an odd B; the
    byte sums are exact: sz's s of A and B equal hll_estimate_stats of
    those rows bit for bit."""
    regs = _accumulated_panel(p, dev, layout, case)
    q, b = 64 - p, 333
    rng = np.random.default_rng(p + 17)
    ids = torch.from_numpy(rng.integers(0, regs.shape[0], (b, 2))
                           .astype(np.int32)).to(dev)
    ids[::5, 1] = ids[::5, 0]
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st, sz = _launched(_build.kernel_name("intersection_stats", layout),
                       lambda: intersection_stats.intersection_stats(
                           regs, pa, pb, q, layout=layout))
    st_p, sz_p = intersection_stats.plain(regs, pa, pb, q, layout=layout)
    assert torch.equal(st, st_p)
    assert torch.equal(sz[..., 1], sz_p[..., 1])
    torch.testing.assert_close(sz[..., 0], sz_p[..., 0], rtol=1e-6, atol=0)
    est = hll_estimate.hll_estimate_stats(regs, layout=layout)
    assert torch.equal(sz[:, 0, 0], est[pa.long(), 0])
    assert torch.equal(sz[:, 1, 0], est[pb.long(), 0])
    if layout == "packed":
        assert torch.equal(sz, sz_p)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("case", ["long_set", "one_lane"])
def test_union_estimate_long_sets_match_plain(dev, layout, p, case):
    """One 1,024-member set among singletons and empty sets (L = 1024), or
    a panel of one lane (L = 1), on a zero-heavy accumulated panel."""
    regs = _accumulated_panel(p, dev, layout, "accumulated")
    regs[0] = 0xFF if layout == "packed" else 69  # a read padding row shows
    rng = np.random.default_rng(p + 29)
    v, b = regs.shape[0], 77
    lanes = 1024 if case == "long_set" else 1
    ids = rng.integers(1, v, (b, lanes)).astype(np.int32)
    mask = np.zeros((b, lanes), bool)
    mask[:, 0] = rng.random(b) > 0.2
    if case == "long_set":
        mask[40] = True
        mask[40, 500:520] = False  # holes inside the long set
    ids[~mask] = 0
    ids_t = torch.from_numpy(ids).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    got = _launched(_build.kernel_name("union_estimate_stats", layout),
                    lambda: union_estimate.union_estimate_stats(
                        regs, ids_t, mask_t, layout=layout))
    want = union_estimate.plain(regs, ids_t, mask_t, layout=layout)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-6, atol=0)
    if layout == "packed":
        assert torch.equal(got, want)
    empty = torch.from_numpy(~mask.any(axis=1)).to(dev)
    assert bool((got[empty] == float(1 << p)).all())
    again = union_estimate.union_estimate_stats(regs, ids_t, mask_t,
                                                layout=layout)
    assert torch.equal(again, got)  # same bits on every launch


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
def test_ertl_stats_match_plain(dev, p, b):
    rng = np.random.default_rng(p * 100 + b + 1)
    q = 64 - p
    a = _panel(rng, b, p, 70, dev)  # bytes above q + 1 count in no bin
    c = _panel(rng, b, p, 70, dev)
    c[::5] = a[::5]
    got = _launched("ertl_stats", lambda: ertl_stats.ertl_stats(a, c, q))
    assert torch.equal(got, ertl_stats.plain(a, c, q))


@pytest.mark.parametrize("p", [4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16])
@pytest.mark.parametrize("n", [1, 33, 1001])
def test_hip_delta_matches_plain(dev, p, n):
    """Ragged row counts, every row width the kernel groups differently,
    registers up to max_register, lanes that grew, stayed and fell."""
    rng = np.random.default_rng(p * 10000 + n)
    top = 65 - p
    prev = rng.integers(0, top + 1, (n, 1 << p))
    cur = np.clip(prev + rng.integers(-3, 4, prev.shape), 0, top)
    cur[::4] = prev[::4]  # rows that did not grow at all
    prev_t, cur_t = (torch.from_numpy(x.astype(np.uint8)).to(dev)
                     for x in (prev, cur))
    got = _launched("hip_delta_rows",
                    lambda: hip_delta.hip_delta_rows(prev_t, cur_t))
    assert torch.equal(got, hip_delta.plain(prev_t, cur_t))
    assert bool((got[::4] == 0).all())


@pytest.mark.parametrize("p", [4, 6, 8, 12, 16])
def test_hip_delta_mixed_paths_match_plain(dev, p):
    """Words whose prev bytes are all below 30 (the 32-bit fast path)
    beside words holding a prev byte of 30-61 (the general path), mixed
    within one row and across the rows of one warp; cur bytes up to 255
    in fast words; every ragged row count; panels that allow only 8-byte
    loads. Bit for bit."""
    rng = np.random.default_rng(p + 4242)
    top = 65 - p
    for n in RAGGED_ROWS:
        prev = rng.integers(0, 30, (n, 1 << p))
        big = rng.random(prev.shape) < 0.02  # a few words go general
        prev[big] = rng.integers(30, top + 1, int(big.sum()))
        prev[::2] = np.minimum(prev[::2], 29)  # whole rows stay fast
        cur = np.clip(prev + rng.integers(-2, 4, prev.shape), 0, top)
        wild = rng.random(prev.shape) < 0.01
        cur[wild] = rng.integers(128, 256, int(wild.sum()))
        prev_t, cur_t = (torch.from_numpy(x.astype(np.uint8)).to(dev)
                         for x in (prev, cur))
        want = hip_delta.plain(prev_t, cur_t)
        for a, b in ((prev_t, cur_t), (_offset(prev_t), _offset(cur_t)),
                     (prev_t, _offset(cur_t))):
            got = _launched("hip_delta_rows",
                            lambda: hip_delta.hip_delta_rows(a, b))
            assert torch.equal(got, want), n


def test_hip_delta_foreign_bytes(dev):
    """Register bytes of 64 and above (no ADS config stores them) take
    the float64 band; 128 and above overflow to inf, as in float32."""
    prev = torch.zeros((3, 16), dtype=torch.uint8, device=dev)
    cur = torch.full((3, 16), 255, dtype=torch.uint8, device=dev)
    prev[0, 0], prev[1, 0], prev[2, 0] = 64, 100, 200
    prev[:, 1:] = 254
    got = hip_delta.hip_delta_rows(prev, cur)
    assert torch.equal(got, hip_delta.plain(prev, cur))
    assert torch.isinf(got).all()
    prev[:, 1:] = 255  # only lane 0 grew
    got = hip_delta.hip_delta_rows(prev, cur)
    assert got[:2].tolist() == [2.0 ** 64, 2.0 ** 100]
    assert torch.isinf(got[2])


def test_ads_engine_on_the_card_matches_the_cpu(dev):
    """Distance queries through the kernels: the same registers, HIP
    curve rows within 1e-5 of the CPU's, hip_delta launched once per hop
    after the first and not at all on a repeat."""
    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.graph import generators
    edges = generators.rmat(10, 8, seed=6)
    n = 1 << 10
    cpu = engine.build(edges, n, ADSConfig(p=8), device="cpu")
    card = engine.build(edges, n, ADSConfig(p=8), family="ads")
    assert torch.equal(card.regs.cpu(), cpu.regs)
    before = _build.launch_counts()
    hist, glob = card.distance_histogram(4)
    after = _build.launch_counts()
    assert after["hip_delta_rows"] - before["hip_delta_rows"] == 3
    assert after["hll_propagate"] - before["hll_propagate"] == 3
    w_hist, w_glob = cpu.distance_histogram(4)
    np.testing.assert_allclose(np.cumsum(hist, 0), np.cumsum(w_hist, 0),
                               rtol=1e-5)
    np.testing.assert_allclose(glob, w_glob, rtol=1e-5)
    np.testing.assert_allclose(card.closeness(4), cpu.closeness(4),
                               rtol=1e-5)
    assert abs(card.effective_diameter(4) - cpu.effective_diameter(4)) < 1e-6
    assert _build.launch_counts() == after  # served from the cached curve
    left = engine.build(edges[0::2], n, ADSConfig(p=8))
    left.merge(engine.build(edges[1::2], n, ADSConfig(p=8), device="cpu"))
    assert left.device.type == "cuda" and torch.equal(left.regs, card.regs)


def test_engine_queries_on_the_card_match_the_cpu(dev):
    """union_size, query_batch and both triangle modes: the card engine
    against the CPU engine, each through its kernels."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    edges = generators.rmat(9, 8, seed=4)
    n = 1 << 9
    cfg = HLLConfig(p=8)
    cpu = engine.build(edges, n, cfg, device="cpu")
    card = engine.build(edges, n, cfg)
    rng = np.random.default_rng(4)
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(40)]
    uni = _launched("union_estimate_stats", lambda: card.union_size(sets))
    np.testing.assert_allclose(uni, cpu.union_size(sets), rtol=1e-5)
    pairs = edges[rng.choice(len(edges), 50, replace=False)]
    batch = card.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                             iters=10)
    assert np.array_equal(batch["degrees"], card.degrees())
    assert np.array_equal(batch["union"], uni)
    assert np.array_equal(batch["intersection"],
                          card.intersection_size(pairs, iters=10))
    from repro_torch.core import degreesketch as dsk
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cfg), edges, iters=10)
    deg = cpu.degrees()
    # |A u B| <= |A| + |B|: the terms of the difference, as in the tests
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        before = _build.launch_counts()
        tot, vals, _ = card.triangle_heavy_hitters(10, mode=mode, iters=10)
        after = _build.launch_counts()
        assert after["ertl_stats"] > before["ertl_stats"]
        assert after["hll_estimate_stats"] > before["hll_estimate_stats"]
        w_tot, w_vals, _ = cpu.triangle_heavy_hitters(10, mode=mode,
                                                      iters=10)
        assert abs(tot - w_tot) <= tol.sum() / 3
        np.testing.assert_allclose(vals, w_vals, rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_ragged_ingest_on_the_card_matches_the_cpu(dev, monkeypatch, layout):
    """Ragged ingest blocks, split into chunks of a small INGEST_BLOCK:
    one accumulate launch per chunk, registers equal to the CPU engine's,
    and neighborhoods over the card's dst-sorted routing equal too."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.engine.base import SketchEngine
    from repro_torch.graph import generators
    monkeypatch.setattr(SketchEngine, "INGEST_BLOCK", 1000)
    edges = generators.rmat(10, 8, seed=9)
    n = 1 << 10
    cfg = HLLConfig(p=8)
    cpu = engine.build(edges, n, cfg, layout=layout, device="cpu")
    card = engine.open(n, cfg, layout=layout)
    name = _build.kernel_name("hll_accumulate", layout)
    before = _build.launch_counts()[name]
    chunks, s = 0, 0
    for size in (1, 999, 1000, 1001, 2500, 77):
        block = edges[s:s + size]
        card.ingest(block)
        chunks += -(-len(block) // 1000)
        s += size
    card.ingest(edges[s:])
    chunks += -(-(len(edges) - s) // 1000)
    assert _build.launch_counts()[name] - before == chunks
    assert torch.equal(card.regs.cpu(), cpu.regs)
    prop = _build.kernel_name("hll_propagate", layout)
    before = _build.launch_counts()[prop]
    hops = card.neighborhood(3)[0]
    assert _build.launch_counts()[prop] - before == 2
    np.testing.assert_allclose(hops, cpu.neighborhood(3)[0], rtol=1e-5)
    for a, b in zip(card._panel_set.panels, cpu._panel_set.panels):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("estimator", ["flajolet", "beta"])
def test_engine_on_the_card_matches_the_cpu(dev, estimator):
    """Both estimators read the estimate kernel's (s, z) on the card."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    edges = generators.rmat(9, 8, seed=2)
    n = 1 << 9
    cfg = HLLConfig(p=8, estimator=estimator)
    cpu = engine.build(edges, n, cfg, device="cpu")
    card = engine.build(edges, n, cfg)  # default device: the card
    assert card.device.type == "cuda"
    assert torch.equal(card.regs.cpu(), cpu.regs)
    est = _launched("hll_estimate_stats", card.degrees)
    np.testing.assert_allclose(est, cpu.degrees(), rtol=1e-5)
    np.testing.assert_allclose(card.neighborhood(3)[0], cpu.neighborhood(3)[0],
                               rtol=1e-5)


# ------------------------------------------------------- packed layout
# Each packed kernel against its plain version: panels, histograms, zero
# counts and harmonic sums all exactly equal (packed sums are exact
# integers in both), at p = 4-16, ragged sizes, registers at and above 15
# before packing, and the nibble-merge trap.

def _packed_panel(rng, v, p, dev, hi=22):
    """A packed panel from byte registers up to ``hi`` (saturating)."""
    from repro_torch.kernels import packing
    full = rng.integers(0, hi, (v, 1 << p)).astype(np.uint8)
    return packing.pack_rows(torch.from_numpy(full)).to(dev)


@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_packed_accumulate_matches_plain(dev, p):
    """2^21 inserts into 333 rows: some keys have rho > 15 and saturate."""
    rng = np.random.default_rng(p + 900)
    v, e = 333, 1 << 21
    regs = _packed_panel(rng, v, p, dev, hi=16)
    rows = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, e, dtype=np.uint64)
                            .astype(np.uint32)).to(dev)
    mask = torch.from_numpy(rng.random(e) > 0.1).to(dev)
    want = hll_accumulate.plain(regs.clone(), rows, keys, mask, p=p, seed=3,
                                layout="packed")
    got = _launched("hll_accumulate_packed",
                    lambda: hll_accumulate.hll_accumulate(
                        regs, rows, keys, mask, p=p, seed=3,
                        layout="packed"))
    assert got.data_ptr() == regs.data_ptr()
    assert torch.equal(got, want)
    assert bool(((got >> 4) == 15).any() | ((got & 15) == 15).any())


@pytest.mark.parametrize("p", list(range(4, 17)))
@pytest.mark.parametrize("n", [1, 1001])
def test_packed_estimate_matches_plain(dev, p, n):
    rng = np.random.default_rng(p * 10 + n + 1)
    regs = _packed_panel(rng, n, p, dev)
    regs[: n // 3] = 0
    got = _launched("hll_estimate_stats_packed",
                    lambda: hll_estimate.hll_estimate_stats(
                        regs, layout="packed"))
    assert torch.equal(got, hll_estimate.plain(regs, layout="packed"))
    if p <= 9:  # the byte kernel on the unpacked panel is exact there too
        from repro_torch.kernels import packing
        assert torch.equal(got, hll_estimate.hll_estimate_stats(
            packing.unpack_rows(regs)))


@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_packed_propagate_matches_plain(dev, p):
    rng = np.random.default_rng(p + 910)
    v, e = 500, 20_000
    regs = _packed_panel(rng, v, p, dev)
    regs[rng.random(v) < 0.3] = 0
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[::7] = src[::7]
    src[1::9], dst[1::9] = 5, 9
    src_t, dst_t = _routing(src, dst, dev)
    got = _launched("hll_propagate_packed",
                    lambda: hll_propagate.hll_propagate(
                        regs, src_t, dst_t, layout="packed"))
    assert torch.equal(got, hll_propagate.plain(regs, src_t, dst_t,
                                                layout="packed"))


def test_packed_nibble_merge_trap(dev):
    """0x10 merged with 0x01 is 0x11 in propagate, union and the engine's
    merge; a byte-wise max would give 0x10."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    regs = torch.zeros((4, 8), dtype=torch.uint8, device=dev)
    regs[0, :] = 0x10
    regs[1, :] = 0x01
    src = torch.tensor([1], dtype=torch.int32, device=dev)
    dst = torch.tensor([0], dtype=torch.int32, device=dev)
    out = hll_propagate.hll_propagate(regs, src, dst, layout="packed")
    assert bool((out[0] == 0x11).all())
    ids = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    mask = torch.ones((1, 2), dtype=torch.bool, device=dev)
    got = union_estimate.union_estimate_stats(regs, ids, mask,
                                              layout="packed")
    assert got[0].tolist() == [16 * 0.5, 0.0]  # sixteen registers of 1
    a = engine.LocalEngine.from_regs(regs[:1], 1, HLLConfig(p=4),
                                     layout="packed")
    a.merge(engine.LocalEngine.from_regs(regs[1:2], 1, HLLConfig(p=4),
                                         layout="packed"))
    assert bool((a.regs[0] == 0x11).all())


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
def test_packed_intersection_stats_match_plain(dev, p, b):
    rng = np.random.default_rng(p * 100 + b + 7)
    v, q = 257, 64 - p
    regs = _packed_panel(rng, v, p, dev)
    ids = torch.from_numpy(rng.integers(0, v, (b, 2)).astype(np.int32)).to(dev)
    pa, pb = ids[:, 0].contiguous(), ids[:, 1].contiguous()
    st, sz = _launched("intersection_stats_packed",
                       lambda: intersection_stats.intersection_stats(
                           regs, pa, pb, q, layout="packed"))
    st_p, sz_p = intersection_stats.plain(regs, pa, pb, q, layout="packed")
    assert torch.equal(st, st_p) and torch.equal(sz, sz_p)


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
@pytest.mark.parametrize("lanes", [1, 64])
def test_packed_union_estimate_matches_plain(dev, p, b, lanes):
    rng = np.random.default_rng(p * 1000 + b + lanes + 3)
    v = 257
    regs = _packed_panel(rng, v, p, dev)
    regs[0] = 0xFF  # a masked lane that read its padding id 0 would show
    ids = rng.integers(0, v, (b, lanes)).astype(np.int32)
    lens = rng.integers(0, lanes + 1, b)
    lens[::7] = 0
    mask = np.arange(lanes)[None, :] < lens[:, None]
    ids[~mask] = 0
    ids_t = torch.from_numpy(ids).to(dev)
    mask_t = torch.from_numpy(mask).to(dev)
    got = _launched("union_estimate_stats_packed",
                    lambda: union_estimate.union_estimate_stats(
                        regs, ids_t, mask_t, layout="packed"))
    assert torch.equal(got, union_estimate.plain(regs, ids_t, mask_t,
                                                 layout="packed"))
    empty = torch.from_numpy(~mask.any(axis=1)).to(dev)
    assert bool((got[empty] == float(1 << p)).all())


@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 77, 4096])
def test_packed_ertl_stats_match_plain(dev, p, b):
    rng = np.random.default_rng(p * 100 + b + 11)
    q = 64 - p
    a = _packed_panel(rng, b, p, dev)
    c = _packed_panel(rng, b, p, dev)
    c[::5] = a[::5]
    got = _launched("ertl_stats_packed",
                    lambda: ertl_stats.ertl_stats(a, c, q, layout="packed"))
    assert torch.equal(got, ertl_stats.plain(a, c, q, layout="packed"))
    assert float(got[:, :, 16:].sum()) == 0


def test_packed_engine_on_the_card_matches_the_cpu(dev):
    """The packed engine through the packed kernels: the same registers as
    the CPU's plain versions, answers as the byte engine test holds them,
    and the byte engine's answers on the clamped panel."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.graph import generators
    from repro_torch.kernels import packing
    edges = generators.rmat(9, 8, seed=5)
    n = 1 << 9
    cfg = HLLConfig(p=8)
    cpu = engine.build(edges, n, cfg, layout="packed", device="cpu")
    before = _build.launch_counts()
    card = engine.build(edges, n, cfg, layout="packed")
    assert torch.equal(card.regs.cpu(), cpu.regs)
    rng = np.random.default_rng(5)
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(40)]
    pairs = edges[rng.choice(len(edges), 50, replace=False)]
    np.testing.assert_allclose(card.degrees(), cpu.degrees(), rtol=1e-5)
    np.testing.assert_allclose(card.neighborhood(3)[0],
                               cpu.neighborhood(3)[0], rtol=1e-5)
    np.testing.assert_allclose(card.union_size(sets), cpu.union_size(sets),
                               rtol=1e-5)
    batch = card.query_batch(degrees=True, vertex_sets=sets, pairs=pairs,
                             iters=10)
    assert np.array_equal(batch["intersection"],
                          card.intersection_size(pairs, iters=10))
    byte = engine.LocalEngine.from_regs(packing.unpack_rows(card.regs), n,
                                        cfg, edges=edges)
    assert np.array_equal(card.degrees(), byte.degrees())
    assert np.array_equal(card.union_size(sets), byte.union_size(sets))
    assert np.array_equal(card.intersection_size(pairs, iters=10),
                          byte.intersection_size(pairs, iters=10))
    from repro_torch.core import degreesketch as dsk
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cpu.regs, n=n, cfg=cfg, layout="packed"),
        edges, iters=10)
    deg = cpu.degrees()
    # |A u B| <= |A| + |B|: the terms of the difference, as in the tests
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        tot, vals, _ = card.triangle_heavy_hitters(10, mode=mode, iters=10)
        w_tot, w_vals, _ = cpu.triangle_heavy_hitters(10, mode=mode,
                                                      iters=10)
        assert abs(tot - w_tot) <= tol.sum() / 3
        np.testing.assert_allclose(vals, w_vals, rtol=0, atol=atol)
    after = _build.launch_counts()
    for name in ("hll_accumulate_packed", "hll_estimate_stats_packed",
                 "hll_propagate_packed", "union_estimate_stats_packed",
                 "intersection_stats_packed", "ertl_stats_packed"):
        assert after[name] > before[name], name
    left = engine.build(edges[0::2], n, cfg, layout="packed")
    left.merge(engine.build(edges[1::2], n, cfg, device="cpu"))  # byte
    assert torch.equal(left.regs, card.regs)


# ------------------------------------------------------------- serving
SERVE_SCALE, SERVE_WAIT = 14, 120


def _serve_graph():
    from repro_torch.graph import generators
    edges = generators.rmat(SERVE_SCALE, 16, seed=11)
    return edges, 1 << SERVE_SCALE


def _card_engine(edges, n, layout="byte"):
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    return engine.build(edges, n, HLLConfig(p=8), layout=layout,
                        device="cuda")


def _run_threads(fn, n):
    import threading
    errors = []

    def body(i):
        try:
            fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SERVE_WAIT)
        assert not t.is_alive(), "a client thread did not finish"
    assert not errors, errors


def test_direct_launch_counts_exact_under_threads(dev):
    """8 threads querying one engine at once: every launch is counted."""
    edges, n = _serve_graph()
    eng = _card_engine(edges, n)
    sets = [np.arange(i, i + 5) for i in range(40)]
    _build.reset_launch_counts()
    _run_threads(lambda i: [eng.union_size(sets) for _ in range(50)], 8)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts["union_estimate_stats"] == 8 * 50
    assert sum(counts.values()) == 8 * 50


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_query_server_on_the_card(dev, layout):
    """8 client threads through a QueryServer at RMAT scale 14: every
    answer equals the direct call on the card bit for bit, and each
    kernel launched once per served batch of its kind."""
    from repro_torch.engine import plans
    from repro_torch.serve import QueryServer
    edges, n = _serve_graph()
    direct = _card_engine(edges, n, layout)
    rng = np.random.default_rng(3)
    work = []
    for c in range(8):
        reqs = []
        for j in range(12):
            kind = ("degrees", "union", "intersection")[(c + j) % 3]
            if kind == "union":
                arg = [rng.integers(0, n, int(rng.integers(1, 30)))
                       for _ in range(int(rng.integers(1, 9)))]
            elif kind == "intersection":
                arg = edges[rng.integers(0, len(edges), int(rng.integers(1, 65)))]
            else:
                arg = None
            reqs.append((kind, arg))
        work.append(reqs)
    want = [[direct.degrees() if k == "degrees" else
             direct.union_size(a) if k == "union" else
             direct.intersection_size(a) for k, a in reqs] for reqs in work]
    got = [[None] * 12 for _ in range(8)]
    eng = _card_engine(edges, n, layout)
    eng._plan_cache = plans.PlanCache(maxsize=64)
    with QueryServer(eng) as srv:
        _build.reset_launch_counts()

        def client(c):
            for j, (kind, arg) in enumerate(work[c]):
                got[c][j] = (srv.degrees() if kind == "degrees" else
                             srv.union_size(arg) if kind == "union" else
                             srv.intersection_size(arg))
        _run_threads(client, 8)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        stats = srv.stats()
    for c in range(8):
        for j in range(12):
            assert np.array_equal(got[c][j], want[c][j]), (c, j)
    name = (lambda k: _build.kernel_name(k, layout))
    assert counts[name("hll_estimate_stats")] == stats["degrees"]["batches"]
    assert counts[name("union_estimate_stats")] == stats["union"]["batches"]
    assert (counts[name("intersection_stats")]
            == stats["intersection"]["batches"])
    assert stats["requests_total"] == 96


def test_continuous_server_on_the_card(dev):
    """A writer ingesting 8 blocks while 8 reader threads query: every
    answer equals the direct call at the version that served it, the
    flushed registers equal a one-shot build, one lease clone a
    rotation."""
    import threading
    from repro_torch.engine import plans
    from repro_torch.serve import ContinuousServer, RotationPolicy
    edges, n = _serve_graph()
    base = len(edges) // 2
    blocks = np.array_split(edges[base:], 8)
    sets = [np.arange(7), np.arange(100, 140, 3)]
    pairs = edges[:48].astype(np.int64)
    eng = _card_engine(edges[:base], n)
    refs = {}  # writer version -> (degrees, unions, intersections)
    for k in range(9):
        ref = _card_engine(edges[: base + sum(map(len, blocks[:k]))], n)
        refs[eng.version + k] = (ref.degrees(), ref.union_size(sets),
                                 ref.intersection_size(pairs))
    first = eng.snapshot()
    seen = []
    stop = threading.Event()
    plans.reset_event_counts()
    with ContinuousServer(eng, rotation=RotationPolicy(every_blocks=2)) as srv:
        def reader(i):
            kind, payload = (("degrees", ()), ("union", (sets, False)),
                             ("intersection", (pairs, False, "mle",
                                               50)))[i % 3]
            while not stop.is_set():
                req = srv._submit(kind, payload, None)
                assert req.done.wait(timeout=SERVE_WAIT)
                seen.append((i % 3, req.epoch, req.wait()))

        failed = []

        def run_readers():
            try:
                _run_threads(reader, 8)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                failed.append(e)

        readers = threading.Thread(target=run_readers, daemon=True)
        readers.start()
        for blk in blocks:
            srv.ingest(blk)
        srv.flush(timeout=SERVE_WAIT)
        stop.set()
        readers.join(timeout=2 * SERVE_WAIT)
        assert not readers.is_alive() and not failed, failed
        rotations = srv.stats()["snapshot"]["rotations"]
        final = srv._slot.get()
        assert torch.equal(final.regs, _card_engine(edges, n).regs)
    assert seen
    for which, epoch, answer in seen:
        assert np.array_equal(answer, refs[epoch][which]), (which, epoch)
    assert plans.event_counts().get("lease_clone", 0) == rotations >= 1
    assert first.regs.untyped_storage().data_ptr() != \
        final.regs.untyped_storage().data_ptr()


# ------------------------------------------- functional API and impl="ref"
# The functional core API, the colored planes and Algorithm 2's hop loop on
# the card against the same calls on the CPU: registers, planes and the
# harmonic statistics bit for bit (both devices sum exactly and round
# once); estimates to rtol=1e-6 (``torch.log`` of the linear-counting
# branch may differ by an ulp between the devices); the MLE of
# ``count_and`` to 1e-4 of its value. ``impl="ref"`` on the card against
# ``impl="cuda"`` on the card: bit for bit, with no launch, but for the
# MLE's answers, whose plain Newton steps sum in another order than the
# ``intersection_newton`` kernel: 1e-4 of the estimates' scale, as the card
# is held to the CPU.

def _graph(scale, seed):
    from repro_torch.graph import generators
    return generators.rmat(scale, 8, seed=seed), 1 << scale


@pytest.mark.parametrize("p", [4, 8, 12])
def test_functional_hll_on_the_card_matches_the_cpu(dev, p):
    from repro_torch.core import hll, intersection
    from repro_torch.core.hll import HLLConfig
    rng = np.random.default_rng(p + 70)
    cfg = HLLConfig(p=p)
    v, e = 301, 40_000
    base = rng.integers(0, 9, (v, cfg.r)).astype(np.uint8)
    rows = rng.integers(0, v, e).astype(np.int32)
    keys = rng.integers(0, 2 ** 32, e, dtype=np.uint64).astype(np.uint32)
    mask = rng.random(e) < 0.7
    on = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        regs = torch.from_numpy(base).to(d)
        tab = hll.insert_table(regs, rows, keys, cfg, mask=mask)
        assert torch.equal(regs.cpu(), torch.from_numpy(base))  # unchanged
        one = hll.insert(tab[3], keys[:500], cfg)
        a, b = tab[: v // 2], tab[v // 2: 2 * (v // 2)]
        on[name] = dict(
            tab=tab, one=one, merged=hll.merge(a, b),
            est=hll.estimate(tab, cfg), one_est=hll.estimate(one, cfg),
            flaj=hll.estimate_flajolet(tab, cfg),
            union=hll.estimate_union(a, b, cfg),
            deg=hll.degree_estimates(tab, cfg),
            ie=intersection.inclusion_exclusion(a, b, cfg),
            dom=torch.stack(intersection.domination_flags(a, b)))
        if p in (8, 12):
            on[name]["beta"] = hll.estimate_beta(tab, HLLConfig(p=p))
    for key, want in on["cpu"].items():
        got = on["card"][key]
        assert got.device.type == "cuda", key
        if got.dtype in (torch.uint8, torch.bool):
            assert torch.equal(got.cpu(), want), key
        elif key == "ie":  # a difference keeps its terms' rounding
            a, b = on["cpu"]["tab"][: v // 2], on["cpu"]["tab"][v // 2:
                                                               2 * (v // 2)]
            scale = sum(hll.estimate(x, cfg).abs()
                        for x in (a, b, hll.merge(a, b)))
            assert bool(((got.cpu() - want).abs() <= 1e-6 * scale).all())
        else:
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-6, atol=0, err_msg=key)
    # the card's registers through the kernels, counted
    before = _build.launch_counts()
    hll.insert_table(on["card"]["tab"], rows, keys, cfg)
    hll.estimate(on["card"]["tab"], cfg)
    after = _build.launch_counts()
    assert after["hll_accumulate"] == before["hll_accumulate"] + 1
    assert after["hll_estimate_stats"] == before["hll_estimate_stats"] + 1


def test_functional_stats_on_the_card_are_exact(dev):
    """The card's (s, z) equal the CPU plain version's bit for bit (both
    the exact sum rounded once), at registers up to 44 = 52 - p."""
    from repro_torch.kernels import hll_estimate
    rng = np.random.default_rng(77)
    regs = torch.from_numpy(rng.integers(0, 45, (999, 256))
                            .astype(np.uint8))
    got = hll_estimate.hll_estimate_stats(regs.to(dev)).cpu()
    assert torch.equal(got, hll_estimate.plain(regs))


@pytest.mark.parametrize("block", [1 << 15, 1000])
def test_degreesketch_on_the_card_matches_the_cpu(dev, block):
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    edges, n = _graph(10, 21)
    cfg = HLLConfig(p=8)
    before = _build.launch_counts()["hll_accumulate"]
    card = dsk.accumulate(edges, n, cfg, block=block)  # default: the card
    assert _build.launch_counts()["hll_accumulate"] - before == \
        -(-2 * len(edges) // block)
    cpu = dsk.accumulate(edges, n, cfg, device="cpu")
    assert card.regs.device.type == "cuda"
    assert torch.equal(card.regs.cpu(), cpu.regs)
    before = _build.launch_counts()
    local, glob, d3 = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                 sketch=card)
    after = _build.launch_counts()
    assert after["hll_propagate"] - before["hll_propagate"] == 2
    assert after["hll_estimate_stats"] - before["hll_estimate_stats"] == 3
    w_local, w_glob, w3 = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                     device="cpu")
    assert torch.equal(d3.regs.cpu(), w3.regs)
    np.testing.assert_allclose(local, w_local, rtol=1e-6, atol=0)
    np.testing.assert_allclose(glob, w_glob, rtol=1e-6, atol=0)
    eng = engine.build(edges, n, cfg)
    e_local, e_glob = eng.neighborhood(3)
    assert np.array_equal(local, e_local) and np.array_equal(glob, e_glob)


def test_colored_on_the_card_matches_the_cpu(dev):
    from repro_torch.core import colored, degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    edges, n = _graph(10, 23)
    colors = np.random.default_rng(5).integers(0, 3, n)
    cfg = HLLConfig(p=8)
    before = _build.launch_counts()
    card = colored.colored_neighborhood(
        colored.colored_accumulate(edges, colors, n, cfg), edges, 2)
    after = _build.launch_counts()
    assert after["hll_accumulate"] - before["hll_accumulate"] == 1
    assert after["hll_propagate"] - before["hll_propagate"] == 3
    cpu = colored.colored_neighborhood(
        colored.colored_accumulate(edges, colors, n, cfg, device="cpu"),
        edges, 2)
    assert torch.equal(card.regs.cpu(), cpu.regs)
    _, _, d2 = dsk.neighborhood_estimates(edges, n, cfg, 2)
    assert torch.equal(card.regs.amax(dim=0), d2.regs)
    for x in (0, 5, 77):
        for c in range(3):
            np.testing.assert_allclose(card.count(x, c), cpu.count(x, c),
                                       rtol=1e-6)
            np.testing.assert_allclose(card.count_not(x, c),
                                       cpu.count_not(x, c), rtol=1e-6)
        a, b = card.count_and(x, 0, 1), cpu.count_and(x, 0, 1)
        assert abs(a - b) <= 1e-4 * abs(b)


@pytest.mark.parametrize("impl", ["cuda", "ref"])
@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_neighborhood_estimates_keep_the_sketchs_layout_and_impl(dev, layout,
                                                                 impl):
    """A sketch of either layout and impl is advanced as it is: equal to
    the engine of that layout and impl on the card bit for bit, kernels
    launched for "cuda" and none for "ref"."""
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.hll import HLLConfig
    edges, n = _graph(12, 8)
    cfg = HLLConfig(p=8)
    eng = engine.build(edges, n, cfg, layout=layout, impl=impl)
    want = eng.neighborhood(3)
    ds = dsk.DegreeSketch(regs=eng.regs, n=n, cfg=cfg, layout=layout,
                          impl=impl)
    _build.reset_launch_counts()
    local, glob, out = dsk.neighborhood_estimates(edges, n, cfg, 3,
                                                  sketch=ds)
    launched = sum(_build.launch_counts().values())
    assert (out.layout, out.impl) == (layout, impl)
    assert launched == (0 if impl == "ref" else 5)
    assert np.array_equal(local, want[0]) and np.array_equal(glob, want[1])


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_ref_impl_on_the_card_launches_nothing_and_equals_cuda(dev, layout):
    from repro_torch import engine
    from repro_torch.core import degreesketch as dsk
    from repro_torch.core.ads import ADSConfig
    from repro_torch.core.hll import HLLConfig
    edges, n = _graph(10, 3)
    rng = np.random.default_rng(3)
    pairs = edges[rng.choice(len(edges), 128, replace=False)]
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(50)]

    def answers(eng):
        exact = [eng.regs.cpu().numpy(), eng.degrees(), *eng.neighborhood(3),
                 eng.union_size(sets),
                 eng.intersection_size(pairs, method="ie")]
        mle = {"pairs": eng.intersection_size(pairs, iters=10)}
        for mode in ("edge", "vertex"):
            mle[mode] = eng.triangle_heavy_hitters(10, mode=mode,
                                                   iters=10)[:2]
        return exact, mle

    cuda_eng = engine.build(edges, n, HLLConfig(p=8), layout=layout)
    cuda, cuda_mle = answers(cuda_eng)
    _build.reset_launch_counts()
    ref_eng = engine.build(edges, n, HLLConfig(p=8), layout=layout,
                           impl="ref")
    assert ref_eng.device.type == "cuda" and ref_eng.impl == "ref"
    ref, ref_mle = answers(ref_eng)
    if layout == "byte":
        ads = engine.build(edges, n, ADSConfig(p=8), impl="ref")
        ref_hist = ads.distance_histogram(3)
    assert set(_build.launch_counts().values()) == {0}
    for a, b in zip(ref, cuda):
        assert np.array_equal(a, b)
    deg = cuda[1]
    # |A u B| <= |A| + |B|: the terms of the difference, as in the tests
    ptol = 1e-4 * (np.abs(cuda_mle["pairs"])
                   + 2 * (deg[pairs[:, 0]] + deg[pairs[:, 1]]))
    assert np.all(np.abs(ref_mle["pairs"] - cuda_mle["pairs"]) <= ptol)
    est = dsk.edge_triangle_estimates(
        dsk.DegreeSketch(regs=cuda_eng.regs, n=n, cfg=cuda_eng.cfg,
                         layout=layout), edges, iters=10)
    tol = 1e-4 * (np.abs(est) + 2 * (deg[edges[:, 0]] + deg[edges[:, 1]]))
    vtol = (np.bincount(edges[:, 0], tol, n)
            + np.bincount(edges[:, 1], tol, n)) / 2
    for mode, atol in (("edge", tol.max()), ("vertex", vtol.max())):
        (tot, vals), (w_tot, w_vals) = ref_mle[mode], cuda_mle[mode]
        assert abs(tot - w_tot) <= tol.sum() / 3
        np.testing.assert_allclose(vals, w_vals, rtol=0, atol=atol)
    if layout == "byte":
        want = engine.build(edges, n, ADSConfig(p=8)).distance_histogram(3)
        for a, b in zip(ref_hist, want):
            assert np.array_equal(a, b)


# Two-panel propagate (hll_propagate_into / _packed): the sharded
# schedules' merge ``out[dst] max= src_panel[src]`` in place. Panels of
# other row counts, src == dst pairs that name two different vertices (a
# skip would drop them), hub segments that cross run boundaries, and an
# empty routing (no launch).

def _into_case(rng, case, v_src, v_out):
    """(src, dst) numpy routing of ``case`` (unsorted). The wrapper cuts
    a routing into runs of ``hll_propagate.run_edges`` edges: the
    shortest run on a card this size for every case here."""
    src = rng.integers(0, v_src, 3_000)
    dst = rng.integers(0, v_out, 3_000)
    if case == "self_index":  # every pair src == dst, over a whole run
        k = min(v_src, v_out)
        src = dst = np.repeat(np.arange(k), 2_100 // k + 1)[:2_100]
    elif case == "hub":  # segments of 2,049-2,500 edges: every one crosses
        lens = rng.integers(2_049, 2_500, 3)
        dst = np.concatenate([np.repeat(rng.choice(v_out, 3, replace=False),
                                        lens), dst[:500]])
        src = rng.integers(0, v_src, dst.shape[0])
    elif case == "short":  # fewer edges than one wave of runs
        src, dst = src[:97], dst[:97]
    elif case == "hub_runs":  # one segment across a hundred short runs
        dst = np.concatenate([dst[:400], np.full(
            100 * hll_propagate.RUN_EDGES_MIN + 5, v_out // 2)])
        src = rng.integers(0, v_src, dst.shape[0])
    elif case == "replica":  # a 1,024-row source panel, skewed sources
        src = np.minimum(rng.zipf(1.3, 20_000) - 1, v_src - 1)
        dst = rng.integers(0, v_out, src.shape[0])
    elif case == "empty":
        src = dst = np.zeros(0, np.int64)
    return src, dst


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
@pytest.mark.parametrize("case", ["v_src_less", "v_src_more", "self_index",
                                  "hub", "short", "hub_runs", "replica",
                                  "empty"])
def test_propagate_into_matches_plain(dev, layout, p, case):
    rng = np.random.default_rng(p * 11 + len(case))
    v_src, v_out = {"v_src_less": (37, 301), "v_src_more": (301, 37),
                    "replica": (1_024, 3_000)}.get(case, (200, 200))
    make = ((lambda v: _packed_panel(rng, v, p, dev)) if layout == "packed"
            else (lambda v: _panel(rng, v, p, 40, dev)))
    src_panel, out = make(v_src), make(v_out)
    out[rng.random(v_out) < 0.3] = 0
    src_t, dst_t = _routing(*_into_case(rng, case, v_src, v_out), dev)
    want = hll_propagate.plain_into(out.clone(), src_panel, src_t, dst_t,
                                    layout=layout)
    name = _build.kernel_name("hll_propagate_into", layout)
    if case == "empty":
        before = _build.launch_counts()[name]
        got = hll_propagate.hll_propagate_into(out.clone(), src_panel, src_t,
                                               dst_t, layout=layout)
        assert _build.launch_counts()[name] == before
    else:
        target = out.clone()
        got = _launched(name, lambda: hll_propagate.hll_propagate_into(
            target, src_panel, src_t, dst_t, layout=layout))
        assert got.data_ptr() == target.data_ptr()  # in place
    assert torch.equal(got, want)
    if case == "self_index":  # the merges took: a skip would leave out
        assert not torch.equal(got, out)


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_propagate_into_checks_its_panels(dev, layout):
    rng = np.random.default_rng(5)
    make = ((lambda v: _packed_panel(rng, v, 6, dev)) if layout == "packed"
            else (lambda v: _panel(rng, v, 6, 40, dev)))
    out, other = make(16), make(16)
    src = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    dst = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="non-decreasing"):
        hll_propagate.hll_propagate_into(out, other, src, dst, layout=layout)
    with pytest.raises(ValueError, match="overlaps"):
        hll_propagate.hll_propagate_into(out, out[4:], src, dst.sort()[0],
                                         layout=layout)
    with pytest.raises(ValueError, match="registers"):
        hll_propagate.hll_propagate_into(out, make(16)[:, :8].contiguous(),
                                         src, dst.sort()[0], layout=layout)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 16])
@pytest.mark.parametrize("case", ["hub_runs", "replica"])
@pytest.mark.parametrize("run", [1, 64, 128, 256])
def test_propagate_into_launcher_at_each_run_length(dev, layout, p, case,
                                                    run):
    """The launcher called with the run lengths the sharded schedules
    take (128 at a ring step, 256 at an all-gather merge, 64 at a replica
    pre-pass) and a run of one edge, on routings whose segments cross
    many run ends: equal to the plain version."""
    rng = np.random.default_rng(p * 7 + run + len(case))
    v_src, v_out = (1_024, 3_000) if case == "replica" else (200, 200)
    make = ((lambda v: _packed_panel(rng, v, p, dev)) if layout == "packed"
            else (lambda v: _panel(rng, v, p, 40, dev)))
    src_panel, out = make(v_src), make(v_out)
    out[rng.random(v_out) < 0.3] = 0
    src_t, dst_t = _routing(*_into_case(rng, case, v_src, v_out), dev)
    want = hll_propagate.plain_into(out.clone(), src_panel, src_t, dst_t,
                                    layout=layout)
    fn = getattr(_build.library(),
                 _build.kernel_name("hll_propagate_into", layout))
    assert fn(src_panel.data_ptr(), out.data_ptr(), src_t.data_ptr(),
              dst_t.data_ptr(), src_t.numel(), v_src, v_out, 1 << p, run,
              _build.stream_of(out)) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("run", [0, -1, 1 << 31])
def test_propagate_into_launcher_refuses_a_bad_run_length(dev, layout, run):
    """The launcher returns an error for a run length outside [1, 2^31)
    and launches nothing; a run of one edge is taken."""
    rng = np.random.default_rng(9)
    out, other = _panel(rng, 16, 6, 40, dev), _panel(rng, 16, 6, 40, dev)
    src = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    dst = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    fn = getattr(_build.library(),
                 _build.kernel_name("hll_propagate_into", layout))
    r = 64  # registers a row: 64 bytes, or 32 packed
    w = r // 2 if layout == "packed" else r
    out, other = out[:, :w].contiguous(), other[:, :w].contiguous()
    args = (other.data_ptr(), out.data_ptr(), src.data_ptr(),
            dst.data_ptr(), 2, 16, 16, r)
    stream = _build.stream_of(out)
    before = out.clone()
    assert fn(*args, run, stream) != 0
    torch.cuda.synchronize()
    assert torch.equal(out, before)
    assert fn(*args, 1, stream) == 0
    want = hll_propagate.plain_into(before, other, src, dst, layout=layout)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_engine_on_the_card_equals_local(dev, layout, shards):
    """The sharded engine on one card (``shards`` panels, real copies
    between them) answers as the local engine on the card, bit for bit,
    every schedule running the two-panel launcher."""
    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.distributed import sketch_dist as sd
    edges, n = _graph(11, 4)
    rng = np.random.default_rng(4)
    pairs = edges[rng.choice(len(edges), 256, replace=False)]
    sets = [rng.integers(0, n, rng.integers(1, 70)) for _ in range(64)]
    local = engine.build(edges, n, HLLConfig(p=8), layout=layout)
    eng = engine.build(edges, n, HLLConfig(p=8), layout=layout,
                       backend="sharded", shards=shards)
    assert [p.device.type for p in eng.shard_regs] == ["cuda"] * shards
    assert torch.equal(eng.regs[:n], local.regs[:n])
    assert np.array_equal(eng.degrees(), local.degrees())
    want = local.neighborhood(3)
    name = _build.kernel_name("hll_propagate_into", layout)
    for schedule in ("ring", "ring_overlap", "allgather"):
        before = _build.launch_counts()[name]
        sd.reset_copied_bytes()
        got = eng.neighborhood(3, schedule=schedule)
        assert _build.launch_counts()[name] > before
        if shards > 1:
            moved = sd.copied_bytes()
            assert moved["ppermute" if "ring" in schedule
                         else "all_gather"] > 0
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
    eng.replicate(np.argsort(-np.bincount(edges.ravel()))[:16])
    for schedule in ("ring_overlap", "allgather"):
        eng._panel_set = None
        got = eng.neighborhood(3, schedule=schedule)
        assert np.array_equal(got[0], want[0])
    assert np.array_equal(eng.union_size(sets), local.union_size(sets))
    assert np.array_equal(eng.intersection_size(pairs, iters=10),
                          local.intersection_size(pairs, iters=10))
    a = eng.query_batch(degrees=True, vertex_sets=sets, pairs=pairs)
    b = local.query_batch(degrees=True, vertex_sets=sets, pairs=pairs)
    assert all(np.array_equal(a[k], b[k]) for k in b)
    for mode in ("edge", "vertex"):
        tot, vals, _ = eng.triangle_heavy_hitters(10, mode=mode, iters=10)
        w_tot, w_vals, _ = local.triangle_heavy_hitters(10, mode=mode,
                                                        iters=10)
        assert abs(tot - w_tot) <= 1e-9 * abs(w_tot)
        assert np.allclose(vals, w_vals, rtol=1e-9)


@pytest.mark.parametrize("backend", ["local", "sharded"])
def test_coordinator_kill_on_the_card_equals_local(dev, backend, tmp_path):
    """A kill-one-host run on the card (4 hosts; the sharded engine
    reloads at 3 shards) equals an uninterrupted local build on the card
    bit for bit, and its blocks launched the accumulate kernel."""
    import importlib

    from repro_torch import engine
    from repro_torch.core.hll import HLLConfig
    from repro_torch.runtime.faults import FaultInjector, KillHost
    from repro_torch.runtime.ft import FTConfig
    coord = importlib.import_module("repro_torch.runtime.coordinator")
    edges, n = _graph(11, 5)
    before = _build.launch_counts()["hll_accumulate"]
    eng, stats = coord.coordinator(
        edges, n, HLLConfig(p=8), ft=FTConfig(ckpt_dir=str(tmp_path / "c")),
        config=coord.CoordinatorConfig(hosts=4, block=2048, ckpt_every=4),
        faults=FaultInjector(faults=(KillHost(host=2, at_block=6),)),
        backend=backend, replicate=[0, 1, 2, 3], device="cuda")
    torch.cuda.synchronize()
    blocks = -(-len(edges) // 2048)
    assert _build.launch_counts()["hll_accumulate"] - before >= blocks
    assert stats["recoveries"] == stats["evictions"] == 1
    assert stats["hosts_alive"] == 3 and stats["blocks_replayed"] == 2
    assert eng.device.type == "cuda" and eng.m == len(edges)
    if backend == "sharded":
        assert eng.shards == 3
        assert [p.device.type for p in eng.shard_regs] == ["cuda"] * 3
    ref = engine.build(edges, n, HLLConfig(p=8))
    assert torch.equal(eng.regs[:n], ref.regs[:n])
    assert np.array_equal(eng.degrees(), ref.degrees())
    sets = [[0, 1, 2], list(range(5, 60))]
    assert np.array_equal(eng.union_size(sets), ref.union_size(sets))
    want = ref.neighborhood(3)
    for schedule in ("ring", "ring_overlap", "allgather"):
        for a, b in zip(eng.neighborhood(3, schedule=schedule), want):
            assert np.array_equal(a, b)
    assert np.array_equal(eng.replicated_ids, [0, 1, 2, 3])


def test_train_loop_restarts_on_the_card(dev, tmp_path):
    """``train_loop`` on CUDA tensors: a restart restores step 6 onto the
    card, in the template's dtypes."""
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.runtime.ft import FTConfig, train_loop

    def step_fn(params, opt, batch, step):
        assert batch["tokens"].device.type == "cuda"
        return ({"w": params["w"] + 1, "b": params["b"] * 2}, opt + 1,
                {"loss": params["w"].sum()})

    def run(steps):
        return train_loop(
            step_fn=step_fn,
            params={"w": torch.zeros(4, device=dev),
                    "b": torch.ones(2, dtype=torch.bfloat16, device=dev)},
            opt_state=torch.zeros((), dtype=torch.int64, device=dev),
            corpus=SyntheticCorpus(vocab_size=64, seq_len=8, global_batch=2),
            num_steps=steps, ft=FTConfig(ckpt_dir=str(tmp_path),
                                         ckpt_every=3),
            to_device=lambda b: {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()}, log_every=0)

    p, o, hist = run(7)
    assert hist["loss"] == [4.0 * s for s in range(7)]
    p, o, hist = run(9)
    assert hist["restored_from"] == 6 and hist["loss"] == [28.0, 32.0]
    assert p["w"].device.type == "cuda" and p["w"].tolist() == [9.0] * 4
    assert p["b"].dtype == torch.bfloat16 and p["b"].device.type == "cuda"
    assert p["b"].tolist() == [512.0, 512.0] and int(o) == 9


def test_telemetry_on_the_card_matches_the_cpu(dev):
    """``RoutingSketch`` and ``NGramSketch`` on the card: registers equal
    the CPU's byte for byte; an update is one accumulate launch and
    ``collapse_score`` one ``ertl_stats`` launch for every pair."""
    from repro_torch.core.hll import HLLConfig
    from repro_torch.data.telemetry import NGramSketch, RoutingSketch
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 50_000, size=(8, 512))
    experts = np.argsort(rng.random((tokens.size, 16)), axis=1)[:, :3]
    rs = RoutingSketch(16, HLLConfig(p=10))
    want = rs.update(rs.init(device="cpu"), experts, tokens.ravel())
    table = _launched("hll_accumulate", lambda: rs.update(
        rs.init(), torch.from_numpy(experts).to(dev),
        torch.from_numpy(tokens.ravel()).to(dev)))
    assert table.device.type == "cuda" and torch.equal(table.cpu(), want)
    assert np.allclose(rs.coverage(table).cpu().numpy(),
                       rs.coverage(want).numpy(), rtol=1e-6)
    jac = _launched("ertl_stats", lambda: rs.collapse_score(table))
    assert np.allclose(jac, rs.collapse_score(want), rtol=0, atol=1e-4)
    ns = NGramSketch(n=3, cfg=HLLConfig(p=12))
    want = ns.update(ns.init(device="cpu"), tokens)
    sk = _launched("hll_accumulate", lambda: ns.update(ns.init(), tokens))
    assert sk.device.type == "cuda" and torch.equal(sk.cpu(), want)
    from repro_torch.data import telemetry
    hashes = [telemetry._window_hashes(telemetry._int64_on(tokens, d), 3)
              for d in (dev, torch.device("cpu"))]
    assert hashes[0].is_cuda and torch.equal(hashes[0].cpu(), hashes[1])
    assert abs(ns.distinct(sk) - ns.distinct(want)) <= 1e-6 * ns.distinct(
        want)


# --------------------------------------------------------------- autotune
_TUNED = [(op, layout) for op in ("accumulate", "propagate", "estimate",
                                  "union_estimate", "intersection_stats",
                                  "ertl_stats", "hip_delta")
          for layout in ("byte", "packed")
          if not (op == "hip_delta" and layout == "packed")]


def _tuned_case(op, layout, p, size, dev):
    """(``run(**block)`` through the op's wrapper, its plain result, its
    launcher) for one op and layout at ``size`` rows (edges, pairs, sets
    scale with it); registers below 30, where every byte sum is exact."""
    rng = np.random.default_rng(p * 101 + size + len(op))
    packed = layout == "packed"

    def panel(v):
        return (_packed_panel(rng, v, p, dev) if packed
                else _panel(rng, v, p, 30, dev))

    def ids(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(
            np.int32)).to(dev)
    kw = {"layout": layout}
    q = 64 - p
    if op == "accumulate":
        w = (1 << p) // (2 if packed else 1)
        e = 37 * size + 5
        rows, keys = ids(size, e), ids(1 << 31, e).view(torch.uint32)
        mask = torch.from_numpy(rng.random(e) < 0.8).to(dev)
        fresh = torch.zeros((size, w), dtype=torch.uint8, device=dev)
        want = hll_accumulate.plain(fresh.clone(), rows, keys, mask, p=p,
                                    seed=5, layout=layout)
        return (lambda **b: hll_accumulate.hll_accumulate(
            fresh.clone(), rows, keys, mask, p=p, seed=5, **kw, **b), want)
    if op == "propagate":
        regs = panel(size)
        src, dst = _routing(rng.integers(0, size, 23 * size),
                            rng.integers(0, size, 23 * size), dev)
        want = hll_propagate.plain(regs, src, dst, layout=layout)
        return (lambda **b: hll_propagate.hll_propagate(regs, src, dst, **kw,
                                                        **b), want)
    if op == "estimate":
        regs = panel(size)
        return (lambda **b: hll_estimate.hll_estimate_stats(regs, **kw, **b),
                hll_estimate.plain(regs, layout=layout))
    if op == "union_estimate":
        regs = panel(size)
        lanes = 70 if size > 100 else 20  # shared windows, then owned
        sets = ids(size, (size // 3 + 1, lanes))
        mask = torch.from_numpy(rng.random(tuple(sets.shape)) < 0.6).to(dev)
        return (lambda **b: union_estimate.union_estimate_stats(
            regs, sets, mask, **kw, **b),
            union_estimate.plain(regs, sets, mask, layout=layout))
    if op == "intersection_stats":
        regs = panel(size)
        pa, pb = ids(size, 2 * size + 1), ids(size, 2 * size + 1)
        return (lambda **b: intersection_stats.intersection_stats(
            regs, pa, pb, q, **kw, **b),
            intersection_stats.plain(regs, pa, pb, q, layout=layout))
    if op == "ertl_stats":
        a, c = panel(size), panel(size)
        return (lambda **b: ertl_stats.ertl_stats(a, c, q, **kw, **b),
                ertl_stats.plain(a, c, q, layout=layout))
    prev = _panel(rng, size, p, 30, dev)
    cur = (prev.to(torch.int16) + ids(6, prev.shape) - 2).clamp(0, 40).to(
        torch.uint8)
    return (lambda **b: hip_delta.hip_delta_rows(prev, cur, **b),
            hip_delta.plain(prev, cur))


@pytest.mark.parametrize("size", [64, 1001])
@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("op,layout", _TUNED)
def test_every_launch_shape_matches_plain(dev, op, layout, p, size):
    """Every value of the op's autotune grid launches its kernel once and
    equals the plain version bit for bit, at small and ragged shapes."""
    from repro_torch.kernels import autotune
    run, want = _tuned_case(op, layout, p, size, dev)
    name = {"accumulate": "hll_accumulate", "propagate": "hll_propagate",
            "estimate": "hll_estimate_stats",
            "union_estimate": "union_estimate_stats",
            "intersection_stats": "intersection_stats",
            "ertl_stats": "ertl_stats", "hip_delta": "hip_delta_rows"}[op]
    for cand in autotune.SWEEPS[op]:
        got = _launched(_build.kernel_name(name, layout),
                        lambda: run(**cand))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), cand


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_launchers_refuse_an_off_grid_shape(dev, layout):
    """A launcher given a block outside its grid returns an error and
    launches nothing (the wrappers refuse it before any launch)."""
    rng = np.random.default_rng(4)
    regs = _packed_panel(rng, 16, 6, dev) if layout == "packed" else _panel(
        rng, 16, 6, 30, dev)
    out = torch.full((16, 2), -1.0, device=dev)
    fn = getattr(_build.library(),
                 _build.kernel_name("hll_estimate_stats", layout))
    stream = _build.stream_of(regs)
    for bad in (0, 64, 384, 1024):
        assert fn(regs.data_ptr(), out.data_ptr(), 16, 64, bad, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == -1.0).all())
    assert fn(regs.data_ptr(), out.data_ptr(), 16, 64, 128, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, hll_estimate.plain(regs, layout=layout))
    with pytest.raises(ValueError, match="grid"):
        hll_estimate.hll_estimate_stats(regs, layout=layout, row_block=64)


def test_card_sweep_drives_each_candidate_once():
    """On the card a sweep times every candidate of the op once and caches
    the winner (the fallback unless beaten by more than the margin); a
    second sweep drives none; ``impl="ref"`` drives none. A sweep on the
    caller's inputs fills their size class only and writes none of
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels run only on the card)")
    from repro_torch.kernels import autotune
    autotune.clear_cache()
    try:
        before = autotune.drive_count()
        got = autotune.sweep("estimate", p=8, layout="packed")
        grid = autotune.SWEEPS["estimate"]
        assert autotune.drive_count() == before + len(grid)
        times = autotune.sweep_times("estimate", p=8, layout="packed")
        assert [c for c, _ in times] == grid
        assert got == autotune.pick_winner("estimate", times)
        assert autotune.sweep("estimate", p=8, layout="packed") == got
        assert autotune.sweep("estimate", p=8, impl="ref") == (
            autotune.FALLBACK["estimate"])
        assert autotune.drive_count() == before + len(grid)
        assert autotune.device_kind() == torch.cuda.get_device_name()
        gen = torch.Generator(device="cuda").manual_seed(3)
        regs = torch.randint(0, 16, (5000, 256), generator=gen,
                             device="cuda", dtype=torch.uint8)
        rows = torch.randint(0, 5000, (70000,), generator=gen, device="cuda",
                             dtype=torch.int32)
        keys = torch.randint(0, 1 << 31, (70000,), generator=gen,
                             device="cuda", dtype=torch.int32)
        keep = regs.clone()
        got = autotune.sweep("accumulate", p=8,
                             inputs=(regs, rows, keys.view(torch.uint32)))
        grid = autotune.SWEEPS["accumulate"]
        times = autotune.sweep_times("accumulate", p=8, size=70000)
        assert [c for c, _ in times] == grid
        assert got == autotune.pick_winner("accumulate", times)
        assert autotune.sweep_times("accumulate", p=8) == []
        assert torch.equal(regs, keep)
    finally:
        autotune.clear_cache()


# ------------------------------------------------------- LM serving path
_LM_ARCHS = ["gemma2-9b", "grok-1-314b", "jamba-v0.1-52b", "llava-next-34b",
             "mamba2-370m", "moonshot-v1-16b-a3b", "phi4-mini-3.8b",
             "qwen2-1.5b", "qwen2-72b", "whisper-large-v3"]


@pytest.fixture
def no_tf32():
    """float32 products in full float32 on the card, as on the CPU."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_model_logits_card_vs_cpu(dev, no_tf32, arch):
    """Every arch at ``reduced()`` in float32 with the same carried
    weights: the prefill's logits and 3 greedy decode steps (fed the
    CPU's tokens) on the card within 1e-4 of the CPU's, which
    ``tests/test_torch_models.py`` holds against the JAX package
    (``models.parity.logits_on_both``, which ``chip_smoke.py`` phase 9m
    also runs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.parity import logits_on_both

    steps = logits_on_both(ARCHS[arch].reduced(), dev, batch=2, length=32,
                           decodes=3, seed=0, data_seed=1)
    assert len(steps) == 4
    for want, got in steps:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_moe_routing_feeds_the_sketch_kernels(dev, no_tf32):
    """``moe_ffn``'s expert ids on the card equal the CPU's, and
    ``RoutingSketch`` over them launches ``hll_accumulate``,
    ``hll_estimate_stats`` and one ``ertl_stats``, its table equal to the
    CPU's byte for byte, its coverage within rtol 1e-6, and ``ertl_stats``
    on every expert pair equal to its plain version bit for bit."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.hll import HLLConfig
    from repro_torch.data.telemetry import RoutingSketch
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as tfm

    cfg = ARCHS["moonshot-v1-16b-a3b"].reduced(num_experts=8,
                                               num_experts_per_tok=2)
    cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = convert.params_from_tree(cfg, convert.params_to_tree(cpu), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 64)))
    ids = []
    for m, d in ((cpu, "cpu"), (gpu, dev)):
        x = tfm.embed_lookup(m, cfg, toks.to(d))
        ids.append(moe.moe_ffn(m.blocks[0].ffn, x, cfg)[2])
    assert torch.equal(ids[0], ids[1].cpu())
    rs = RoutingSketch(cfg.num_experts, HLLConfig(p=10))
    want = rs.update(rs.init("cpu"), ids[0], toks.reshape(-1))
    before = dict(_build.launch_counts())
    table = rs.update(rs.init(dev), ids[1], toks.reshape(-1).to(dev))
    cov = rs.coverage(table)
    jac = rs.collapse_score(table)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["hll_accumulate"] > before["hll_accumulate"]
    assert after["hll_estimate_stats"] > before["hll_estimate_stats"]
    assert after["ertl_stats"] == before["ertl_stats"] + 1
    assert torch.equal(table.cpu(), want)
    np.testing.assert_allclose(cov.cpu().numpy(),
                               rs.coverage(want).numpy(), rtol=1e-6)
    assert jac.shape == (8, 8) and np.isfinite(jac).all()
    i, j = np.triu_indices(cfg.num_experts, k=1)
    a = table[torch.from_numpy(i).to(table.device)]
    b = table[torch.from_numpy(j).to(table.device)]
    assert torch.equal(ertl_stats.ertl_stats(a, b, rs.cfg.q),
                       ertl_stats.plain(a, b, rs.cfg.q))


# ------------------------------------------------------ LM training path
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_train_step_card_vs_cpu(dev, no_tf32, arch):
    """One ``make_train_step`` step of every arch at ``reduced()`` in
    float32 (grok-1's moments in bfloat16) with the same carried weights
    and batch: the loss, every gradient and every updated parameter on the
    card within 1e-4 of the CPU's (``models.parity.step_mismatches``: a
    parameter whose gradient is at its rounding floor, which Adam's first
    step normalises, within 2 x the rate 3e-4, at most a thousandth of
    them), and the CPU's step is what ``tests/test_torch_train.py`` holds
    against the JAX package (``models.parity.train_step_on_both``, which
    ``chip_smoke.py`` phase 9g also runs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.parity import step_mismatches, train_step_on_both

    cpu, gpu = train_step_on_both(ARCHS[arch].reduced(), dev, peak_lr=3e-4,
                                  seed=0, data_seed=1)
    assert gpu["lr"] == cpu["lr"]
    assert gpu["grads"].keys() == cpu["grads"].keys()
    assert gpu["params"].keys() == cpu["params"].keys()
    errs, bad = step_mismatches(cpu, gpu, 1e-4)
    print(f"{arch}: {errs}")     # the floor elements each arch needs
    assert not bad, bad


def test_grad_accum_on_the_card_equals_one_microbatch(dev, no_tf32):
    """qwen2-1.5b reduced: ``grad_accum=2`` on the card against its
    ``grad_accum=1`` step on the same batch, within 1e-5 (floor
    gradients as in ``test_train_step_card_vs_cpu``)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models.parity import step_mismatches, train_step_on_both

    cfg = ARCHS["qwen2-1.5b"].reduced()
    _, one = train_step_on_both(cfg, dev, peak_lr=3e-4)
    _, two = train_step_on_both(replace(cfg, grad_accum=2), dev,
                                peak_lr=3e-4)
    _, bad = step_mismatches(one, two, 1e-5)
    assert not bad, bad


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_compressed_psum_on_the_card(dev, scale):
    """``optim.compressed_psum`` over 4 pods' tensors on the card equals
    the CPU's bit for bit (a shared max scale, int32 accumulation)."""
    from repro_torch.optim import compressed_psum

    x = (np.random.default_rng(7).normal(size=(4, 3, 50_001))
         * scale).astype(np.float32)
    want = compressed_psum([torch.from_numpy(r) for r in x])
    got = compressed_psum([torch.from_numpy(r).to(dev) for r in x])
    assert got.is_cuda and torch.equal(got.cpu(), want)


# ---------------------------------------------------- meshes and hints
def test_production_meshes_refuse_the_card(dev):
    """``make_production_mesh`` over the real cards raises, naming the
    devices the shape needs and the count; ``make_host_mesh`` spans the
    cards (``chip_smoke.py`` phase 9d, part a)."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    n = torch.cuda.device_count()
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError,
                           match=f"needs {need} devices, have {n}"):
            make_production_mesh(multi_pod=multi)
    host = make_host_mesh()
    assert host.shape == {"data": n}
    assert all(d.type == "cuda" for d in host.devices)


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_mesh_hints_change_nothing_on_the_card(dev, no_tf32, arch,
                                               monkeypatch):
    """With ``pshard``'s mesh set to (1, 1) over the card, every arch at
    ``reduced()`` gives prefill logits, 3 decode steps and one train step
    equal bit for bit to the runs with no mesh set, under deterministic
    algorithms (``models.parity.mesh_runs``, which phase 9d runs for two
    archs)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import parity, pshard

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    mesh = Mesh((1, 1), ("data", "model"), (dev,))
    cfg = ARCHS[arch].reduced()
    torch.use_deterministic_algorithms(True)
    try:
        plain = parity.mesh_runs(cfg, dev, None)
        hinted = parity.mesh_runs(cfg, dev, mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    assert parity.mesh_mismatches(plain, hinted) == []
    assert pshard._MESH is None
