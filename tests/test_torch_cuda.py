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
on a 1,024-member set among singletons and on one-lane panels.
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
