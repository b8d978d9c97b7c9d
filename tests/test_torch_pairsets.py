"""The pair- and set-statistics kernels' word-level arithmetic, emulated.

``csrc/intersection_stats.cu`` and ``csrc/union_estimate.cu`` run only on
the card (``tests/test_torch_cuda.py`` holds them against their plain
versions there). Here each trick they use is computed as the kernel
computes it, in numpy uint32 arithmetic, and held against a loop over
the registers, over every 16-bit word (in both halves of a 32-bit word)
and 10^6 random 32-bit words:

* the nonzero-register masks: a carry-free add, then the top bit of each
  byte or nibble (``repro::nonzero_bytes``, ``nonzero_nibbles``);
* the three Eq. 19 bins at value 0, set from the zero counts of A, B and
  A∪B instead of one atomic per register: ``#(a=0<b) = zA - zU``,
  ``#(b=0<a) = zB - zU``, ``#(a=b=0) = zU``;
* the exact byte sum: a carry-free add flags the bytes >= 28, each term
  ``2^(27 - x)`` of the others is one wrapping funnel shift, and the
  rest add ``2^-x`` in float64 (``repro::byte_vec_stats``), rounded to
  float32 once;
* the packed integer sum ``2^(15 - x)`` over split nibbles
  (``repro::packed_word_stats``).

Then the kernels' whole per-pair and per-set algorithms, emulated from
those words (the pair's bins from zero counts plus one key a side for
each register pair with a nonzero side; the union's queue of id
windows shared by a block's warps, compacted by ballot rank and merged
by lane groups), against the port's plain versions, and the plain versions
against the JAX reference on zero-heavy rows (a small graph's
accumulate) and skewed inputs (a hub's pairs, a 1,024-member set among
singletons), in both layouts.

Tolerances: integers (masks, counts, histograms) equal; the emulated
exact sums equal the exact sum rounded once (float64 holds it exactly
at these sizes), and the plain byte sums, float32 sums of the same
terms in another order, within ``rtol=1e-6`` of it; against the JAX
reference ``rtol=1e-6``, as ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import _build, hll_accumulate  # noqa: E402
from repro_torch.kernels import intersection_stats, packing  # noqa: E402
from repro_torch.kernels import ref, union_estimate  # noqa: E402

U32 = np.uint32
FIX_ONE = 1 << 27


@pytest.fixture(autouse=True)
def _no_launches():
    """Every call here takes a plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    yield
    assert set(_build.launch_counts().values()) == {0}


def _words():
    """Every 16-bit word in the low half, the high half and both halves,
    then 10^6 seeded random 32-bit words."""
    v = np.arange(1 << 16, dtype=U32)
    rand = np.random.default_rng(0).integers(0, 1 << 32, 10 ** 6,
                                             dtype=np.uint64).astype(U32)
    return np.concatenate([v, v << U32(16), v | (v << U32(16)), rand])


def _regs(w, bits):
    """Registers of words w: uint32[..., 32 / bits], lowest first."""
    k = np.arange(32 // bits, dtype=U32)
    return (w[..., None] >> (k * U32(bits))) & U32((1 << bits) - 1)


# ------------------------------------------------------ per-word tricks
def nonzero_bytes(w):
    m = U32(0x7F7F7F7F)
    return (((w & m) + m) | w) & U32(0x80808080)


def nonzero_nibbles(w):
    m = U32(0x77777777)
    return (((w & m) + m) | w) & U32(0x88888888)


def nonzero_regs(w, packed):
    return nonzero_nibbles(w) if packed else nonzero_bytes(w)


def popc(w):
    return np.unpackbits(w.view(np.uint8).reshape(*w.shape, 4),
                         axis=-1).sum(axis=-1)


def reg_max(a, b, packed):
    bits = 4 if packed else 8
    k = np.arange(32 // bits, dtype=U32) * U32(bits)
    top = np.maximum(_regs(a, bits), _regs(b, bits))
    return np.bitwise_or.reduce(top << k, axis=-1).astype(U32)


def funnel_r(lo, hi, s):
    """__funnelshift_r: the low 32 bits of (hi:lo) >> (s & 31)."""
    both = (np.uint64(hi) << np.uint64(32)) | np.uint64(lo)
    return ((both >> (s & U32(31)).astype(np.uint64))
            & np.uint64(0xFFFFFFFF)).astype(U32)


def large_bytes(w):
    """Bit 7 of each byte of w that is >= 28."""
    return (((w & U32(0x7F7F7F7F)) + U32(0x64646464)) | w) & U32(0x80808080)


def byte_terms(w):
    """The fast path's fixed-point terms of w's four bytes (each <= 27)."""
    return sum(funnel_r(FIX_ONE, 0, w >> U32(8 * k)).astype(np.uint64)
               for k in range(4))


def packed_terms(w):
    """packed_word_stats's sum of 2^(15 - x) over w's eight nibbles."""
    even, odd = w & U32(0x0F0F0F0F), (w >> U32(4)) & U32(0x0F0F0F0F)
    return sum(funnel_r(0x8000, 0, even >> U32(8 * k)).astype(np.uint64)
               + funnel_r(0x8000, 0, odd >> U32(8 * k)).astype(np.uint64)
               for k in range(4))


@pytest.mark.parametrize("packed", [False, True])
def test_nonzero_masks_match_register_loop(packed):
    w = _words()
    bits = 4 if packed else 8
    regs = _regs(w, bits)
    tops = np.arange(32 // bits, dtype=U32) * U32(bits) + U32(bits - 1)
    want = np.bitwise_or.reduce((regs != 0).astype(U32) << tops, axis=-1)
    np.testing.assert_array_equal(nonzero_regs(w, packed), want)
    np.testing.assert_array_equal(popc(nonzero_regs(w, packed)),
                                  (regs != 0).sum(axis=-1))


@pytest.mark.parametrize("packed", [False, True])
def test_zero_bins_from_zero_counts(packed):
    """The three bins at value 0 and the live mask of a word pair."""
    a = _words()
    b = np.random.default_rng(1).permutation(a)
    b[:1 << 16] = 0  # a's every 16-bit word against an empty word too
    bits, per = (4, 8) if packed else (8, 4)
    x, y = _regs(a, bits), _regs(b, bits)
    za = per - popc(nonzero_regs(a, packed))
    zb = per - popc(nonzero_regs(b, packed))
    zu = per - popc(nonzero_regs(reg_max(a, b, packed), packed))
    np.testing.assert_array_equal(za - zu, ((x == 0) & (y != 0)).sum(-1))
    np.testing.assert_array_equal(zb - zu, ((y == 0) & (x != 0)).sum(-1))
    np.testing.assert_array_equal(zu, ((x == 0) & (y == 0)).sum(-1))
    live = popc(nonzero_regs(a | b, packed))
    np.testing.assert_array_equal(live, ((x != 0) | (y != 0)).sum(-1))


def test_fixed_point_byte_terms():
    w = _words()
    regs = _regs(w, 8)
    big = large_bytes(w)
    tops = np.arange(4, dtype=U32) * U32(8) + U32(7)
    np.testing.assert_array_equal(
        big, np.bitwise_or.reduce((regs >= 28).astype(U32) << tops, axis=-1))
    fast = big == 0
    want = (np.uint64(FIX_ONE) >> regs[fast].astype(np.uint64)).sum(-1)
    np.testing.assert_array_equal(byte_terms(w[fast]), want)


def test_packed_word_terms():
    w = _words()
    regs = _regs(w, 4)
    want = (np.uint64(0x8000) >> regs.astype(np.uint64)).sum(-1)
    np.testing.assert_array_equal(packed_terms(w), want)


def emulated_sums(rows, packed):
    """(s, z) of uint8 rows as the kernels sum them: 16-byte vectors, each
    on the fast path or the byte loop, rounded to float32 once."""
    words = np.ascontiguousarray(rows).view(U32)
    nz = popc(nonzero_regs(words, packed)).sum(-1)
    regs_per_row = rows.shape[1] * (2 if packed else 1)
    if packed:
        fix = packed_terms(words).sum(-1)
        s = (fix.astype(np.float64) * 2.0 ** -15).astype(np.float32)
        return s, (regs_per_row - nz).astype(np.float32)
    vecs = words.reshape(rows.shape[0], -1, min(4, words.shape[1]))
    fast = (large_bytes(vecs) == 0).all(-1)
    regs = _regs(vecs, 8).reshape(*fast.shape, -1)
    slow = ~fast[..., None]
    fix = (np.where(fast, byte_terms(vecs).sum(-1), 0)
           + np.where(slow & (regs <= 27), np.uint64(FIX_ONE)
                      >> np.minimum(regs, 27).astype(np.uint64), 0).sum(-1))
    tiny = np.where(slow & (regs > 27),
                    np.exp2(-regs.astype(np.float32)).astype(np.float64), 0.0)
    fix, tiny = fix.sum(-1), tiny.sum((-1, -2))
    s = (fix.astype(np.float64) / FIX_ONE + tiny).astype(np.float32)
    return s, (regs_per_row - nz).astype(np.float32)


def _exact(regs):
    return np.exp2(-regs.astype(np.float64)).sum(-1).astype(np.float32)


@pytest.mark.parametrize("p", [3, 4, 8, 12])
def test_exact_sums_match_plain(p):
    rng = np.random.default_rng(p)
    rows = rng.integers(0, 24, (37, 1 << p)).astype(np.uint8)
    rows[::4] = 0
    rows[1::5, ::3] = rng.integers(28, 256, rows[1::5, ::3].shape)
    s, z = emulated_sums(rows, packed=False)
    np.testing.assert_array_equal(s, _exact(rows))
    s_p, z_p = ref.hll_estimate_ref(torch.from_numpy(rows))
    np.testing.assert_array_equal(z, z_p.numpy())
    np.testing.assert_allclose(s, s_p.numpy(), rtol=1e-6, atol=0)
    if p >= 4:
        packed = packing.pack_rows(torch.from_numpy(rows)).numpy()
        s, z = emulated_sums(packed, packed=True)
        s_p, z_p = ref.hll_estimate_ref(torch.from_numpy(packed),
                                        layout="packed")
        np.testing.assert_array_equal(s, s_p.numpy())
        np.testing.assert_array_equal(z, z_p.numpy())
        np.testing.assert_array_equal(s, _exact(np.minimum(rows, 15)))


# ------------------------------------------------ whole-kernel emulations
def emulated_pair_stats(regs, pa, pb, q, packed):
    """intersection_stats as the kernel counts: bins at value 0 from zero
    counts, one key a side for each register pair with a nonzero side."""
    bits = 4 if packed else 8
    nb = q + 2
    wa = np.ascontiguousarray(regs[pa]).view(U32)
    wb = np.ascontiguousarray(regs[pb]).view(U32)
    per_row = wa.shape[1] * 32 // bits
    za = per_row - popc(nonzero_regs(wa, packed)).sum(-1)
    zb = per_row - popc(nonzero_regs(wb, packed)).sum(-1)
    zu = per_row - popc(nonzero_regs(reg_max(wa, wb, packed),
                                     packed)).sum(-1)
    hist = np.zeros((len(pa), 5 * nb), np.int64)
    hist[:, 0], hist[:, 2 * nb], hist[:, 4 * nb] = za - zu, zb - zu, zu
    x = _regs(wa, bits).reshape(len(pa), -1).astype(np.int64)
    y = _regs(wb, bits).reshape(len(pa), -1).astype(np.int64)
    live = (x != 0) | (y != 0)
    row = np.broadcast_to(np.arange(len(pa))[:, None], x.shape)
    ka = np.where(x < y, np.where((x != 0) & (x < nb), x, -1),
                  np.where(x > y, np.where(x < nb, nb + x, -1),
                           np.where((x != 0) & (x < nb), 4 * nb + x, -1)))
    kb = np.where(x < y, np.where(y < nb, 3 * nb + y, -1),
                  np.where(x > y, np.where((y != 0) & (y < nb), 2 * nb + y,
                                           -1), -1))
    for key in (ka, kb):
        hit = live & (key >= 0)
        np.add.at(hist, (row[hit], key[hit]), 1)
    sa, _ = emulated_sums(regs[pa], packed)
    sb, _ = emulated_sums(regs[pb], packed)
    su, _ = emulated_sums(np.ascontiguousarray(
        reg_max(wa, wb, packed)).view(np.uint8), packed)
    sz = np.stack([np.stack([sa, za], -1), np.stack([sb, zb], -1),
                   np.stack([su, zu], -1)], 1).astype(np.float32)
    return hist.reshape(len(pa), 5, nb).astype(np.float32), sz


def emulated_union(regs, ids, mask, packed, warps=8, members=4, ahead=2,
                   vec=16):
    """union_estimate_stats as the kernel deals its work: per block of
    ``warps`` sets, a queue of 32-lane id windows in window-major order
    taken ``ahead`` at a time (here in turn by the warps; the kernel's
    shared counter gives them in any order), live lanes compacted by
    ballot rank, each lane group of a column chunk taking ``members``
    rows at a time; partial rows merged register-wise into the set's
    chunk. Returns ((s, z) float32[B, 2], the row reads of each set)."""
    b, lanes = ids.shape
    row_vecs = regs.shape[1] // vec
    g = min(32, row_vecs)
    groups = 32 // g
    merged = np.zeros((b, regs.shape[1]), np.uint8)
    reads = [[] for _ in range(b)]
    for set0 in range(0, b, warps):
        here = min(warps, b - set0)
        items = here * -(-lanes // 32)
        for col in range(0, row_vecs, g):
            cols = slice(col * vec, (col + g) * vec)
            for t0 in range(0, items, ahead):  # warp (t0 // ahead) % warps
                for t in range(t0, min(t0 + ahead, items)):
                    s, w0 = set0 + t % here, (t // here) * 32
                    at = np.arange(w0, min(w0 + 32, lanes))
                    rows = ids[s, at[mask[s, at]]]  # in ballot rank order
                    for grp in range(groups):
                        for m in range(grp * members, len(rows),
                                       groups * members):
                            for r in rows[m:m + members]:
                                reads[s].append(r)
                                merged[s, cols] = reg_max(
                                    merged[s, cols].view(U32),
                                    regs[r, cols].view(U32),
                                    packed).view(np.uint8)
    s, z = emulated_sums(merged, packed)
    return np.stack([s, z], 1), reads


def _accumulated(p, scale=9, edge_factor=4, seed=0):
    """Rows of a small RMAT graph's accumulate: mostly zero registers."""
    edges = generators.rmat(scale, edge_factor, seed=seed)
    directed = np.concatenate([edges, edges[:, ::-1]])
    regs = torch.zeros((1 << scale, 1 << p), dtype=torch.uint8)
    hll_accumulate.plain(regs, torch.from_numpy(directed[:, 0].copy()),
                         torch.from_numpy(directed[:, 1].astype(np.uint32)),
                         p=p, seed=seed)
    return regs.numpy(), edges


def _skewed_pairs(rng, edges, n, b):
    """Edge pairs (degree-biased ends), a hub against random vertices and
    a row against itself."""
    deg = np.bincount(edges.ravel(), minlength=n)
    hub = int(deg.argmax())
    pairs = edges[rng.choice(len(edges), b, replace=False)].astype(np.int32)
    pairs[::3, 0] = hub
    pairs[::7, 1] = pairs[::7, 0]
    return pairs[:, 0].copy(), pairs[:, 1].copy()


def _skewed_sets(rng, edges, n):
    """A hub's 1,024 neighbours (or as many as it has) as one set among
    singletons and short sets, with masked lanes and padding ids 0."""
    deg = np.bincount(edges.ravel(), minlength=n)
    hub = int(deg.argmax())
    nbrs = np.unique(np.concatenate([edges[edges[:, 0] == hub, 1],
                                     edges[edges[:, 1] == hub, 0]]))[:1024]
    lanes, b = 1024, 21
    ids = np.zeros((b, lanes), np.int32)
    mask = np.zeros((b, lanes), bool)
    lens = rng.integers(0, 5, b)
    lens[::3] = 1
    for i, k in enumerate(lens):
        ids[i, :k] = rng.integers(0, n, k)
        mask[i, :k] = True
    ids[4, :len(nbrs)], mask[4, :len(nbrs)] = nbrs, True
    mask[4, ::9] = False  # holes: not a prefix mask
    ids[~mask] = 0
    return ids, mask


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12])
def test_emulated_pair_stats_match_plain(layout, p):
    packed = layout == "packed"
    byte, edges = _accumulated(p)
    byte[1::11, ::5] = 250  # foreign bytes above q + 1 count in no bin
    regs = packing.pack_rows(torch.from_numpy(byte)).numpy() if packed \
        else byte
    q = 64 - p
    pa, pb = _skewed_pairs(np.random.default_rng(p), edges, len(byte), 99)
    st, sz = emulated_pair_stats(regs, pa, pb, q, packed)
    st_p, sz_p = intersection_stats.plain(
        torch.from_numpy(regs), torch.from_numpy(pa), torch.from_numpy(pb),
        q, layout=layout)
    np.testing.assert_array_equal(st, st_p.numpy())
    np.testing.assert_array_equal(sz[..., 1], sz_p[..., 1].numpy())
    unpacked = np.minimum(byte, 15) if packed else byte
    rows = np.stack([unpacked[pa], unpacked[pb],
                     np.maximum(unpacked[pa], unpacked[pb])], 1)
    np.testing.assert_array_equal(sz[..., 0], _exact(rows))
    np.testing.assert_allclose(sz[..., 0], sz_p[..., 0].numpy(), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12])
@pytest.mark.parametrize("members", [1, 4])
def test_emulated_union_matches_plain(layout, p, members):
    packed = layout == "packed"
    byte, edges = _accumulated(p)
    byte[0] = 15 if packed else 60  # a read padding row 0 would show
    regs = packing.pack_rows(torch.from_numpy(byte)).numpy() if packed \
        else byte
    ids, mask = _skewed_sets(np.random.default_rng(p), edges, len(byte))
    got, reads = emulated_union(regs, ids, mask, packed, members=members,
                                vec=16 if regs.shape[1] % 16 == 0 else 8)
    for s in range(len(ids)):  # every live member read once a chunk
        chunks = max(1, regs.shape[1] // (16 * 32))
        assert sorted(reads[s]) == sorted(list(ids[s][mask[s]]) * chunks)
    want = union_estimate.plain(torch.from_numpy(regs), torch.from_numpy(ids),
                                torch.from_numpy(mask), layout=layout)
    np.testing.assert_array_equal(got[:, 1], want[:, 1].numpy())
    np.testing.assert_allclose(got[:, 0], want[:, 0].numpy(), rtol=1e-6,
                               atol=0)
    empty = ~mask.any(1)
    assert (got[empty] == float(1 << p)).all()


# ------------------------------------------ plain versions against JAX
@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12])
def test_plain_pair_stats_match_jax_on_skewed_rows(layout, p):
    byte, edges = _accumulated(p, seed=1)
    regs = packing.pack_rows(torch.from_numpy(byte)).numpy() \
        if layout == "packed" else byte
    q = 64 - p
    pa, pb = _skewed_pairs(np.random.default_rng(p + 1), edges, len(byte),
                           77)
    st, sz = intersection_stats.plain(
        torch.from_numpy(regs), torch.from_numpy(pa), torch.from_numpy(pb),
        q, layout=layout)
    if layout == "packed":
        st_j, sz_j = jax_ops._intersection_stats_ref(
            jnp.asarray(regs), jnp.asarray(pa), jnp.asarray(pb), q,
            layout="packed")
    else:
        st_j, sz_j = jax_ref.intersection_stats_ref(
            jnp.asarray(regs), jnp.asarray(pa), jnp.asarray(pb), q)
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(sz[..., 1].numpy(), np.asarray(sz_j)[..., 1])
    np.testing.assert_allclose(sz[..., 0].numpy(), np.asarray(sz_j)[..., 0],
                               rtol=1e-6, atol=0)
    if p >= 8:  # the zero-heavy case: most registers are 0
        assert float(sz[:, :2, 1].mean()) / (1 << p) > 0.5


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8, 12])
def test_plain_union_matches_jax_on_skewed_sets(layout, p):
    byte, edges = _accumulated(p, seed=2)
    regs = packing.pack_rows(torch.from_numpy(byte)).numpy() \
        if layout == "packed" else byte
    ids, mask = _skewed_sets(np.random.default_rng(p + 2), edges, len(byte))
    got = union_estimate.plain(torch.from_numpy(regs), torch.from_numpy(ids),
                               torch.from_numpy(mask), layout=layout)
    if layout == "packed":
        s_j, z_j = jax_ops._union_estimate_ref(
            jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(mask),
            layout="packed")
    else:
        s_j, z_j = jax_ref.union_estimate_ref(
            jnp.asarray(regs), jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_array_equal(got[:, 1].numpy(), np.asarray(z_j))
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(s_j), rtol=1e-6,
                               atol=0)
