"""Port parity for the engine's device-built inputs: the dst-sorted
propagate routing and the unpadded ingest chunks, on the CPU against the
JAX reference (``impl="ref"``).

The card's propagate kernel pulls over a routing sorted by destination
(``hll_propagate.sort_routing``), and the engine builds that routing and
the accumulate inputs on the device from the undirected edges, one
``INGEST_BLOCK`` chunk at a time, with no padding and no mask. Register
max is commutative and idempotent, so neither the order of the routing
nor the blocking of the ingest may change a register: panels here are
held byte for byte (tolerance zero).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as jax_engine  # noqa: E402
from repro.core import ads as jax_ads  # noqa: E402
from repro.core.hll import HLLConfig as JaxConfig  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import packing as jax_packing  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.ads import ADSConfig  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.engine.base import SketchEngine  # noqa: E402
from repro_torch.kernels.inputs import directed_block, directed_routing  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.kernels import hll_accumulate, hll_propagate, ops  # noqa: E402


@pytest.mark.parametrize("v,e", [(1, 1), (7, 300), (500, 4_000)])
def test_sort_routing_is_stable_and_sorted(v, e):
    rng = np.random.default_rng(v + e)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    s, d = hll_propagate.sort_routing(torch.from_numpy(src),
                                      torch.from_numpy(dst))
    assert s.dtype == d.dtype == torch.int32
    order = np.argsort(dst, kind="stable")  # equal dst keep input order
    np.testing.assert_array_equal(d.numpy(), dst[order])
    np.testing.assert_array_equal(s.numpy(), src[order])
    assert bool((d[1:] >= d[:-1]).all())


def _jax_panel(rng, v, p, layout):
    """Registers up to 20 (packed: saturating at 15), some rows empty."""
    full = rng.integers(0, 21, (v, 1 << p)).astype(np.uint8)
    full[rng.random(v) < 0.2] = 0
    if layout == "packed":
        return np.array(jax_packing.pack_rows(jnp.asarray(full)))
    return full


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("p", [4, 8])
def test_plain_on_sorted_routing_matches_unsorted_and_jax(layout, p):
    rng = np.random.default_rng(p + len(layout))
    v, e = 90, 1_500
    regs = _jax_panel(rng, v, p, layout)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    dst[::9] = src[::9]  # self-edges
    want = np.asarray(jax_ops.propagate(
        jnp.asarray(regs), jnp.asarray(src), jnp.asarray(dst), impl="ref",
        layout=layout))
    panel = torch.from_numpy(regs)
    unsorted = hll_propagate.plain(panel, torch.from_numpy(src),
                                   torch.from_numpy(dst), layout=layout)
    routed = hll_propagate.sort_routing(torch.from_numpy(src),
                                        torch.from_numpy(dst))
    got = hll_propagate.plain(panel, *routed, layout=layout)
    np.testing.assert_array_equal(unsorted.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(panel.numpy(), regs)  # input untouched


def test_directed_routing_is_both_orientations_sorted():
    edges = generators.rmat(7, 4, seed=3)
    src, dst = directed_routing(edges, torch.device("cpu"))
    both_src = np.concatenate([edges[:, 0], edges[:, 1]])
    both_dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(both_dst, kind="stable")
    np.testing.assert_array_equal(src.numpy(), both_src[order])
    np.testing.assert_array_equal(dst.numpy(), both_dst[order])


@pytest.mark.parametrize("slice_edges", [1, 64, 1_000, 1 << 23])
def test_directed_routing_in_slices_equals_one_sort(monkeypatch,
                                                     slice_edges):
    """Built slice by slice (a hub's in-edges larger than a slice, slices
    of one edge, one slice for all) the routing equals sort_routing of
    both orientations in one call, self-edges and duplicates included."""
    from repro_torch.kernels import inputs
    monkeypatch.setattr(inputs, "ROUTING_SLICE", slice_edges)
    edges = generators.rmat(7, 4, seed=5)
    edges = np.concatenate([edges, [[3, 3], [0, 9], [0, 9]]]).astype(np.int32)
    strided = np.repeat(edges, 2, axis=0)[::2]  # a view, as edges[i::2]
    src, dst = directed_routing(strided, torch.device("cpu"))
    e = torch.from_numpy(edges)
    want = hll_propagate.sort_routing(torch.cat([e[:, 0], e[:, 1]]),
                                      torch.cat([e[:, 1], e[:, 0]]))
    assert torch.equal(src, want[0]) and torch.equal(dst, want[1])


def test_directed_block_is_both_orientations():
    edges = generators.rmat(6, 4, seed=1)
    edges.flags.writeable = False  # copied, not aliased, and no warning
    rows, keys = directed_block(edges, torch.device("cpu"))
    assert rows.dtype == torch.int32 and keys.dtype == torch.uint32
    np.testing.assert_array_equal(
        rows.numpy(), np.concatenate([edges[:, 0], edges[:, 1]]))
    np.testing.assert_array_equal(
        keys.numpy(), np.concatenate([edges[:, 1], edges[:, 0]])
        .astype(np.uint32))


@pytest.mark.parametrize("layout", ["byte", "packed"])
def test_accumulate_without_mask_matches_all_true(layout):
    rng = np.random.default_rng(11)
    p, v, e = 6, 40, 3_001
    w = (1 << p) // (2 if layout == "packed" else 1)
    rows = torch.from_numpy(rng.integers(0, v, e).astype(np.int32))
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, e, dtype=np.uint64)
                            .astype(np.uint32))
    panels = [torch.zeros((v, w), dtype=torch.uint8) for _ in range(3)]
    hll_accumulate.hll_accumulate(panels[0], rows, keys, p=p, layout=layout)
    hll_accumulate.hll_accumulate(panels[1], rows, keys,
                                  torch.ones(e, dtype=torch.bool), p=p,
                                  layout=layout)
    ops.accumulate(panels[2], rows, keys, HLLConfig(p=p), layout=layout)
    assert torch.equal(panels[0], panels[1])
    assert torch.equal(panels[0], panels[2])
    assert int(panels[0].count_nonzero()) > 0


# (family, layout, port config, JAX config)
ENGINES = {
    "hll-byte": ("hll", "byte", HLLConfig(p=8), JaxConfig(p=8)),
    "hll-packed": ("hll", "packed", HLLConfig(p=8), JaxConfig(p=8)),
    "ads": ("ads", "byte", ADSConfig(p=7), jax_ads.ADSConfig(p=7)),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_chunked_ingest_matches_jax_build(monkeypatch, name):
    """Ragged ingests across a small INGEST_BLOCK: one accumulate call per
    chunk, every edge live (no mask, no padding), registers equal to the
    JAX engine's one-shot build; then neighborhoods over the sorted
    routing equal the JAX engine's."""
    family, layout, cfg, jax_cfg = ENGINES[name]
    monkeypatch.setattr(SketchEngine, "INGEST_BLOCK", 250)
    calls = []
    wrapper = ops.hll_accumulate

    def counted(regs, rows, keys, mask, **kw):
        calls.append((rows.shape[0], mask))
        return wrapper(regs, rows, keys, mask, **kw)

    monkeypatch.setattr(ops, "hll_accumulate", counted)
    edges = generators.rmat(8, 8, seed=4)
    n = 1 << 8
    want = jax_engine.build(edges, n, jax_cfg, impl="ref", layout=layout,
                            backend="local", family=family)
    eng = engine.open(n, cfg, layout=layout, family=family, device="cpu")
    sizes = [1, 249, 250, 251, 700, 13]
    chunks, s = [], 0
    for size in sizes + [len(edges) - sum(sizes)]:
        block = edges[s:s + size]
        eng.ingest(block)
        chunks += [2 * len(block[i:i + 250])
                   for i in range(0, len(block), 250)]
        s += size
    assert [c for c, _ in calls] == chunks
    assert all(mask is None for _, mask in calls)
    np.testing.assert_array_equal(eng.regs.numpy(), np.asarray(want.regs))
    for got, ref in zip(eng.neighborhood(3), want.neighborhood(3)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)
    src, dst = eng._prop_routing
    assert bool((dst[1:] >= dst[:-1]).all()) and src.numel() == 2 * eng.m
