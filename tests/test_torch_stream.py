"""Port parity: edge streams and the owner router (``repro_torch.graph.
stream``) against ``repro.graph.stream``, and ``ingest_stream`` against
``build`` in both layouts. Every comparison is exact: the functions are
integer numpy code, and register max makes any blocking of the same
edges give the same panel byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graph import stream as jax_stream  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core.hll import HLLConfig  # noqa: E402
from repro_torch.graph import generators  # noqa: E402
from repro_torch.graph import stream  # noqa: E402


@pytest.fixture(scope="module")
def graph():
    edges = generators.rmat(9, 8, seed=3)
    return edges, int(edges.max()) + 1


@pytest.mark.parametrize("num_substreams,block", [(1, 4096), (3, 300),
                                                  (4, 1), (5, 1000)])
def test_edge_stream_matches_jax(graph, num_substreams, block):
    edges, _ = graph
    mine = stream.EdgeStream(edges, num_substreams=num_substreams,
                             block=block)
    theirs = jax_stream.EdgeStream(edges, num_substreams=num_substreams,
                                   block=block)
    assert mine.m == theirs.m == len(edges)
    for i in range(num_substreams):
        np.testing.assert_array_equal(mine.substream(i), theirs.substream(i))
        got, want = list(mine.blocks(i)), list(theirs.blocks(i))
        assert len(got) == len(want)
        for (gb, gm), (wb, wm) in zip(got, want):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gm, wm)
    got, want = list(mine.all_blocks()), list(theirs.all_blocks())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # every edge exactly once across the trimmed blocks
    assert sum(len(b) for b in got) == len(edges)


@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_owner_router_matches_jax(graph, num_shards):
    edges, n = graph
    n_pad = -(-n // (8 * num_shards)) * 8 * num_shards
    verts = np.arange(n_pad)
    np.testing.assert_array_equal(
        stream.owner_of(verts, n_pad, num_shards),
        jax_stream.owner_of(verts, n_pad, num_shards))
    mine = stream.bucket_by_owner(edges, n_pad, num_shards)
    theirs = jax_stream.bucket_by_owner(edges, n_pad, num_shards)
    assert len(mine) == len(theirs) == num_shards
    for g, w in zip(mine, theirs):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in mine) == 2 * len(edges)


@pytest.mark.parametrize("size", [1, 7, 16])
def test_pad_block_matches_jax(size):
    arr = np.arange(14, dtype=np.int32).reshape(7, 2)[: min(size, 7)]
    for a in (arr, arr[:, 0]):
        got, got_mask = stream.pad_block(a, size, fill=-1)
        want, want_mask = jax_stream.pad_block(a, size, fill=-1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("num_substreams,block", [(1, 512), (3, 300),
                                                  (7, 64)])
def test_ingest_stream_equals_build(graph, layout, num_substreams, block):
    edges, n = graph
    cfg = HLLConfig(p=8)
    want = engine.build(edges, n, cfg, layout=layout, device="cpu")
    eng = engine.open(n, cfg, layout=layout, device="cpu")
    eng.ingest_stream(stream.EdgeStream(edges, num_substreams=num_substreams,
                                        block=block))
    assert torch.equal(eng.regs, want.regs)
    assert eng.m == len(edges)
    np.testing.assert_array_equal(eng.degrees(), want.degrees())
