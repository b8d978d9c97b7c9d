"""The device RMAT generator (canonical form, size against the program's
numpy generator, one graph a seed) and the pairs generator's pool."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.graph import generators
from sketchbench.gen.rmat_torch import rmat

G500 = (0.57, 0.19, 0.19)


def _canonical(e: np.ndarray) -> None:
    assert e.dtype == np.int32 and e.ndim == 2 and e.shape[1] == 2
    assert (e[:, 0] < e[:, 1]).all()              # u < v, so no loops
    key = e[:, 0].astype(np.int64) << 32 | e[:, 1]
    assert len(np.unique(key)) == len(e)           # no duplicates


@pytest.mark.parametrize("scale,seed", [(8, 0), (10, 3), (12, 2 ** 31 + 5)])
def test_canonical_form(scale, seed):
    e = rmat(scale, 16, seed, *G500, "cpu").numpy()
    _canonical(e)
    assert e.min() >= 0 and e.max() < 1 << scale


@pytest.mark.parametrize("scale", [10, 12, 14])
def test_edge_count_near_numpy_generator(scale):
    ours = np.mean([len(rmat(scale, 16, s, *G500, "cpu")) for s in (1, 2)])
    theirs = np.mean([len(generators.rmat(scale, 16, seed=s)) for s in (1, 2)])
    assert abs(ours - theirs) / theirs < 0.03


def test_one_seed_one_graph():
    a = rmat(11, 16, 2 ** 31 + 11, *G500, "cpu")
    b = rmat(11, 16, 2 ** 31 + 11, *G500, "cpu")
    c = rmat(11, 16, 2 ** 31 + 12, *G500, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a[: len(c)], c[: len(a)])


@pytest.mark.cuda
def test_on_the_card(cuda_device):
    a = rmat(14, 16, 2 ** 31 + 3, *G500, cuda_device)
    b = rmat(14, 16, 2 ** 31 + 3, *G500, cuda_device)
    assert torch.equal(a, b)
    _canonical(a.cpu().numpy())


def _sample_ctx(seed: int):
    from types import SimpleNamespace
    edges = rmat(9, 16, seed, *G500, "cpu").numpy()
    return SimpleNamespace(edges=edges, seed=seed, cache={},
                           device=SimpleNamespace(torch=torch, kind="cpu"))


POOL = 40   # not a multiple of the block, so the last block is part-used
SPEC = {"gen": "edge_sample", "count": 64, "pool": POOL}


@pytest.mark.parametrize("before", [0, 5, 40])
def test_edge_sample_depends_on_seed_and_step_alone(before):
    """A step's pairs are the same whether set-up reserved the pool or
    not and whichever step came first, and are edges of the graph."""
    from sketchbench.gen import edge_sample
    fresh, ctx = _sample_ctx(2 ** 31 + 9), _sample_ctx(2 ** 31 + 9)
    edge_sample.reserve(SPEC, ctx)
    edge_sample.make(SPEC, fresh, before)
    keys = set(map(tuple, fresh.edges.tolist()))
    for step in (0, 3, 17, 39):
        got = edge_sample.make(SPEC, ctx, step)
        assert np.array_equal(got, edge_sample.make(SPEC, fresh, step))
        assert got.shape == (64, 2) and set(map(tuple, got.tolist())) <= keys
    assert not np.array_equal(edge_sample.make(SPEC, ctx, 1),
                              edge_sample.make(SPEC, ctx, 2))


@pytest.mark.parametrize("first", [0, 7, 39])
def test_edge_sample_pool_repeats(first):
    """Step i and step i + k * pool send the same pairs."""
    from sketchbench.gen import edge_sample
    ctx = _sample_ctx(2 ** 31 + 9)
    got = edge_sample.make(SPEC, ctx, first)
    for later in (first + POOL, first + 5 * POOL):
        assert np.array_equal(got, edge_sample.make(SPEC, ctx, later))


def test_edge_sample_pool_requests_differ():
    from sketchbench.gen import edge_sample
    ctx = _sample_ctx(2 ** 31 + 9)
    edge_sample.reserve(SPEC, ctx)
    seen = {edge_sample.make(SPEC, ctx, i).tobytes() for i in range(POOL)}
    assert len(seen) == POOL


@pytest.mark.parametrize("pool,steps", [(POOL, 0), (POOL, 3),
                                        (POOL, 100_000), (256, 7_800)])
def test_edge_sample_reserve_draws_the_pool_alone(pool, steps):
    """Set-up draws ceil(pool / BLOCK) blocks, and a window of any number
    of steps then draws none."""
    from sketchbench.gen import edge_sample
    spec = dict(SPEC, pool=pool)
    ctx = _sample_ctx(2 ** 31 + 9)
    edge_sample.reserve(spec, ctx)
    drawn = ctx.cache[("edge_sample", 64)]
    assert sorted(drawn) == list(range(-(-pool // edge_sample.BLOCK)))
    for step in (0, pool - 1, pool, 3 * pool + 5, steps, steps + 1):
        edge_sample.make(spec, ctx, step)
    assert len(drawn) == -(-pool // edge_sample.BLOCK)


def test_edge_sample_needs_a_pool():
    from sketchbench.gen import edge_sample
    ctx = _sample_ctx(2 ** 31 + 9)
    spec = {"gen": "edge_sample", "count": 64}
    with pytest.raises(KeyError):
        edge_sample.reserve(spec, ctx)
    with pytest.raises(KeyError):
        edge_sample.make(spec, ctx, 0)
