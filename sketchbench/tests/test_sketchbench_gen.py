"""The device RMAT generator: canonical form, size against the program's
numpy generator, one graph a seed."""
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


@pytest.mark.parametrize("reserved", [0, 5, 40])
def test_edge_sample_depends_on_seed_and_step_alone(reserved):
    """A step's pairs are the same whether set-up reserved it or not, and
    are edges of the graph."""
    from sketchbench.gen import edge_sample
    spec = {"gen": "edge_sample", "count": 64}
    fresh, ctx = _sample_ctx(2 ** 31 + 9), _sample_ctx(2 ** 31 + 9)
    edge_sample.reserve(spec, ctx, reserved)
    keys = set(map(tuple, fresh.edges.tolist()))
    for step in (0, 3, 17, 39):
        got = edge_sample.make(spec, ctx, step)
        assert np.array_equal(got, edge_sample.make(spec, fresh, step))
        assert got.shape == (64, 2) and set(map(tuple, got.tolist())) <= keys
    assert not np.array_equal(edge_sample.make(spec, ctx, 1),
                              edge_sample.make(spec, ctx, 2))
