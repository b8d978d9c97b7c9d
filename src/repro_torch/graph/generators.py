"""Graph generators: Erdős–Rényi and RMAT power-law (numpy).

A copy of the generators in ``repro.graph.generators`` that the port
uses, kept here so that the port never imports the JAX package. For the
same seed they return the same arrays. Every generator returns a
canonical undirected edge list: int32[m, 2] with u < v, no self-loops,
no duplicates.
"""
from __future__ import annotations

import numpy as np

__all__ = ["canonical_undirected", "erdos_renyi", "rmat"]


def canonical_undirected(edges: np.ndarray) -> np.ndarray:
    """Drop self-loops/duplicates, orient u < v, sort. Paper §5: graphs are
    cast unweighted/undirected, ignoring direction, self-loops, repeats."""
    e = np.asarray(edges, dtype=np.int64)
    e = e[e[:, 0] != e[:, 1]]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    key = lo * (hi.max() + 1 if len(hi) else 1) + hi
    _, idx = np.unique(key, return_index=True)
    out = np.stack([lo[idx], hi[idx]], axis=1)
    return out.astype(np.int32)


def erdos_renyi(n: int, m: int, seed: int = 0) -> np.ndarray:
    """~m distinct undirected edges sampled uniformly."""
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m * 1.3) + 16, 2))
    e = canonical_undirected(e)
    return e[:m] if len(e) > m else e


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> np.ndarray:
    """RMAT/Kronecker-stochastic power-law generator (Graph500 parameters).

    n = 2**scale vertices, ~edge_factor * n undirected edges after dedup.
    """
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = (r1 > ab).astype(np.int64)
        dst_bit = np.where(src_bit == 1, (r2 > c_norm).astype(np.int64),
                           (r2 > a_norm).astype(np.int64))
        src = 2 * src + src_bit
        dst = 2 * dst + dst_bit
    perm = rng.permutation(n)  # relabel to break lexicographic locality
    return canonical_undirected(np.stack([perm[src], perm[dst]], axis=1))
