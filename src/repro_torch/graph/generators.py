"""Graph generators: Erdős–Rényi, RMAT power-law, nonstochastic Kronecker
(numpy).

A copy of the generators in ``repro.graph.generators``, kept here so that
the port never imports the JAX package. For the same seed they return the
same arrays. Every generator returns a canonical undirected edge list:
int32[m, 2] with u < v, no self-loops, no duplicates. The Kronecker
products C = F ⊗ F of small factors are the paper's Appendix C graphs;
``graph.exact.kron_edge_triangles`` gives their exact per-edge triangle
counts in O(m).
"""
from __future__ import annotations

import numpy as np

__all__ = ["canonical_undirected", "erdos_renyi", "rmat", "named_factor",
           "kronecker_edges", "kronecker_power"]


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


# --- small named factor graphs (stand-ins for the UF collection factors) ---

def named_factor(name: str, seed: int = 0) -> tuple[np.ndarray, int]:
    """Small factor graphs for Kronecker products: (edges, n).

    "wheel16" (a hub and a 15-cycle), "clique8", "community24" (two
    seeded dense communities and three bridges) and "grid6"; any other
    name raises ``ValueError``.
    """
    if name == "wheel16":      # hub + cycle: heavy-hitter hub edges
        n = 16
        rim = [(i, (i % (n - 1)) + 1) for i in range(1, n)]
        spokes = [(0, i) for i in range(1, n)]
        return canonical_undirected(np.array(rim + spokes)), n
    if name == "clique8":
        n = 8
        return canonical_undirected(
            np.array([(i, j) for i in range(n) for j in range(i + 1, n)])), n
    if name == "community24":  # two dense communities + bridges
        rng = np.random.default_rng(seed)
        n = 24
        e = []
        for base in (0, 12):
            for i in range(12):
                for j in range(i + 1, 12):
                    if rng.random() < 0.55:
                        e.append((base + i, base + j))
        e += [(0, 12), (1, 13), (5, 17)]
        return canonical_undirected(np.array(e)), n
    if name == "grid6":
        k, n = 6, 36
        e = []
        for i in range(k):
            for j in range(k):
                v = i * k + j
                if j + 1 < k:
                    e.append((v, v + 1))
                if i + 1 < k:
                    e.append((v, v + k))
        return canonical_undirected(np.array(e)), n
    raise ValueError(f"unknown factor {name!r}")


def kronecker_edges(f1: np.ndarray, n1: int, f2: np.ndarray,
                    n2: int) -> np.ndarray:
    """Edges of the nonstochastic Kronecker product C = C1 ⊗ C2 (App. C).

    C[(i1,i2),(j1,j2)] = C1[i1,j1] * C2[i2,j2]; vertex (i1,i2) -> i1*n2 + i2.
    Undirected factors are expanded to both orientations first (the Kron
    product of symmetric matrices needs all directed pairs), so the int64
    outer product holds 4 |E1| |E2| directed pairs before deduplication.
    """
    d1 = np.concatenate([f1, f1[:, ::-1]], axis=0).astype(np.int64)
    d2 = np.concatenate([f2, f2[:, ::-1]], axis=0).astype(np.int64)
    src = (d1[:, None, 0] * n2 + d2[None, :, 0]).reshape(-1)
    dst = (d1[:, None, 1] * n2 + d2[None, :, 1]).reshape(-1)
    return canonical_undirected(np.stack([src, dst], axis=1))


def kronecker_power(name: str, seed: int = 0) -> tuple[np.ndarray, int]:
    """C = F ⊗ F from a named factor, the paper's ``g ⊗ g`` graphs:
    (edges, n * n)."""
    f, n = named_factor(name, seed)
    return kronecker_edges(f, n, f, n), n * n
