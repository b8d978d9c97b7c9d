"""Exact ground truth: t-neighborhood sizes and triangle counts (numpy).

A copy of the oracles of ``repro.graph.exact`` that the port's tests and
``chip_smoke.py`` use, kept here so that the port never imports the JAX
package. Fine for the moderate graphs accuracy checks use.
"""
from __future__ import annotations

import numpy as np

__all__ = ["adjacency_lists", "neighborhood_truth", "exact_edge_triangles",
           "exact_vertex_triangles", "exact_global_triangles",
           "kron_edge_triangles"]

#: bytes of one source block's gathered reach panel in ``neighborhood_truth``
_TRUTH_BLOCK_BYTES = 1 << 26


def adjacency_lists(n: int, edges: np.ndarray) -> list[np.ndarray]:
    """Sorted adjacency arrays per vertex from a canonical edge list."""
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=offs[1:])
    flat = np.zeros(offs[-1], dtype=np.int32)
    cur = offs[:-1].copy()
    for u, v in edges:
        flat[cur[u]] = v
        cur[u] += 1
        flat[cur[v]] = u
        cur[v] += 1
    return [np.sort(flat[offs[i]:offs[i + 1]]) for i in range(n)]


def neighborhood_truth(n: int, edges: np.ndarray, t_max: int) -> np.ndarray:
    """Ground truth matching Algorithm 2's accumulation semantics.

    Returns int64[t_max, n]. The accumulated sketch D^t[x] contains
    {y != x : d(x,y) <= t}, plus x itself from t >= 2 onward (x enters via
    its neighbors' adjacency sets on the second pass). Row t-1 holds that
    target count for pass t.

    The same counts as the JAX package's per-source BFS, computed for a
    block of sources at once: a boolean reach panel ``[n, sources]`` grows
    by one hop per step, each vertex OR-ing its neighbors' columns (edges
    sorted by destination, ``np.logical_or.reduceat`` per vertex).
    """
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.argsort(dst, kind="stable")
    src = src[order]
    deg = np.bincount(dst, minlength=n)
    has = np.flatnonzero(deg)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])[has]
    out = np.zeros((t_max, n), dtype=np.int64)
    block = max(1, min(n, _TRUTH_BLOCK_BYTES // max(len(src), 1)))
    for s0 in range(0, n, block):
        sources = np.arange(s0, min(n, s0 + block))
        reached = np.zeros((n, len(sources)), dtype=bool)
        reached[sources, np.arange(len(sources))] = True
        for t in range(1, t_max + 1):
            if len(src):
                pulled = np.logical_or.reduceat(reached[src], starts, axis=0)
                reached[has] |= pulled
            count = reached.sum(axis=0) - 1  # y != x
            out[t - 1, sources] = count + ((t >= 2) & (deg[sources] > 0))
    return out


def exact_edge_triangles(n: int, edges: np.ndarray) -> np.ndarray:
    """T(xy) = |N(x) ∩ N(y)| per edge (Eq. 3), via sorted-set intersection."""
    adj = adjacency_lists(n, edges)
    out = np.zeros(len(edges), dtype=np.int64)
    for i, (u, v) in enumerate(edges):
        out[i] = len(np.intersect1d(adj[u], adj[v], assume_unique=True))
    return out


def exact_vertex_triangles(n: int, edges: np.ndarray,
                           edge_tri: np.ndarray | None = None) -> np.ndarray:
    """T(x) = 1/2 sum over incident edges of T(xy) (Eq. 5)."""
    if edge_tri is None:
        edge_tri = exact_edge_triangles(n, edges)
    out = np.zeros(n, dtype=np.int64)
    np.add.at(out, edges[:, 0], edge_tri)
    np.add.at(out, edges[:, 1], edge_tri)
    return out // 2


def exact_global_triangles(n: int, edges: np.ndarray,
                           edge_tri: np.ndarray | None = None) -> int:
    """T = 1/3 sum over edges of T(xy) (Eq. 6)."""
    if edge_tri is None:
        edge_tri = exact_edge_triangles(n, edges)
    return int(edge_tri.sum()) // 3


def kron_edge_triangles(factor_edges: np.ndarray, n_f: int,
                        kron_edges_arr: np.ndarray) -> np.ndarray:
    """Exact T(e) per edge of a Kronecker power C = A ⊗ A, int64[m].

    The Kronecker formula (Sanders et al. 2018): for a C-edge
    ((u1,u2),(v1,v2)), T_C(e) = (A^2)[u1,v1] * (A^2)[u2,v2], because the
    common-neighbor walks factorize over the product. O(m) after the
    n_f x n_f product, where ``exact_edge_triangles`` intersects
    adjacency lists.
    """
    A = np.zeros((n_f, n_f), dtype=np.int64)
    A[factor_edges[:, 0], factor_edges[:, 1]] = 1
    A[factor_edges[:, 1], factor_edges[:, 0]] = 1
    A2 = A @ A
    u1, u2 = kron_edges_arr[:, 0] // n_f, kron_edges_arr[:, 0] % n_f
    v1, v2 = kron_edges_arr[:, 1] // n_f, kron_edges_arr[:, 1] % n_f
    return A2[u1, v1] * A2[u2, v2]
