"""Exact ground truth for triangle counts (numpy).

A copy of the triangle oracles of ``repro.graph.exact`` that the port's
tests and ``chip_smoke.py`` use, kept here so that the port never imports
the JAX package. Fine for the moderate graphs accuracy checks use.
"""
from __future__ import annotations

import numpy as np

__all__ = ["adjacency_lists", "exact_edge_triangles", "exact_vertex_triangles",
           "exact_global_triangles"]


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
