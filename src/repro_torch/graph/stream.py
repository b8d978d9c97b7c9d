"""Edge streams (paper §2): σ partitioned into |P| substreams (copy of
``repro.graph.stream``, numpy only).

The paper assumes the stream arrives pre-partitioned "by some unknown
means"; its experiments use round-robin. ``EdgeStream`` gives round-robin
substreams and fixed-size padded block iteration, so ingestion stays
block-wise with O(block) edge memory; ``SketchEngine.ingest_stream``
drains one. Blocks carry validity masks; the port's local engine takes
the trimmed blocks of ``all_blocks`` (the CUDA accumulate kernel takes
any length, so it never pads).

The router (``bucket_by_owner``) plays Algorithm 1's Send context: edges
are expanded to both directed orientations (lines 10-11) and grouped by
the owner shard of their destination-sketch vertex, f(x) = block
partition. The port has no sharded backend yet; the router is kept for
it and held against the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["EdgeStream", "bucket_by_owner", "owner_of", "pad_block"]


def owner_of(vertex: np.ndarray, n_pad: int, num_shards: int) -> np.ndarray:
    """Block-partition owner: f(x) = x // (n_pad / num_shards)."""
    per = n_pad // num_shards
    return np.asarray(vertex) // per


def pad_block(arr: np.ndarray, size: int, fill: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Pad a trailing block to ``size``; returns (padded, valid_mask)."""
    k = len(arr)
    mask = np.zeros(size, dtype=bool)
    mask[:k] = True
    if arr.ndim == 1:
        out = np.full(size, fill, dtype=arr.dtype)
        out[:k] = arr
    else:
        out = np.full((size,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:k] = arr
    return out, mask


def bucket_by_owner(edges: np.ndarray, n_pad: int, num_shards: int) -> list[np.ndarray]:
    """Directed (dst_sketch_vertex, neighbor) pairs grouped by owner shard.

    For undirected edge {u, v} both (u, v) and (v, u) are produced: vertex
    u's sketch receives neighbor v, and vice versa (Algorithm 1 lines
    10-11).
    """
    directed = np.concatenate([edges, edges[:, ::-1]], axis=0)
    owners = owner_of(directed[:, 0], n_pad, num_shards)
    return [directed[owners == s] for s in range(num_shards)]


@dataclass
class EdgeStream:
    """A seeded, restartable edge stream over a static edge list.

    Attributes:
      edges: canonical undirected int32[m, 2].
      num_substreams: |P| — one substream per processor (paper §2).
      block: edges per ingest block (per substream).
    """
    edges: np.ndarray
    num_substreams: int = 1
    block: int = 4096
    seed: int = 0

    def substream(self, i: int) -> np.ndarray:
        """Round-robin substream i (the paper's experimental partitioning)."""
        return self.edges[i::self.num_substreams]

    def blocks(self, i: int):
        """Yield (edge_block int32[block, 2], mask bool[block]) for stream i."""
        sub = self.substream(i)
        for s in range(0, len(sub), self.block):
            chunk = sub[s:s + self.block]
            yield pad_block(chunk, self.block)

    def all_blocks(self):
        """Yield unpadded edge blocks across every substream, in order.

        Substream 0's blocks, then substream 1's, and so on. Padding is
        trimmed (only the final block of each substream is ragged), so
        ``SketchEngine.ingest`` sees exactly the stream's edges once each.
        """
        for i in range(self.num_substreams):
            for blk, msk in self.blocks(i):
                yield blk if msk.all() else blk[msk]

    @property
    def m(self) -> int:
        """Total number of (undirected) edges in the stream."""
        return len(self.edges)
