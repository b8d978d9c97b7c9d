"""Graph500 RMAT graphs made on the device from a seed.

The recursive-matrix generator of Graph500 (and of the program's numpy
``rmat``): ``edge_factor * 2^scale`` directed draws, each picking one
quadrant per level with probabilities (a, b, c, 1 - a - b - c), then a
seeded random relabelling of the vertices, then the canonical undirected
form: ``u < v``, no self-loops, no duplicates, sorted. Every draw is
made on ``device`` with one ``torch.Generator`` seeded by ``seed``, so
one seed gives one graph on a given device; the bits differ from the
numpy generator's, the distribution does not.
"""
from __future__ import annotations

import torch


def rmat(scale: int, edge_factor: int, seed: int, a: float, b: float,
         c: float, device) -> torch.Tensor:
    """Canonical undirected RMAT edges int32[m, 2] on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = 1 << scale
    m = edge_factor * n
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    draw = torch.empty(m, dtype=torch.float32, device=device)
    for _ in range(scale):
        draw.uniform_(generator=gen)
        src_bit = draw > ab
        draw.uniform_(generator=gen)
        dst_bit = torch.where(src_bit, draw > c_norm, draw > a_norm)
        src.mul_(2).add_(src_bit)
        dst.mul_(2).add_(dst_bit)
        del src_bit, dst_bit
    del draw
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[src], perm[dst]
    del src, dst, perm
    keep = u != v
    u, v = u[keep], v[keep]
    key = torch.minimum(u, v) * n + torch.maximum(u, v)
    del u, v, keep
    key = torch.unique(key)
    return torch.stack([key // n, key % n], dim=1).to(torch.int32)
