"""Plain HyperLogLog register panels: accumulation (Algorithm 1), the
t-hop propagation (Algorithm 2) and the per-row estimates.

Registers are held one a byte, ``uint8[n, r]``. A deployment in the
packed layout keeps 4-bit registers that saturate at 15; its reference
panel is this one with every register clamped to 15 (the clamp commutes
with the register max, so clamping once at the end is exact).
"""
from __future__ import annotations

import torch

from sketchbench.reference.hashing import bucket_rho

#: directed edges hashed and scattered at a time
_ACC_BLOCK = 1 << 24
#: gathered source rows held at a time by the propagation
_GATHER_ROWS = 1 << 21


def accumulate(edges: torch.Tensor, n: int, p: int, seed: int,
               saturate: int | None = None) -> torch.Tensor:
    """Register panel of the undirected ``edges`` int[m, 2] over ``n``
    vertices: row x holds the max rho of every neighbour's hash bucket.
    ``saturate`` clamps the registers (15 for 4-bit registers)."""
    r = 1 << p
    flat = torch.zeros(n * r, dtype=torch.int32, device=edges.device)
    for s in range(0, edges.shape[0], _ACC_BLOCK):
        e = edges[s:s + _ACC_BLOCK].to(torch.int64)
        for row, key in ((e[:, 0], e[:, 1]), (e[:, 1], e[:, 0])):
            bucket, rho = bucket_rho(key, p, seed)
            flat.scatter_reduce_(0, row * r + bucket, rho.to(torch.int32),
                                 reduce="amax")
            del bucket, rho
    panel = flat.view(n, r)
    if saturate is not None:
        panel.clamp_(max=saturate)
    out = panel.to(torch.uint8)
    del flat, panel
    return out


def unpack_split_half(packed: torch.Tensor) -> torch.Tensor:
    """4-bit packed rows ``uint8[n, r/2]`` as ``uint8[n, r]``: byte j holds
    register j in its low nibble and register j + r/2 in its high one."""
    return torch.cat([packed & 0x0F, packed >> 4], dim=-1)


class Routing:
    """The graph as in-neighbour lists (CSR by destination) and a plan of
    degree buckets: vertices whose degree lies in (w/2, w] are gathered
    together, each padded to w neighbours with itself."""

    def __init__(self, edges: torch.Tensor, n: int):
        e = edges.to(torch.int32)
        dst = torch.cat([e[:, 1], e[:, 0]])
        order = torch.argsort(dst, stable=True)
        deg = torch.bincount(dst, minlength=n)
        del dst
        self.nbr = torch.cat([e[:, 0], e[:, 1]])[order]
        del order
        self.indptr = torch.zeros(n + 1, dtype=torch.int64,
                                  device=edges.device)
        self.indptr[1:] = torch.cumsum(deg, 0)
        width = torch.zeros_like(deg)
        live = deg > 0
        width[live] = torch.pow(2, torch.ceil(torch.log2(
            deg[live].to(torch.float64)))).to(torch.int64)
        self.buckets = []
        for w in torch.unique(width[live]).tolist():
            self.buckets.append((int(w), torch.nonzero(width == w)[:, 0]))

    def propagate(self, prev: torch.Tensor) -> torch.Tensor:
        """One pass: ``out[x] = max(prev[x], max over neighbours y of
        prev[y])``, register by register, from the frozen ``prev``."""
        out = prev.clone()
        last = self.nbr.numel() - 1
        for w, verts in self.buckets:
            step = max(1, _GATHER_ROWS // w)
            lanes = torch.arange(w, device=prev.device)
            for s in range(0, verts.numel(), step):
                v = verts[s:s + step]
                start = self.indptr[v]
                deg = self.indptr[v + 1] - start
                pos = torch.clamp(start[:, None] + lanes[None, :], max=last)
                src = torch.where(lanes[None, :] < deg[:, None],
                                  self.nbr[pos].to(torch.int64), v[:, None])
                out[v] = torch.maximum(prev[v], prev[src].amax(dim=1))
        return out


def alpha(r: int) -> float:
    """HLL bias correction alpha_r."""
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(r, 0.7213 / (1.0 + 1.079 / r))


def flajolet(s: torch.Tensor, z: torch.Tensor, r: int) -> torch.Tensor:
    """Harmonic-mean estimate with linear counting, from s = sum 2^-reg and
    z = number of zero registers, in the dtype of ``s``."""
    raw = alpha(r) * r * r / s
    lin = r * torch.log(r / torch.clamp(z, min=1.0))
    return torch.where((raw <= 2.5 * r) & (z > 0), lin, raw)


def row_stats(regs: torch.Tensor, dtype: torch.dtype,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, z) of every row of ``regs`` uint8[k, r], in ``dtype``."""
    s = torch.exp2(-regs.to(dtype)).sum(dim=-1, dtype=dtype)
    z = (regs == 0).sum(dim=-1).to(dtype)
    return s, z


def estimates(panel: torch.Tensor, dtype: torch.dtype = torch.float32,
              block: int = 1 << 20) -> torch.Tensor:
    """Flajolet estimate of every row of ``panel`` uint8[n, r], [n]."""
    r = panel.shape[1]
    out = torch.empty(panel.shape[0], dtype=dtype, device=panel.device)
    for s in range(0, panel.shape[0], block):
        out[s:s + block] = flajolet(*row_stats(panel[s:s + block], dtype), r)
    return out
