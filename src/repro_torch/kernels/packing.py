"""Sub-byte register packing: 4-bit HLL lanes, two registers per byte.

Port of ``repro.kernels.packing`` (same names, same semantics) on torch
tensors. HLL registers need at most 6 bits (rho <= q + 1 = 65 - p); the
``packed`` layout stores two registers per byte in 4-bit lanes, halving
the device bytes of every register panel, while the ``byte`` layout keeps
one register per byte.

Lane layout is **split-half**: for a row of ``r`` registers, byte ``j``
holds register ``j`` in its low nibble and register ``j + r/2`` in its
high nibble, so packing is two shifts and a concatenation, and every
estimator in the repo (harmonic sums, zero counts, Eq. 19 histograms) is
symmetric under that fixed permutation of registers.

Saturation: a lane holds 0..15, so packing clamps ``reg -> min(reg,
15)``. The clamp commutes exactly with the HLL merge operator
(``min(max(a, b), 15) == max(min(a, 15), min(b, 15))``), so any sequence
of packed merges equals the packed image of the byte-layout result.
Estimates equal the byte layout's until some register exceeds 15
(probability ``2^-15`` per insert); past that the packed harmonic sum is
larger by at most ``2^-15`` per saturated register.

Every function is plain tensor code and runs on the CPU and the card.
"""
from __future__ import annotations

import torch

__all__ = [
    "LAYOUTS", "LANE_BITS", "LANES_PER_BYTE", "SATURATION",
    "validate_layout", "row_width", "pack_rows", "unpack_rows",
    "max_rows", "merge_rows", "scatter_max_rows", "to_layout",
]

#: supported register-panel layouts: one byte per register ("byte") or
#: two 4-bit lanes per byte ("packed").
LAYOUTS = ("byte", "packed")

#: bits per packed register lane.
LANE_BITS = 4

#: registers stored per byte in the packed layout.
LANES_PER_BYTE = 2

#: largest register value a packed lane can hold; packing clamps to it.
SATURATION = (1 << LANE_BITS) - 1

_LO = 0x0F


def validate_layout(layout: str) -> str:
    """Return ``layout`` if supported, else raise ``ValueError``."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    return layout


def row_width(r: int, layout: str) -> int:
    """Bytes per register row of ``r`` registers under ``layout``."""
    validate_layout(layout)
    if layout == "byte":
        return r
    if r % LANES_PER_BYTE:
        raise ValueError(f"packed layout needs an even register count, "
                         f"got r={r}")
    return r // LANES_PER_BYTE


def pack_rows(regs: torch.Tensor) -> torch.Tensor:
    """Pack byte-layout rows ``uint8[..., r]`` to ``uint8[..., r/2]``.

    Split-half lanes: ``out[..., j] = min(regs[..., j], 15) |
    (min(regs[..., j + r/2], 15) << 4)``.
    """
    r = regs.shape[-1]
    if r % LANES_PER_BYTE:
        raise ValueError(f"cannot pack an odd register count, got r={r}")
    half = r // LANES_PER_BYTE
    regs = regs.to(torch.uint8)
    lo = torch.clamp(regs[..., :half], max=SATURATION)
    hi = torch.clamp(regs[..., half:], max=SATURATION)
    return lo | (hi << LANE_BITS)


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """Unpack ``uint8[..., r/2]`` packed rows back to ``uint8[..., r]``.

    Exact inverse of :func:`pack_rows` on the packed domain:
    ``pack_rows(unpack_rows(x)) == x`` bit for bit for every byte panel.
    """
    p = packed.to(torch.uint8)
    return torch.cat([p & _LO, p >> LANE_BITS], dim=-1)


def max_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Nibble-wise max of two packed panels (the packed merge operator).

    A byte-wise ``torch.maximum`` is WRONG on packed bytes (0x10 vs 0x01
    must merge to 0x11, not 0x10); each 4-bit lane maxes on its own.
    """
    lo = torch.maximum(a & _LO, b & _LO)
    hi = torch.maximum(a >> LANE_BITS, b >> LANE_BITS)
    return lo | (hi << LANE_BITS)


def merge_rows(a: torch.Tensor, b: torch.Tensor,
               layout: str = "byte") -> torch.Tensor:
    """Layout-aware HLL merge: byte-wise or nibble-wise register max."""
    if layout == "packed":
        return max_rows(a, b)
    return torch.maximum(a, b)


def scatter_max_rows(regs: torch.Tensor, dst: torch.Tensor,
                     rows: torch.Tensor, layout: str = "byte") -> torch.Tensor:
    """Layout-aware row scatter-merge, ``out[dst[e]] max= rows[e]``.

    Returns a new panel. The packed form runs two scatter-maxes over the
    nibble planes and recombines them, which is the nibble-wise max
    accumulation a single byte-wise scatter-max is not.
    """
    w = regs.shape[-1]
    idx = (dst.to(torch.int64)[:, None] * w
           + torch.arange(w, device=regs.device)).reshape(-1)
    if layout != "packed":
        out = regs.clone()
        out.view(-1).scatter_reduce_(0, idx, rows.reshape(-1), reduce="amax")
        return out
    lo, hi = regs & _LO, regs >> LANE_BITS
    lo.view(-1).scatter_reduce_(0, idx, (rows & _LO).reshape(-1),
                                reduce="amax")
    hi.view(-1).scatter_reduce_(0, idx, (rows >> LANE_BITS).reshape(-1),
                                reduce="amax")
    return lo | (hi << LANE_BITS)


def to_layout(rows: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert a register panel between layouts (identity when equal).

    ``byte -> packed`` saturates (see :func:`pack_rows`); ``packed ->
    byte`` is exact. Used by ``engine.load`` and ``merge`` when the
    caller's layout differs from the panel's.
    """
    validate_layout(src)
    validate_layout(dst)
    if src == dst:
        return rows
    if src == "byte":
        return pack_rows(rows)
    return unpack_rows(rows)
