"""Plain PyTorch versions of the main-path kernels (the correctness contract).

Counterpart of ``repro.kernels.ref``: each function defines the exact
semantics its CUDA kernel reproduces, runs on any device, and is what a
kernel wrapper calls when its tensors lie on the CPU. ``chip_smoke.py``
holds every kernel against these on the card.

Unlike the jnp oracles, which gather whole ``(E, r)`` panels (``regs[src]``
at a real graph's edge count is tens of GB) and build one-hot
``(B, r, q+2)`` float panels, every function here walks its edges, rows or
pairs in chunks and never holds more than one chunk's intermediates.

Every HLL function takes ``layout``. On a packed panel (``uint8[V, r/2]``,
``kernels.packing``) accumulate folds each insert into its nibble,
propagate scatter-maxes the two nibble planes, and the statistics unpack
one chunk of gathered rows before they reduce, as the JAX package's glue
does (``repro/kernels/ops.py``). A packed register is at most 15, so the
harmonic sum ``s`` of packed rows is taken exactly, as the fixed-point
integer ``sum 2^(15 - reg)`` (at most ``2^16 * 2^15 = 2^31``), and
rounded to float32 once: any order of summation gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.packing import unpack_rows

__all__ = ["hll_accumulate_ref", "hll_propagate_ref",
           "hll_propagate_into_ref", "hll_estimate_ref",
           "union_estimate_ref", "intersection_stats_ref", "ertl_stats_ref",
           "hip_delta_ref", "packed_stats", "EDGE_CHUNK", "ROW_CHUNK",
           "PROPAGATE_CHUNK", "PAIR_CHUNK", "UNION_CHUNK_BYTES",
           "HIP_CHUNK_REGISTERS"]

#: edges per scatter-max step of the accumulate reference
EDGE_CHUNK = 1 << 20
#: rows per reduction step of the estimate reference
ROW_CHUNK = 1 << 16
#: edges per gather/scatter step of the propagate reference (each step
#: holds a (chunk, r) row panel and its int64 flat indices)
PROPAGATE_CHUNK = 1 << 16
#: pairs per step of the intersection- and Eq. 19-statistics references
PAIR_CHUNK = 1 << 14
#: gathered member-row bytes per step of the union reference
UNION_CHUNK_BYTES = 1 << 26
#: registers per step of the HIP-increment reference (each step holds a
#: few int64 panels of this many entries)
HIP_CHUNK_REGISTERS = 1 << 24


def hll_accumulate_ref(regs: torch.Tensor, rows: torch.Tensor,
                       buckets: torch.Tensor, rhos: torch.Tensor,
                       layout: str = "byte") -> torch.Tensor:
    """Scatter-max in place: regs[rows[e], buckets[e]] <- max(., rhos[e]).

    rho == 0 entries are no-ops (the empty register value), which is how
    padding edges are parked. regs: uint8[V, r] (packed: uint8[V, r/2],
    registers clamped to 15); rows/buckets: int[E]; rhos: uint8[E].
    Returns ``regs``.
    """
    if layout == "packed":
        return _accumulate_packed(regs, rows, buckets, rhos)
    r = regs.shape[1]
    flat = regs.view(-1)
    for s in range(0, rows.shape[0], EDGE_CHUNK):
        idx = (rows[s:s + EDGE_CHUNK].to(torch.int64) * r
               + buckets[s:s + EDGE_CHUNK].to(torch.int64))
        flat.scatter_reduce_(0, idx, rhos[s:s + EDGE_CHUNK], reduce="amax")
    return regs


def _accumulate_packed(regs, rows, buckets, rhos):
    """Packed scatter-max in place: register ``b`` of a row lives in byte
    ``b mod r/2``, in the high nibble when ``b >= r/2``.

    Each chunk's inserts are reduced per nibble first (``unique`` over
    ``byte * 2 + high``), then each nibble plane is folded into its bytes
    in one pass over distinct bytes.
    """
    w = regs.shape[1]
    flat = regs.view(-1)
    for s in range(0, rows.shape[0], EDGE_CHUNK):
        b = buckets[s:s + EDGE_CHUNK].to(torch.int64)
        rho = rhos[s:s + EDGE_CHUNK]
        live = rho > 0
        key = (((rows[s:s + EDGE_CHUNK].to(torch.int64) * w + (b % w)) << 1)
               | (b // w))[live]
        keys, inv = torch.unique(key, return_inverse=True)
        best = torch.zeros(keys.shape, dtype=torch.uint8, device=regs.device)
        best.scatter_reduce_(0, inv, torch.clamp(rho[live], max=15),
                             reduce="amax")
        for hi, keep in ((0, 0xF0), (1, 0x0F)):
            sel = (keys & 1) == hi
            idx = keys[sel] >> 1
            old = flat[idx]
            nib = torch.maximum((old >> (4 * hi)) & 0x0F, best[sel])
            flat[idx] = (old & keep) | (nib << (4 * hi))
    return regs


def hll_propagate_ref(regs: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, mask: torch.Tensor,
                      layout: str = "byte") -> torch.Tensor:
    """Row gather-max: out[dst[e]] <- max(out[dst[e]], regs[src[e]]).

    Reads always come from the input ``regs`` (the frozen D^{t-1}); the
    output starts as a copy of it (Algorithm 2 line 23). mask=False
    edges are no-ops. On a packed panel the max runs on the two nibble
    planes. Returns a new panel.
    """
    return hll_propagate_into_ref(regs.clone(), regs, src, dst, mask,
                                  layout=layout)


def hll_propagate_into_ref(out: torch.Tensor, src_panel: torch.Tensor,
                           src: torch.Tensor, dst: torch.Tensor,
                           mask: torch.Tensor,
                           layout: str = "byte") -> torch.Tensor:
    """Two-panel row gather-max in place:
    out[dst[e]] <- max(out[dst[e]], src_panel[src[e]]).

    ``src`` indexes ``src_panel`` (its own rows), ``dst`` indexes ``out``:
    the merge step of the sharded schedules (the JAX package's
    ``packing.scatter_max_rows`` over a gathered panel). Every live edge
    counts, ``src == dst`` included; mask=False edges are no-ops. On a
    packed panel the max runs on the two nibble planes. Returns ``out``.
    """
    packed = layout == "packed"
    planes = [out & 0x0F, out >> 4] if packed else [out]
    w = out.shape[1]
    lanes = torch.arange(w, device=out.device, dtype=torch.int64)
    empty = torch.zeros((), dtype=out.dtype, device=out.device)
    for s in range(0, src.shape[0], PROPAGATE_CHUNK):
        keep = mask[s:s + PROPAGATE_CHUNK, None]
        rows = torch.where(keep, src_panel[src[s:s + PROPAGATE_CHUNK]], empty)
        idx = dst[s:s + PROPAGATE_CHUNK].to(torch.int64)[:, None] * w + lanes
        vals = [rows & 0x0F, rows >> 4] if packed else [rows]
        for plane, v in zip(planes, vals):
            plane.view(-1).scatter_reduce_(0, idx.reshape(-1), v.reshape(-1),
                                           reduce="amax")
    if packed:
        out.copy_(planes[0] | (planes[1] << 4))
    return out


def packed_stats(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (s, z) of unpacked registers ``u`` (values <= 15), ``[..., r]``.

    ``s`` is the integer ``sum 2^(15 - reg)`` rounded to float32 once and
    scaled by 2^-15 (exact); ``z`` the zero count. Returns float32 panels
    shaped like ``u`` without its last axis.
    """
    one = torch.ones((), dtype=torch.int64, device=u.device)
    x = u.to(torch.int64)
    fix = torch.bitwise_left_shift(one, 15 - x).sum(dim=-1)
    return (fix.to(torch.float32) * 2.0 ** -15,
            (x == 0).sum(dim=-1).to(torch.float32))


def hll_estimate_ref(regs: torch.Tensor, layout: str = "byte",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Harmonic statistics (sum 2^-reg, zero count) per sketch row.

    regs: uint8[N, r] (packed: uint8[N, r/2], summed exactly by
    :func:`packed_stats`) -> (float32[N], float32[N]). On the byte layout
    ``s`` is summed in float64 and rounded to float32 once, as the kernel
    rounds its exact sum once: while every register is at most ``52 - p``
    (p=8: 44) every partial float64 sum is exact, so the two agree bit
    for bit, whatever the order of summation.
    """
    n = regs.shape[0]
    s = torch.empty(n, dtype=torch.float32, device=regs.device)
    z = torch.empty(n, dtype=torch.float32, device=regs.device)
    for i in range(0, n, ROW_CHUNK):
        blk = regs[i:i + ROW_CHUNK]
        if layout == "packed":
            s[i:i + ROW_CHUNK], z[i:i + ROW_CHUNK] = packed_stats(
                unpack_rows(blk))
            continue
        s[i:i + ROW_CHUNK] = torch.exp2(-blk.to(torch.float64)).sum(dim=-1)
        z[i:i + ROW_CHUNK] = (blk == 0).sum(dim=-1).to(torch.float32)
    return s, z


def union_estimate_ref(regs: torch.Tensor, ids: torch.Tensor,
                       mask: torch.Tensor, layout: str = "byte",
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused union statistics: (s, z) of the masked lane-wise row max.

    regs: uint8[V, r] (packed: uint8[V, r/2]); ids: int[B, L]; mask:
    bool[B, L] -> (float32[B], float32[B]), L >= 1. Masked lanes merge the
    empty row, never the row their id names (padding ids are 0); a fully
    masked set row reduces to the empty sketch, ``(s, z) = (r, r)``. On
    the byte layout ``s`` is summed in float64 and rounded once, as the
    kernel sums it: a merged row holds mostly large register values,
    where a float32 running sum drifts. Packed rows are unpacked before
    the max and ``s`` is summed exactly (:func:`packed_stats`).
    """
    b, lanes = ids.shape
    w = regs.shape[1]
    s = torch.empty(b, dtype=torch.float32, device=regs.device)
    z = torch.empty(b, dtype=torch.float32, device=regs.device)
    step = max(1, UNION_CHUNK_BYTES // (lanes * w))
    empty = torch.zeros((), dtype=regs.dtype, device=regs.device)
    for i in range(0, b, step):
        rows = torch.where(mask[i:i + step, :, None],
                           regs[ids[i:i + step].to(torch.int64)], empty)
        if layout == "packed":
            s[i:i + step], z[i:i + step] = packed_stats(
                unpack_rows(rows).amax(dim=1))
            continue
        merged = rows.amax(dim=1)
        s[i:i + step] = torch.exp2(-merged.to(torch.float64)).sum(dim=-1)
        z[i:i + step] = (merged == 0).sum(dim=-1).to(torch.float32)
    return s, z


def _pair_histograms(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """Eq. 19 count statistics of row pairs: int64 (C, r) x2 -> f32[C, 5, q+2].

    Order: [c_a_lt, c_a_gt, c_b_lt, c_b_gt, c_eq] as in
    ``repro.kernels.ref.ertl_stats_ref``; values outside [0, q+2) land in
    no bin, like a one-hot over ``arange(q + 2)``.
    """
    c, nb = a.shape[0], q + 2
    base = torch.arange(c, device=a.device, dtype=torch.int64)[:, None] * nb
    lt, gt, eq = a < b, a > b, a == b
    out = torch.zeros((5, c * nb), dtype=torch.float32, device=a.device)
    for j, (vals, cond) in enumerate(((a, lt), (a, gt), (b, gt), (b, lt),
                                      (a, eq))):
        hit = cond & (vals < nb)
        idx = base + torch.clamp(vals, max=nb - 1)
        out[j].index_add_(0, idx.reshape(-1), hit.reshape(-1).to(torch.float32))
    return out.view(5, c, nb).transpose(0, 1)


def intersection_stats_ref(regs: torch.Tensor, pa: torch.Tensor,
                           pb: torch.Tensor, q: int, layout: str = "byte",
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused pair statistics: Eq. 19 histograms + (s, z) for A, B, A ∪ B.

    regs: uint8[V, r] (packed: uint8[V, r/2]); pa/pb: int[B] ->
    (float32[B, 5, q+2], float32[B, 3, 2]) with the (s, z) panel stacked
    [A, B, A ∪ B].
    """
    n = pa.shape[0]
    stats = torch.empty((n, 5, q + 2), dtype=torch.float32, device=regs.device)
    sz = torch.empty((n, 3, 2), dtype=torch.float32, device=regs.device)
    for s in range(0, n, PAIR_CHUNK):
        a = regs[pa[s:s + PAIR_CHUNK]]
        b = regs[pb[s:s + PAIR_CHUNK]]
        if layout == "packed":
            a, b = unpack_rows(a), unpack_rows(b)
        stats[s:s + PAIR_CHUNK] = _pair_histograms(
            a.to(torch.int64), b.to(torch.int64), q)
        for col, panel in enumerate((a, b, torch.maximum(a, b))):
            s_, z_ = (packed_stats(panel) if layout == "packed"
                      else hll_estimate_ref(panel))
            sz[s:s + PAIR_CHUNK, col, 0] = s_
            sz[s:s + PAIR_CHUNK, col, 1] = z_
    return stats, sz


def ertl_stats_ref(a: torch.Tensor, b: torch.Tensor, q: int,
                   layout: str = "byte") -> torch.Tensor:
    """Eq. 19 count statistics of given row pairs.

    a, b: uint8[E, r] (packed: uint8[E, r/2], unpacked one chunk at a
    time) -> float32[E, 5, q+2], ordered [c_a_lt, c_a_gt, c_b_lt, c_b_gt,
    c_eq]; register values outside [0, q+2) land in no bin.
    """
    e = a.shape[0]
    out = torch.empty((e, 5, q + 2), dtype=torch.float32, device=a.device)
    for s in range(0, e, PAIR_CHUNK):
        x, y = a[s:s + PAIR_CHUNK], b[s:s + PAIR_CHUNK]
        if layout == "packed":
            x, y = unpack_rows(x), unpack_rows(y)
        out[s:s + PAIR_CHUNK] = _pair_histograms(x.to(torch.int64),
                                                 y.to(torch.int64), q)
    return out


def hip_delta_ref(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Batch-HIP increments: sum_j [cur_j > prev_j] * 2^prev_j per row.

    prev/cur: uint8[N, r] byte-layout panels -> float32[N]; a register
    that fell contributes nothing. The sum is taken exactly and rounded
    to float32 once, so any order of summation gives the same bits, as
    the kernel's fixed shuffle tree does: the terms 2^x with x < 32 are
    summed as int64 ``lo``, those with 32 <= x < 64 as int64 ``hi`` in
    units of 2^32 (both below 2^48 for r <= 2^16), and the result is
    ``float32((hi * 2^32 + lo) + big)`` in float64, where ``big`` sums
    the terms with x >= 64 in float64. No ADS register reaches 64
    (``ADSConfig.max_register`` is 65 - p), so ``big`` is 0 on real
    panels.
    """
    n, r = prev.shape
    out = torch.empty(n, dtype=torch.float32, device=prev.device)
    one = torch.ones((), dtype=torch.int64, device=prev.device)
    zero = torch.zeros((), dtype=torch.int64, device=prev.device)
    step = max(1, HIP_CHUNK_REGISTERS // r)
    for i in range(0, n, step):
        x = prev[i:i + step].to(torch.int64)
        grew = cur[i:i + step] > prev[i:i + step]
        lo = torch.where(grew & (x < 32),
                         torch.bitwise_left_shift(one, x.clamp(max=31)),
                         zero).sum(dim=-1)
        hi = torch.where(grew & (x >= 32) & (x < 64),
                         torch.bitwise_left_shift(one, (x - 32).clamp(0, 31)),
                         zero).sum(dim=-1)
        big = torch.where(grew & (x >= 64), torch.exp2(x.to(torch.float64)),
                          0.0).sum(dim=-1)
        out[i:i + step] = (hi.to(torch.float64) * 2.0 ** 32
                                + lo.to(torch.float64) + big).to(torch.float32)
    return out
