"""Analytic per-call HBM-byte and FLOP models of the sketch kernels (port
of the sketch half of ``repro.analysis.flops``, the same formulas).

The dominant traffic terms follow from shapes alone. The register panel
is the only term the packed layout changes, a row costing ``r`` bytes in
the byte layout and ``r/2`` packed, so the byte/packed ratio of these
models is the device-memory saving the packing buys a query. Fed to
``analysis.roofline.roofline_terms``, they give each op's modeled bound
(``chip_smoke.py``'s autotune phase prints each swept winner beside it).
``ertl_stats`` and ``hip_delta`` have no model, as in the JAX package.
"""
from __future__ import annotations

__all__ = ["SKETCH_OPS", "sketch_op_costs"]

#: the kernel ops the model covers
SKETCH_OPS = ("accumulate", "propagate", "estimate",
              "union_estimate", "intersection_stats")

#: rough scalar-op cost of one fused hash64 + bucket/rho split (two fmix32
#: chains of about 10 ops each, the cross-mix, the clz window): the
#: compute term only; the ops are memory-bound either way
_HASH_FLOPS = 40.0


def _lane_width(p: int, layout: str) -> int:
    """Bytes a register row takes: r byte, r/2 packed."""
    r = 1 << p
    if layout == "packed":
        return r // 2
    if layout != "byte":
        raise ValueError(f"unknown layout {layout!r}")
    return r


def sketch_op_costs(op: str, *, p: int, layout: str = "byte",
                    n: int = 1 << 16, edges: int = 1 << 16,
                    sets: int = 256, set_size: int = 8,
                    pairs: int = 1 << 12) -> dict:
    """Modeled per-call HBM bytes and FLOPs of one sketch kernel op.

    Shapes: ``n`` register rows, ``edges`` routed edge slots
    (accumulate/propagate), ``sets`` union sets of ``set_size`` members,
    ``pairs`` intersection pairs. Returns ``{"hbm_bytes", "flops"}``.
    Only the register-panel terms depend on ``layout``; index, mask and
    output traffic is layout-invariant, which is why the modeled byte
    ratio is slightly below the raw 2x lane packing.
    """
    if op not in SKETCH_OPS:
        raise ValueError(f"op must be one of {SKETCH_OPS}, got {op!r}")
    r = 1 << p
    q = 64 - p
    w = _lane_width(p, layout)
    if op == "accumulate":
        # panel read+write, plus per-edge row index (i32), key (i32), mask
        return {"hbm_bytes": 2.0 * n * w + edges * 9.0,
                "flops": edges * (_HASH_FLOPS + 2.0 * w)}
    if op == "propagate":
        # panel read+write, gathered source rows, src/dst indices + mask
        return {"hbm_bytes": 2.0 * n * w + edges * (w + 9.0),
                "flops": edges * 2.0 * w}
    if op == "estimate":
        # panel read, one f32 estimate per row out
        return {"hbm_bytes": n * w + n * 4.0,
                "flops": n * 4.0 * r}
    if op == "union_estimate":
        # gathered member rows, member ids (i32) + mask, one f32 per set
        rows = sets * set_size
        return {"hbm_bytes": rows * w + rows * 5.0 + sets * 4.0,
                "flops": rows * 2.0 * w + sets * 4.0 * r}
    # intersection_stats: two gathered rows per pair, pair ids, the
    # (5, q+2) f32 histogram panel out
    return {"hbm_bytes": pairs * (2.0 * w + 8.0 + 5.0 * (q + 2) * 4.0),
            "flops": pairs * (q + 2) * 4.0 * r}
