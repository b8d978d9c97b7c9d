"""Frozen operation and byte counts of the kernels whose rooflines the
benchmark reports, and the chips' published peaks.

Counts come from the shapes of the work, never from a kernel's code: each
input byte the work needs is read once and each output byte written
once, whatever an implementation reads again. So a share moves only when
the time moves.
"""
from __future__ import annotations

#: published peaks (NVIDIA's data sheet, H100 SXM, dense): HBM bytes/s
PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}


def peak(device_kind: str) -> dict:
    """The peaks of the chip whose name ``device_kind`` is (KeyError for a
    chip the table lacks)."""
    for key, value in PEAKS.items():
        if key in device_kind:
            return value
    raise KeyError(f"no published peaks for {device_kind!r}")


def propagate_bytes(n_rows: int, row_bytes: int, n_directed: int) -> int:
    """One Algorithm 2 pass: the register panel read once and written once,
    and the directed routing (an int32 source and destination an edge)
    read once."""
    return 2 * n_rows * row_bytes + 8 * n_directed


def pairstats_bytes(n_pairs: int, n_rows: int, row_bytes: int,
                    q: int) -> int:
    """The pair statistics of ``n_pairs`` pairs over ``n_rows`` distinct
    register rows: each row read once, two int32 ids a pair read once,
    and a pair's float32 Eq. 19 histograms (5 x (q + 2)) and the (s, z)
    of A, B and A ∪ B (3 x 2) written once."""
    return n_rows * row_bytes + 8 * n_pairs + 4 * n_pairs * (5 * (q + 2) + 6)
