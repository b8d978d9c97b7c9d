"""Roofline terms of one call on the H100 (port of
``repro.analysis.roofline``'s ``HW`` and ``roofline_terms``).

The three terms, in seconds, for one device:

  compute    = flops / peak_flops
  memory     = bytes / hbm_bw
  collective = wire bytes / link_bw

and the bound is the largest. :class:`HW` defaults to one NVIDIA H100
SXM at its 700 W limit, from NVIDIA's H100 data sheet and the Hopper
architecture white paper: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, and 25 GB/s for ``link_bw``, which is one NVLink 4
link in one direction (the card's 900 GB/s is the sum over its 18 links
of both directions). The sketch kernels do integer work outside the
tensor cores, so their compute term is far below their memory term; the
models (``analysis.flops``) count bytes first.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["HW", "roofline_terms"]


@dataclass(frozen=True)
class HW:
    """Peak rates of one device: FLOP/s, device-memory bytes/s, and bytes/s
    of one inter-device link in one direction (defaults: H100 SXM)."""

    peak_flops: float = 989e12   # dense bf16, tensor cores
    hbm_bw: float = 3.35e12      # HBM3 bytes/s
    link_bw: float = 25e9        # one NVLink 4 link, one direction


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float, hw: HW = HW()) -> dict:
    """The compute, memory and collective times of one call, the dominant
    term, the bound (their maximum) and the compute term's share of it."""
    t_comp = flops_per_dev / hw.peak_flops
    t_mem = bytes_per_dev / hw.hbm_bw
    t_coll = wire_bytes_per_dev / hw.link_bw
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    bound = max(t_comp, t_mem, t_coll)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        # the compute term's share of the bound: how close the call is to
        # being compute-limited
        "compute_fraction": t_comp / bound if bound > 0 else 0.0,
    }
