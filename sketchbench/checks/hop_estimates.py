"""Check: the per-vertex t-hop estimates the last neighborhood call
returned.

The widest gap, over every hop and vertex, between the program's
estimate and the reference's, as a share of the reference's (at least
1). The propagation and the estimate are judged here.
"""
from __future__ import annotations

import torch


def _t_max(record) -> int:
    return int(record.args[0])


def capture(record, engine):
    """The local estimates float64[t_max, n] as the call returned them."""
    return record.result[0]


def control(record, ref):
    """The low-precision reference's estimates, in the call's shape."""
    return ref.hop_estimates(_t_max(record)).to(torch.float64).cpu().numpy()


def compare(got, record, ref) -> dict:
    """{"hop_gap": the widest relative gap to the reference}."""
    want = ref.hop_estimates(_t_max(record)).to(torch.float64)
    got = torch.from_numpy(got).to(want.device)
    gap = (got - want).abs() / torch.clamp(want.abs(), min=1.0)
    return {"hop_gap": float(gap.max())}
