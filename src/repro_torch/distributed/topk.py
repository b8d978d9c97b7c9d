"""Distributed top-k over per-shard candidates (port of
``repro.distributed.topk``).

Each shard takes its local ``torch.topk``, the candidates are gathered
onto one device, and a global top-k is taken over them. Exact: an element
of the global top-k is in its owner shard's local top-k. Ids travel as
integer tensors beside the float values, never inside float lanes (a
float32 lane holds integers exactly only up to 2^24).
"""
from __future__ import annotations

import torch

__all__ = ["distributed_topk"]


def distributed_topk(values: list[torch.Tensor], ids: list[torch.Tensor],
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Global top-k of per-shard ``(values[s], ids[s])``.

    ``values[s]`` is float[E_s] and ``ids[s]`` an integer tensor whose
    first axis is E_s (ids may carry trailing axes, as edge pairs do);
    each pair lives on its shard's device. The candidates gather onto the
    first shard's device. Returns ``(vals[kk],
    ids[kk, ...])`` in descending order, ``kk = min(k, sum E_s)``.
    """
    device = values[0].device
    cand_v, cand_i = [], []
    for v, i in zip(values, ids):
        kk = min(k, v.shape[0])
        lv, li = torch.topk(v, kk)
        cand_v.append(lv.to(device))
        cand_i.append(i[li].to(device))
    allv = torch.cat(cand_v)
    alli = torch.cat(cand_i)
    gv, gi = torch.topk(allv, min(k, allv.shape[0]))
    return gv, alli[gi]
