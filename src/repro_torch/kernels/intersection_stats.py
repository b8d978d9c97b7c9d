"""Fused intersection pair statistics for the T̃(xy) estimator.

Wrapper of ``csrc/intersection_stats.cu``, the port of the Pallas kernel
``repro.kernels.intersection_stats.intersection_stats``: for each pair
``(pa[i], pb[i])`` it gathers both sketches and emits the Eq. 19 count
histograms ``float32[B, 5, q+2]`` and the ``(s, z)`` statistics of A, B
and A ∪ B, ``float32[B, 3, 2]``, which is everything
``core.intersection.estimate_from_pair_stats`` reads. On the packed
layout (``uint8[V, r/2]``, launcher ``intersection_stats_packed``) the
``(s, z)`` sums are exact. ``pair_block`` is the most pairs a warp of
the kernel takes at once (``kernels.autotune``; ``None``: the fallback),
checked against the op's grid on every device.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["intersection_stats", "plain"]


def plain(regs: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor, q: int, *,
          layout: str = "byte") -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (``ref.intersection_stats_ref``)."""
    return ref.intersection_stats_ref(regs, pa, pb, q, layout=layout)


def intersection_stats(regs: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
                       q: int, *, layout: str = "byte",
                       pair_block: int | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """regs: uint8[V, r] (packed: uint8[V, r/2]); pa/pb: int32[B] in [0, V) ->
    (float32[B, 5, q+2] Eq. 19 stats, float32[B, 3, 2] (s, z) panels)."""
    pair_block = autotune.check_block("intersection_stats", "pair_block",
                                      pair_block)
    on_card = _build.check_device(regs, "regs")
    v, r = _build.check_panel(regs, layout)
    _build.check_ids(pa, "pa", regs)
    _build.check_ids(pb, "pb", regs, pa.shape[0])
    if not 1 <= q <= 63:
        raise ValueError(f"q must be in [1, 63], got {q}")
    if not on_card:
        return plain(regs, pa, pb, q, layout=layout)
    b = pa.shape[0]
    stats = torch.empty((b, 5, q + 2), dtype=torch.float32, device=regs.device)
    sz = torch.empty((b, 3, 2), dtype=torch.float32, device=regs.device)
    _build.launch(_build.kernel_name("intersection_stats", layout),
                  regs.device, regs.data_ptr(),
                  pa.data_ptr(), pb.data_ptr(), stats.data_ptr(),
                  sz.data_ptr(), b, v, r, q, pair_block,
                  _build.stream_of(regs))
    return stats, sz
