"""Eq. 19 count statistics of given register-row pairs.

Wrapper of ``csrc/ertl_stats.cu``, the port of the Pallas kernel
``repro.kernels.ertl_stats.ertl_stats``: for each pair of rows
``(a[i], b[i])`` of two ``uint8[E, r]`` panels, the count histograms
``float32[E, 5, q+2]`` ordered ``[c_a_lt, c_a_gt, c_b_lt, c_b_gt,
c_eq]``, which ``core.intersection.mle_cardinalities`` feeds to the MLE.
Unlike the Pallas kernel, E need not be a multiple of a pair block. On
the packed layout (``uint8[E, r/2]``, launcher ``ertl_stats_packed``)
bins 16..q+1 stay empty. ``pair_block`` is the kernel's pairs a block
(``kernels.autotune``; ``None``: the fallback), checked against the op's
grid on every device.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["ertl_stats", "plain"]


def plain(a: torch.Tensor, b: torch.Tensor, q: int, *,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.ertl_stats_ref``)."""
    return ref.ertl_stats_ref(a, b, q, layout=layout)


def ertl_stats(a: torch.Tensor, b: torch.Tensor, q: int, *,
               layout: str = "byte",
               pair_block: int | None = None) -> torch.Tensor:
    """a, b: uint8[E, r] (packed: uint8[E, r/2]) -> float32[E, 5, q+2]
    Eq. 19 histograms."""
    pair_block = autotune.check_block("ertl_stats", "pair_block", pair_block)
    on_card = _build.check_device(a, "a")
    e, r = _build.check_panel(a, layout)
    if b.device != a.device or _build.check_panel(b, layout) != (e, r):
        raise ValueError(f"b must match a: got {b.device}{list(b.shape)}, "
                         f"a is {a.device}{list(a.shape)}")
    if not 1 <= q <= 63:
        raise ValueError(f"q must be in [1, 63], got {q}")
    if not on_card:
        return plain(a, b, q, layout=layout)
    stats = torch.empty((e, 5, q + 2), dtype=torch.float32, device=a.device)
    _build.launch(_build.kernel_name("ertl_stats", layout), a.device,
                  a.data_ptr(), b.data_ptr(), stats.data_ptr(), e, r, q,
                  pair_block, _build.stream_of(a))
    return stats
