"""Fused batch-HIP increments between two hop panels.

Wrapper of ``csrc/hip_delta.cu``, the port of the Pallas kernel
``repro.kernels.hip_delta.hip_delta_rows``: for each row of two
``uint8[N, r]`` panels ``prev`` (D^{t-1}) and ``cur`` (D^t),
``sum_j [cur_j > prev_j] * 2**prev_j``, returned as ``float32[N]``.
Byte layout only: the ADS family never packs its registers. Unlike the
Pallas kernel, N need not be a multiple of a row block.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version. Both sum exactly and round once,
so they agree bit for bit. ``row_block`` is the kernel's block size in
threads (``kernels.autotune``; ``None``: the fallback), checked against
the op's grid on every device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["hip_delta_rows", "plain"]


def plain(prev: torch.Tensor, cur: torch.Tensor, *,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.hip_delta_ref``), float32[N]."""
    return ref.hip_delta_ref(prev, cur)


def hip_delta_rows(prev: torch.Tensor, cur: torch.Tensor, *,
                   layout: str = "byte",
                   row_block: int | None = None) -> torch.Tensor:
    """prev/cur: uint8[N, r] -> float32[N] summed inverse change
    probabilities of the registers that grew from ``prev`` to ``cur``."""
    row_block = autotune.check_block("hip_delta", "row_block", row_block)
    if layout != "byte":
        raise ValueError(f"hip_delta_rows requires byte layout (the ADS "
                         f"family never packs), got {layout!r}")
    on_card = _build.check_device(prev, "prev")
    n, r = _build.check_panel(prev, layout)
    _build.check_panel(cur, layout)
    if cur.shape != prev.shape or cur.device != prev.device:
        raise ValueError(f"cur {list(cur.shape)} on {cur.device} must match "
                         f"prev {list(prev.shape)} on {prev.device}")
    if not on_card:
        return plain(prev, cur, layout=layout)
    out = torch.empty(n, dtype=torch.float32, device=prev.device)
    _build.launch("hip_delta_rows", prev.device, prev.data_ptr(),
                  cur.data_ptr(), out.data_ptr(), n, r, row_block,
                  _build.stream_of(prev))
    return out
