"""Fused HLL estimate statistics: per-row harmonic sum and zero count.

Wrapper of ``csrc/hll_estimate.cu``, the port of the Pallas kernel
``repro.kernels.hll_estimate.hll_estimate_stats``: for each row of a
``uint8[N, r]`` panel, ``s = sum 2^-reg`` and ``z = #zero registers``,
returned as ``float32[N, 2]``. Unlike the Pallas kernel, N need not be a
multiple of a row block. On the packed layout (``uint8[N, r/2]``,
launcher ``hll_estimate_stats_packed``) ``s`` is summed exactly, so the
kernel and the plain version agree bit for bit. ``row_block`` is the
kernel's block size in threads (``kernels.autotune``; ``None``: the
fallback), checked against the op's grid on every device.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["hll_estimate_stats", "plain"]


def plain(regs: torch.Tensor, *, layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.hll_estimate_ref``), float32[N, 2]."""
    s, z = ref.hll_estimate_ref(regs, layout=layout)
    return torch.stack([s, z], dim=1)


def hll_estimate_stats(regs: torch.Tensor, *, layout: str = "byte",
                       row_block: int | None = None) -> torch.Tensor:
    """regs: uint8[N, r] (packed: uint8[N, r/2]) -> float32[N, 2] = (s, z)
    per row."""
    row_block = autotune.check_block("estimate", "row_block", row_block)
    on_card = _build.check_device(regs, "regs")
    n, r = _build.check_panel(regs, layout)
    if not on_card:
        return plain(regs, layout=layout)
    out = torch.empty((n, 2), dtype=torch.float32, device=regs.device)
    _build.launch(_build.kernel_name("hll_estimate_stats", layout),
                  regs.device, regs.data_ptr(), out.data_ptr(), n, r,
                  row_block, _build.stream_of(regs))
    return out
