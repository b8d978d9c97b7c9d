"""Fused union cardinality statistics over padded vertex-id sets.

Wrapper of ``csrc/union_estimate.cu``, the port of the Pallas kernel
``repro.kernels.union_estimate.union_estimate_stats``: for each row of a
padded id panel ``int32[B, L]`` with validity mask ``bool[B, L]``, the
lane-wise max of the unmasked member rows, reduced to ``(s, z)`` and
returned as ``float32[B, 2]``. Masked lanes merge the empty row; a fully
masked row gives the empty sketch's ``(r, r)``. Unlike the Pallas
kernel, B need not be a multiple of a set block. On the packed layout
(``uint8[V, r/2]``, launcher ``union_estimate_stats_packed``) the rows
merge nibble by nibble and ``s`` is summed exactly. ``set_block`` is the
kernel's sets a block (``kernels.autotune``; ``None``: the fallback),
checked against the op's grid on every device.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["union_estimate_stats", "plain"]


def plain(regs: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor, *,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.union_estimate_ref``), float32[B, 2]."""
    s, z = ref.union_estimate_ref(regs, ids, mask, layout=layout)
    return torch.stack([s, z], dim=1)


def union_estimate_stats(regs: torch.Tensor, ids: torch.Tensor,
                         mask: torch.Tensor, *, layout: str = "byte",
                         set_block: int | None = None) -> torch.Tensor:
    """regs: uint8[V, r] (packed: uint8[V, r/2]); ids: int32[B, L] in
    [0, V); mask: bool[B, L],
    L >= 1 -> float32[B, 2] = (s, z) of each set's masked union row."""
    set_block = autotune.check_block("union_estimate", "set_block", set_block)
    on_card = _build.check_device(regs, "regs")
    v, r = _build.check_panel(regs, layout)
    for t, name, dtype in ((ids, "ids", torch.int32),
                           (mask, "mask", torch.bool)):
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} "
                             f"tensor, got {t.dtype}{list(t.shape)}")
        if t.device != regs.device:
            raise ValueError(f"{name} is on {t.device}, regs on {regs.device}")
    if mask.shape != ids.shape or ids.shape[1] < 1:
        raise ValueError(f"ids {list(ids.shape)} and mask {list(mask.shape)} "
                         f"must share one shape [B, L] with L >= 1")
    if not on_card:
        return plain(regs, ids, mask, layout=layout)
    b, lanes = ids.shape
    out = torch.empty((b, 2), dtype=torch.float32, device=regs.device)
    _build.launch(_build.kernel_name("union_estimate_stats", layout),
                  regs.device, regs.data_ptr(),
                  ids.data_ptr(), mask.data_ptr(), out.data_ptr(), b, v,
                  lanes, r, set_block, _build.stream_of(regs))
    return out
