"""HLL row gather-max propagation (the Algorithm 2 hot loop).

Wrapper of ``csrc/hll_propagate.cu``, the port of the Pallas kernel
``repro.kernels.hll_propagate.hll_propagate``: ``out`` starts as a fresh
clone of ``regs`` (Algorithm 2 line 23, ``D^t <- D^{t-1}``), then
``out[dst[e]] max= regs[src[e]]`` for every edge, always reading the
frozen input, never ``out``. Padding slots route ``(0, 0)``, a self-merge
no-op. On the packed layout (``uint8[V, r/2]``, launcher
``hll_propagate_packed``) the max is taken nibble by nibble.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["hll_propagate", "plain"]


def plain(regs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.hll_propagate_ref``, every edge live)."""
    return ref.hll_propagate_ref(
        regs, src, dst, torch.ones_like(src, dtype=torch.bool), layout=layout)


def hll_propagate(regs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  *, layout: str = "byte") -> torch.Tensor:
    """regs: uint8[V, r] (packed: uint8[V, r/2]); src/dst: int32[E] in
    [0, V) -> a new panel of the same shape."""
    on_card = _build.check_device(regs, "regs")
    v, r = _build.check_panel(regs, layout)
    _build.check_ids(src, "src", regs)
    _build.check_ids(dst, "dst", regs, src.shape[0])
    if not on_card:
        return plain(regs, src, dst, layout=layout)
    out = regs.clone()
    _build.launch(_build.kernel_name("hll_propagate", layout), regs.device,
                  regs.data_ptr(), out.data_ptr(), src.data_ptr(),
                  dst.data_ptr(), src.shape[0], v, r, _build.stream_of(regs))
    return out
