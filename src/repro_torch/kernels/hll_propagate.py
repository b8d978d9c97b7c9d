"""HLL row gather-max propagation (the Algorithm 2 hot loop).

Wrapper of ``csrc/hll_propagate.cu``, the port of the Pallas kernel
``repro.kernels.hll_propagate.hll_propagate``: ``out`` starts as a fresh
clone of ``regs`` (Algorithm 2 line 23, ``D^t <- D^{t-1}``), then
``out[dst[e]] max= regs[src[e]]`` for every edge, always reading the
frozen input, never ``out``. Padding slots route ``(0, 0)``, a self-merge
no-op. On the packed layout (``uint8[V, r/2]``, launcher
``hll_propagate_packed``) the max is taken nibble by nibble.

The kernel is a pull over a routing sorted by ``dst``: on a CUDA tensor
the wrapper requires ``dst`` to be non-decreasing (one pass over it) and
raises ``ValueError`` otherwise; :func:`sort_routing` puts any routing in
that order, the engine builds its routing with it once per version, and
``ops.propagate`` sorts a routing it finds out of order.
On a CPU tensor the wrapper runs :func:`plain`, the plain PyTorch
version, which takes the edges in any order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["dst_sorted", "hll_propagate", "plain", "sort_routing"]


def sort_routing(src: torch.Tensor, dst: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing ``(src, dst)`` stably sorted by ``dst``, on the
    tensors' device: the order the card's kernel reads. Edges with equal
    ``dst`` keep their input order. The answer of a pass does not depend
    on the order (register max is commutative and idempotent)."""
    dst_sorted, order = torch.sort(dst, stable=True)
    return src[order], dst_sorted


def dst_sorted(dst: torch.Tensor) -> bool:
    """Whether ``dst`` is non-decreasing (one pass, a host sync on the
    card): the order the card's kernel takes."""
    return dst.shape[0] < 2 or not bool((dst[1:] < dst[:-1]).any())


def plain(regs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version (``ref.hll_propagate_ref``, every edge live)."""
    return ref.hll_propagate_ref(
        regs, src, dst, torch.ones_like(src, dtype=torch.bool), layout=layout)


def hll_propagate(regs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  *, layout: str = "byte") -> torch.Tensor:
    """regs: uint8[V, r] (packed: uint8[V, r/2]); src/dst: int32[E] in
    [0, V), ``dst`` non-decreasing on the card -> a new panel of the same
    shape."""
    on_card = _build.check_device(regs, "regs")
    v, r = _build.check_panel(regs, layout)
    _build.check_ids(src, "src", regs)
    _build.check_ids(dst, "dst", regs, src.shape[0])
    if not on_card:
        return plain(regs, src, dst, layout=layout)
    if regs.data_ptr() % 16:
        raise ValueError("regs must be 16-byte aligned on the card: the "
                         "propagate kernel reads rows in 16-byte words")
    if not dst_sorted(dst):
        raise ValueError("dst must be non-decreasing on the card: the "
                         "propagate kernel pulls over a dst-sorted routing "
                         "(sort it with sort_routing)")
    out = regs.clone()
    _build.launch(_build.kernel_name("hll_propagate", layout), regs.device,
                  regs.data_ptr(), out.data_ptr(), src.data_ptr(),
                  dst.data_ptr(), src.shape[0], v, r, _build.stream_of(regs))
    return out
