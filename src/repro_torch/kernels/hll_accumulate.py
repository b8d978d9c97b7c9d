"""Fused hash + HLL scatter-max accumulation (Algorithm 1 INSERT).

Wrapper of ``csrc/hll_accumulate.cu``, the port of the Pallas kernel
``repro.kernels.hll_accumulate.hll_accumulate``: for every edge e with
``mask[e]``, ``regs[rows[e], bucket(keys[e])] max= rho(keys[e])``, with the
hash computed inside the kernel. ``mask=None`` means every edge is live
(the engine's ingest: no padding, and the kernel reads no mask byte). The
panel is updated in place, as the JAX ingest path donates it
(``accumulate_donated``), and returned. On the packed layout
(``uint8[V, r/2]``) the register is one nibble and takes
``min(rho, 15)``; the launcher is ``hll_accumulate_packed``. The kernel
takes any edge count in one launch. ``edge_block`` is its launch shape,
the edges a warp's tile holds (``kernels.autotune``; ``None``: the
fallback), checked against the op's grid on every device.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`plain`, the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import bucket_rho, seed_words
from repro_torch.kernels import _build, autotune, ref

__all__ = ["hll_accumulate", "plain"]


def _check(regs, rows, keys, mask, p, layout) -> bool:
    on_card = _build.check_device(regs, "regs")
    _, r = _build.check_panel(regs, layout)
    if not (1 <= p <= 31) or r != 1 << p:
        raise ValueError(f"p={p} does not match the panel width r={r}")
    e = rows.shape[0]
    _build.check_ids(rows, "rows", regs)
    _build.check_ids(keys, "keys", regs, e, dtype=torch.uint32)
    if mask is not None:
        _build.check_ids(mask, "mask", regs, e, dtype=torch.bool)
    return on_card


def plain(regs: torch.Tensor, rows: torch.Tensor, keys: torch.Tensor,
          mask: torch.Tensor | None = None, *, p: int, seed: int = 0,
          layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version: hash, park masked edges, scatter-max.

    Masked edges get rho=0 and park on row 0 (max with 0 is a no-op), the
    convention of ``repro/kernels/ops.py:77-87``; ``mask=None`` parks
    none. Hashes one chunk of edges at a time. Updates ``regs`` in place
    and returns it.
    """
    for s in range(0, rows.shape[0], ref.EDGE_CHUNK):
        buckets, rhos = bucket_rho(keys[s:s + ref.EDGE_CHUNK], p, seed)
        rows_c = rows[s:s + ref.EDGE_CHUNK]
        if mask is not None:
            m = mask[s:s + ref.EDGE_CHUNK]
            rhos = torch.where(m, rhos, torch.zeros_like(rhos))
            rows_c = torch.where(m, rows_c, torch.zeros_like(rows_c))
        ref.hll_accumulate_ref(regs, rows_c, buckets, rhos, layout=layout)
    return regs


def hll_accumulate(regs: torch.Tensor, rows: torch.Tensor, keys: torch.Tensor,
                   mask: torch.Tensor | None = None, *, p: int, seed: int = 0,
                   layout: str = "byte",
                   edge_block: int | None = None) -> torch.Tensor:
    """regs: uint8[V, r] (packed: uint8[V, r/2]), updated in place; rows:
    int32[E]; keys: uint32[E]; mask: bool[E], or ``None`` when every edge
    is live. Returns ``regs``.

    Row ids must lie in [0, V); the engine validates them on the host
    before they reach the card (the kernel drops an out-of-range row
    rather than write outside the panel).
    """
    edge_block = autotune.check_block("accumulate", "edge_block", edge_block)
    if not _check(regs, rows, keys, mask, p, layout):
        return plain(regs, rows, keys, mask, p=p, seed=seed, layout=layout)
    s_hi, s_lo = seed_words(seed)
    _build.launch(_build.kernel_name("hll_accumulate", layout), regs.device,
                  regs.data_ptr(), rows.data_ptr(), keys.data_ptr(),
                  None if mask is None else mask.data_ptr(), rows.shape[0],
                  regs.shape[0], p, s_hi, s_lo, edge_block,
                  _build.stream_of(regs))
    return regs
