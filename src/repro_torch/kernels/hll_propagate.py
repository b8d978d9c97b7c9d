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
version, which takes the edges in any order. ``edge_block`` is the
kernel's run length, the dst-sorted edges a group walks
(``kernels.autotune``; ``None``: the fallback), checked against the op's
grid on every device.

:func:`hll_propagate_into` wraps the same source's two-panel launchers
(``hll_propagate_into``, ``hll_propagate_into_packed``), the port's
kernel for the JAX package's ``packing.scatter_max_rows`` (plain jnp,
no Pallas kernel), the merge step of the sharded schedules:
``out[dst[e]] max= src_panel[src[e]]`` in place, where ``src`` indexes
``src_panel`` and ``dst`` indexes ``out``, two panels of their own row
counts. The base is ``out[d]`` and ``src == dst`` is a real edge (a
ring step's block holds other vertices than the shard it merges into).
:func:`plain_into` is its plain version. The two-panel kernel cuts the
routing into runs of :func:`run_edges` edges, one run per group of
lanes; the wrapper derives the length from the edge count and the card's
SM count, so that a short routing still fills the card.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, autotune, ref

__all__ = ["RUN_EDGES_MAX", "RUN_EDGES_MIN", "dst_sorted", "hll_propagate",
           "hll_propagate_into", "plain", "plain_into", "run_edges",
           "sort_routing"]

#: the two-panel kernel's run lengths (edges a group walks): powers of two
#: in this range. Longer runs lost at every shape measured on the H100,
#: even with the grid full; shorter ones leave most segments crossing a
#: run end, merged by compare-and-swap (scripts/sweep_propagate.py).
RUN_EDGES_MIN, RUN_EDGES_MAX = 64, 256
#: runs per SM the chooser aims at: four waves of the 64 warps an SM holds
#: at once, so that every SM keeps source rows in flight to the end
RUNS_PER_SM = 256


def run_edges(n_edges: int, n_sms: int) -> int:
    """The two-panel kernel's run length for ``n_edges`` edges on a card
    of ``n_sms`` SMs: the longest power of two in ``[RUN_EDGES_MIN,
    RUN_EDGES_MAX]`` that still cuts the routing into ``RUNS_PER_SM`` runs
    per SM, or ``RUN_EDGES_MIN`` when none does."""
    run = RUN_EDGES_MAX
    while run > RUN_EDGES_MIN and run * n_sms * RUNS_PER_SM > n_edges:
        run //= 2
    return run


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
                  *, layout: str = "byte",
                  edge_block: int | None = None) -> torch.Tensor:
    """regs: uint8[V, r] (packed: uint8[V, r/2]); src/dst: int32[E] in
    [0, V), ``dst`` non-decreasing on the card -> a new panel of the same
    shape."""
    edge_block = autotune.check_block("propagate", "edge_block", edge_block)
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
                  dst.data_ptr(), src.shape[0], v, r, edge_block,
                  _build.stream_of(regs))
    return out


def plain_into(out: torch.Tensor, src_panel: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, *, layout: str = "byte") -> torch.Tensor:
    """Plain PyTorch version of the two-panel merge
    (``ref.hll_propagate_into_ref``, every edge live); returns ``out``."""
    return ref.hll_propagate_into_ref(
        out, src_panel, src, dst, torch.ones_like(src, dtype=torch.bool),
        layout=layout)


def hll_propagate_into(out: torch.Tensor, src_panel: torch.Tensor,
                       src: torch.Tensor, dst: torch.Tensor, *,
                       layout: str = "byte",
                       check_order: bool = True) -> torch.Tensor:
    """out: uint8[V_out, w] (merged in place); src_panel: uint8[V_src, w]
    of the same layout, another allocation; src int32[E] in [0, V_src),
    dst int32[E] in [0, V_out), ``dst`` non-decreasing on the card.
    Returns ``out``.

    ``check_order=False`` skips the order check (a host sync) for a
    routing whose order its maker guarantees, as the sharded plan's
    groups are built dst-sorted. An empty routing launches nothing.
    """
    on_card = _build.check_device(out, "out")
    v_out, r = _build.check_panel(out, layout)
    if _build.check_device(src_panel, "src_panel") != on_card or (
            on_card and src_panel.device != out.device):
        raise ValueError(f"src_panel is on {src_panel.device}, out on "
                         f"{out.device}")
    v_src, r_src = _build.check_panel(src_panel, layout)
    if r_src != r:
        raise ValueError(f"src_panel rows hold {r_src} registers, out rows "
                         f"{r}")
    _build.check_ids(src, "src", out)
    _build.check_ids(dst, "dst", out, src.shape[0])
    if not on_card:
        return plain_into(out, src_panel, src, dst, layout=layout)
    lo, hi = out.data_ptr(), out.data_ptr() + out.numel()
    s_lo = src_panel.data_ptr()
    if s_lo < hi and lo < s_lo + src_panel.numel():
        raise ValueError("src_panel overlaps out: the kernel reads the "
                         "source rows through the read-only cache")
    if (lo | s_lo) % 16:
        raise ValueError("out and src_panel must be 16-byte aligned on the "
                         "card: the kernel reads rows in 16-byte words")
    if check_order and not dst_sorted(dst):
        raise ValueError("dst must be non-decreasing on the card: the "
                         "kernel pulls over a dst-sorted routing (sort it "
                         "with sort_routing)")
    if src.shape[0] == 0:
        return out
    n = src.shape[0]
    _build.launch(_build.kernel_name("hll_propagate_into", layout),
                  out.device, src_panel.data_ptr(), out.data_ptr(),
                  src.data_ptr(), dst.data_ptr(), n, v_src, v_out, r,
                  run_edges(n, _sm_count(out.get_device())),
                  _build.stream_of(out))
    return out
