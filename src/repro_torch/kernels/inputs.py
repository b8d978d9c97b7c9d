"""Kernel inputs on the device: where they live, and edge lists turned
into the accumulate and propagate kernels' operands.

Below both ``core`` and ``engine``: the functional API, the colored
sketches and the engines build their operands here, the same way, so
their registers agree bit for bit.

* :func:`resolve_device`: the device an entry point runs on (the card
  unless the caller asks for the CPU; never the CPU by itself);
* :func:`pad_vertices`: the row count of a register table;
* :data:`INGEST_BLOCK`: undirected edges per accumulate launch;
* :func:`directed_block`: an undirected chunk as accumulate rows/keys;
* :func:`directed_routing`: an undirected edge list as a dst-sorted
  propagate routing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.hll_propagate import sort_routing
from repro_torch.tracing import span

__all__ = ["resolve_device", "pad_vertices", "INGEST_BLOCK",
           "directed_block", "directed_routing", "ROUTING_SLICE"]

#: undirected edges per accumulate launch; larger blocks are split. The
#: JAX package's 2^15 serves XLA's static shape buckets; the CUDA kernel
#: takes any length, so a chunk here is as large as host and device
#: memory allow cheaply (32 MB of host ids, 64 MB of directed ids on the
#: device) and a 64M-edge build takes 16 launches
INGEST_BLOCK = 1 << 22


def resolve_device(device=None) -> torch.device:
    """The engine device: ``None`` means the card, which must be present.

    Entry points never carry on on the CPU by themselves: asking for (or
    defaulting to) ``cuda`` without a card raises ``RuntimeError``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


def pad_vertices(n: int, multiple: int) -> int:
    """Round ``n`` up to the next multiple (register-table row padding)."""
    return ((n + multiple - 1) // multiple) * multiple


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array ``a`` on ``device``, copied first when it is read-only
    (a tensor may not alias read-only memory)."""
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)


def _orientations(e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the edge list ``e`` int32[k, 2]: (the first
    column then the second, the second column then the first)."""
    return torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]])


def directed_block(chunk: np.ndarray, device: torch.device,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the undirected ``chunk`` int32[k, 2] as
    accumulate inputs on ``device``: rows int32[2k] (the first column,
    then the second) and keys uint32[2k] (the other endpoint,
    reinterpreted). The chunk crosses to the device once."""
    rows, keys = _orientations(_to_device(chunk, device))
    return rows, keys.view(torch.uint32)


#: directed edges per slice of the routing build: the sort's temporaries
#: are those of one slice, not of the whole routing
ROUTING_SLICE = 1 << 23


def directed_routing(edges: np.ndarray, device: torch.device,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both orientations of the undirected ``edges`` int32[m, 2] as a
    propagate routing ``(src, dst)`` int32[2m] on ``device``, stably
    sorted by ``dst``: equal to ``sort_routing`` of ``(first column then
    second, second then first)``. The edge list crosses to the device
    once. The routing is built there in slices of consecutive
    destinations, each about ``ROUTING_SLICE`` directed edges (a vertex's
    in-edges never split), so the device holds the edge list, the result
    and one slice's temporaries at a time."""
    with span("routing.build"):
        with span("routing.h2d"):
            e = _to_device(edges, device)
        n_dir = 2 * e.shape[0]
        src = torch.empty(n_dir, dtype=torch.int32, device=device)
        dst = torch.empty_like(src)
        if n_dir == 0:
            return src, dst
        # cum[v]: directed edges whose dst is <= v (in-degree = degree)
        cum = torch.bincount(e.reshape(-1)).cumsum(0)
        n_slices = -(-n_dir // ROUTING_SLICE)
        cuts = torch.searchsorted(
            cum, torch.arange(1, n_slices, device=device) * ROUTING_SLICE)
        bounds = [0, *(cuts + 1).tolist(), cum.numel()]
        at = 0
        for lo, hi in zip(bounds, bounds[1:]):
            if lo >= hi:
                continue
            with span("routing.slice"):
                part = e[((e >= lo) & (e < hi)).any(1)]
                s, d = _orientations(part)
                keep = (d >= lo) & (d < hi)
                s, d = sort_routing(s[keep], d[keep])
                src[at:at + d.numel()] = s
                dst[at:at + d.numel()] = d
                at += d.numel()
        return src, dst
