"""Argument: ``count`` edges of the graph drawn uniformly with
replacement, int32[count, 2], from a pool of ``pool`` requests.

The run has ``pool`` requests and step i sends request ``i mod pool``.
Draws are made on the device in blocks of ``BLOCK`` requests, each block
from a generator seeded by the run's seed and the block's index, so
request j's argument depends on the seed and j alone. Set-up draws the
pool's ``ceil(pool / BLOCK)`` blocks (``reserve``), so neither set-up
work nor host memory follows the program's rate, and no step of the
window draws."""
from __future__ import annotations

#: requests drawn together
BLOCK = 16


def _draw(spec: dict, ctx, blocks: range) -> None:
    torch, kind = ctx.device.torch, ctx.device.kind
    count = int(spec["count"])
    drawn = ctx.cache.setdefault(("edge_sample", count), {})
    todo = [b for b in blocks if b not in drawn]
    if not todo:
        return
    edges = torch.from_numpy(ctx.edges).to(kind)
    gen = torch.Generator(device=kind)
    for b in todo:
        gen.manual_seed(((ctx.seed << 20) + b) % (1 << 64))
        idx = torch.randint(0, len(ctx.edges), (BLOCK, count), generator=gen,
                            device=kind)
        drawn[b] = edges[idx].cpu().numpy()
    del edges, idx


def reserve(spec: dict, ctx) -> None:
    """Draw the whole pool now."""
    _draw(spec, ctx, range(-(-int(spec["pool"]) // BLOCK)))


def make(spec: dict, ctx, step: int):
    j = step % int(spec["pool"])
    _draw(spec, ctx, range(j // BLOCK, j // BLOCK + 1))
    return ctx.cache[("edge_sample", int(spec["count"]))][j // BLOCK][
        j % BLOCK]
