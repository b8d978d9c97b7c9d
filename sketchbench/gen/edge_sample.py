"""Argument: ``count`` edges of the graph drawn uniformly with
replacement, int32[count, 2].

Draws are made on the device in blocks of ``BLOCK`` steps, each block from
a generator seeded by the run's seed and the block's index, so step i's
argument depends on the seed and i alone. The loop's set-up reserves the
blocks of every step the window is expected to run (``reserve``), so no
step of the window pays for a draw; a step beyond them draws its block
when it comes."""
from __future__ import annotations

#: steps drawn together
BLOCK = 16


def _draw(spec: dict, ctx, blocks: range) -> None:
    torch, kind = ctx.device.torch, ctx.device.kind
    count = int(spec["count"])
    pool = ctx.cache.setdefault(("edge_sample", count), {})
    todo = [b for b in blocks if b not in pool]
    if not todo:
        return
    edges = torch.from_numpy(ctx.edges).to(kind)
    gen = torch.Generator(device=kind)
    for b in todo:
        gen.manual_seed(((ctx.seed << 20) + b) % (1 << 64))
        idx = torch.randint(0, len(ctx.edges), (BLOCK, count), generator=gen,
                            device=kind)
        pool[b] = edges[idx].cpu().numpy()
    del edges, idx


def reserve(spec: dict, ctx, steps: int) -> None:
    """Draw the arguments of steps 0 .. steps - 1 now."""
    _draw(spec, ctx, range(-(-steps // BLOCK)))


def make(spec: dict, ctx, step: int):
    _draw(spec, ctx, range(step // BLOCK, step // BLOCK + 1))
    return ctx.cache[("edge_sample", int(spec["count"]))][step // BLOCK][
        step % BLOCK]
