#!/usr/bin/env python3
"""Hash draws behind the colored count check of ``chip_smoke.py`` (5g).

The smoke's colored phase estimates ``count(x, c)`` for the 8 highest-degree
vertices of its RMAT scale-22 graph (edge factor 16, seed 0) under 3
colors drawn with ``default_rng(7).integers(0, 3, n)``, at p=8, and
compares each with the exact count of x's c-colored neighbors. This
script tells the port apart from the hash's draw for those 24 counts:

    python3 scripts/colored_draws.py hubs OUT.npz
        Builds the smoke's graph with the port's generator (numpy only,
        no card; ~10 GiB of host memory) and writes the hubs and their
        neighbor ids.

    PYTHONPATH=src python3 scripts/colored_draws.py draws OUT.npz [--seeds K]
        On the CPU, for the smoke's coloring and hash seed: each (hub,
        color)'s exact count, the port's estimate (``hll.insert`` then
        ``hll.estimate``, plain versions) and the JAX package's
        (``repro.core.hll``): registers equal byte for byte, estimates
        to 1e-6. Then the relative errors
        of the 24 counts under hash seeds 1..K (``HLLConfig.seed``) and
        under colorings 1..K (``default_rng(7 + k)``), in units of
        ``rel_std(8)``, with the largest |z| of each draw.

The JAX package is imported by ``draws`` only, for its witness.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

SCALE, EDGE_FACTOR, SEED, P = 22, 16, 0, 8
COLORS, HUBS, COLOR_SEED = 3, 8, SEED + 7


def hubs(out: str) -> None:
    """Write the smoke's hubs and their neighbor ids to ``out``."""
    from repro_torch.graph import generators
    edges = generators.rmat(SCALE, EDGE_FACTOR, seed=SEED)
    n = 1 << SCALE
    deg = np.bincount(edges.ravel(), minlength=n)
    top = np.argsort(-deg)[:HUBS]
    near = edges[np.isin(edges[:, 0], top) | np.isin(edges[:, 1], top)]
    nbrs = [np.concatenate([near[near[:, 0] == x, 1],
                            near[near[:, 1] == x, 0]]) for x in top]
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, n=n, hubs=top, offsets=np.cumsum([0] + [len(a)
                                                          for a in nbrs]),
             nbrs=np.concatenate(nbrs).astype(np.int32))
    print(f"{len(edges)} edges; hubs {top.tolist()} with degrees "
          f"{deg[top].tolist()} -> {out}")


def _classes(data, color_seed: int):
    """[(hub, color, neighbor ids of that color)] for one coloring."""
    colors = np.random.default_rng(color_seed).integers(0, COLORS,
                                                        int(data["n"]))
    off, nbrs = data["offsets"], data["nbrs"]
    out = []
    for i, x in enumerate(data["hubs"]):
        own = nbrs[off[i]:off[i + 1]]
        for c in range(COLORS):
            out.append((int(x), c, own[colors[own] == c]))
    return out


def _port(keys, seed: int) -> tuple[np.ndarray, float]:
    """The port's registers and estimate of ``keys`` (CPU)."""
    from repro_torch.core import hll
    cfg = hll.HLLConfig(p=P, seed=seed)
    regs = hll.insert(hll.empty(cfg, device="cpu"), keys, cfg)
    return regs.numpy(), float(hll.estimate(regs, cfg))


def _jax(keys, seed: int) -> tuple[np.ndarray, float]:
    """The JAX package's registers and estimate of ``keys``."""
    import jax.numpy as jnp
    from repro.core import hll as jhll
    cfg = jhll.HLLConfig(p=P, seed=seed)
    regs = jhll.insert(jhll.empty(cfg), jnp.asarray(keys, jnp.uint32), cfg)
    return np.asarray(regs), float(jhll.estimate(regs, cfg))


def _both(keys, seed: int) -> tuple[float, float]:
    """The port's and the JAX package's estimates of ``keys``, after their
    registers are checked equal byte for byte and the estimates to 1e-6
    (the two sum float32 terms in different orders)."""
    (ra, got), (rb, want) = _port(keys, seed), _jax(keys, seed)
    if not np.array_equal(ra, rb) or abs(got - want) > 1e-6 * want:
        raise SystemExit(f"port {got!r} != jax {want!r} (seed {seed}, "
                         f"{len(keys)} keys)")
    return got, want


def _z(classes, seed: int) -> np.ndarray:
    from repro_torch.core.hll import rel_std
    return np.array([(_port(own, seed)[1] - len(own))
                     / (len(own) * rel_std(P)) for _, _, own in classes])


def draws(path: str, k: int) -> None:
    """Print the smoke's 24 counts (port and JAX) and the draws."""
    from repro_torch.core.hll import rel_std
    data = np.load(path)
    classes = _classes(data, COLOR_SEED)
    print(f"p={P}: rel_std {rel_std(P):.5f}, smoke bound 4 x rel_std = "
          f"{4 * rel_std(P):.5f}")
    print("hub       color  exact   port estimate  jax estimate  rel err"
          "   z")
    worst = (0.0, None)
    for x, c, own in classes:
        got, want = _both(own, SEED)
        err = (got - len(own)) / len(own)
        z = err / rel_std(P)
        print(f"{x:<9d} {c:5d} {len(own):6d} {got:14.4f} {want:13.4f} "
              f"{err:+.5f} {z:+.2f}")
        if abs(z) > abs(worst[0]):
            worst = (z, (x, c, own))
    z, (x, c, own) = worst
    print(f"largest |z| {z:+.2f} at hub {x} color {c}; that class under "
          f"hash seeds 1..{k}, port and JAX:")
    row = []
    for s in range(1, k + 1):
        got, _ = _both(own, s)
        row.append((got - len(own)) / (len(own) * rel_std(P)))
    print("  z: " + " ".join(f"{v:+.2f}" for v in row))
    for label, runs in (
            ("hash seed", [(s, _z(classes, s)) for s in range(1, k + 1)]),
            ("coloring", [(s, _z(_classes(data, COLOR_SEED + s), SEED))
                          for s in range(1, k + 1)])):
        zs = np.stack([v for _, v in runs])
        print(f"24 counts under {label}s 1..{k}: max |z| per draw "
              + " ".join(f"{np.abs(v).max():.2f}" for _, v in runs))
        print(f"  all {zs.size} z: mean {zs.mean():+.3f}, std "
              f"{zs.std():.3f}, |z| > 4 in {(np.abs(zs) > 4).sum()}, "
              f"|z| > 3 in {(np.abs(zs) > 3).sum()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("hubs").add_argument("out")
    d = sub.add_parser("draws")
    d.add_argument("path")
    d.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()
    if args.cmd == "hubs":
        hubs(args.out)
    else:
        draws(args.path, args.seeds)


if __name__ == "__main__":
    main()
