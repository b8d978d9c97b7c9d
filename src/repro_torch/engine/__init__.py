"""Public sketch query API: open / build / load a ``LocalEngine`` on the card.

    from repro_torch import engine
    from repro_torch.core.ads import ADSConfig
    from repro_torch.core.hll import HLLConfig

    eng = engine.build(edges, n, HLLConfig(p=8))   # on the card
    deg = eng.degrees()
    loc, glob = eng.neighborhood(t_max=3)
    u = eng.union_size([ids_a, ids_b])              # batched |∪ N(x)|
    t = eng.intersection_size(edge_pairs)          # batched T̃(xy)
    out = eng.query_batch(degrees=True, vertex_sets=sets, pairs=edge_pairs)
    total, vals, top = eng.triangle_heavy_hitters(100, mode="edge")

    ads = engine.build(edges, n, ADSConfig(p=8), family="ads")
    hist, glob = ads.distance_histogram(6)         # HIP distance queries
    close = ads.closeness(6)
    eff = ads.effective_diameter(6, q=0.9)

    eng.merge(other)                               # register max
    eng.save(path)                                 # JAX package's format
    back = engine.load(path)

    snap = eng.snapshot()                          # read-only, O(1)
    eng.ingest(block)                              # snap keeps its answers
    eng.replicate(hot_ids)                         # hot-vertex replica set

    small = engine.build(edges, n, HLLConfig(p=8), layout="packed")
    small.save(path)                               # half the register bytes
    as_byte = engine.load(path, layout="byte")     # exact unpack

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, which runs every kernel's plain PyTorch version); with
``device=None`` and no card they raise ``RuntimeError`` rather than
carry on on the CPU. Both register layouts are ported: "byte" (one
register a byte) and, for HLL, "packed" (two 4-bit registers a byte,
half the device bytes; registers saturate at 15, ``kernels.packing``).
Only the local backend is ported so far (the sharded backend is not;
see ROADMAP.md); ``repro_torch.serve`` serves an engine to concurrent
clients. ``engine.convert`` carries a JAX engine's state across as numpy
arrays, and checkpoints cross between the packages as files, in either
layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.base import (ENGINE_FORMAT, SketchEngine,
                                     resolve_device)
from repro_torch.engine.local import LocalEngine
from repro_torch.kernels import packing, registry

__all__ = ["SketchEngine", "LocalEngine", "open", "build", "load",
           "default_device"]


def default_device() -> torch.device:
    """The device entry points use when the caller passes none: the card.

    Raises ``RuntimeError`` when ``torch.cuda.is_available()`` is False.
    """
    return resolve_device(None)


def _resolve_cfg(cfg, family: str | None):
    """The config to build with, from what the caller passed.

    The config's type is authoritative: it picks its family, and a
    ``family`` that disagrees raises ``TypeError``. Without a config,
    ``family`` (default "hll") picks its family's default config.
    """
    if cfg is None:
        return registry.family(family or "hll").default_config()
    fam = registry.family_of(cfg)
    if family is not None and family != fam.name:
        want = registry.family(family).config_cls.__name__
        raise TypeError(
            f"config {type(cfg).__name__} does not belong to sketch family "
            f"{family!r} (expects {want})")
    return cfg


def open(n: int, cfg=None, *, layout: str = "byte", family: str | None = None,
         device=None) -> LocalEngine:
    """An empty engine over vertex universe [0, n), ready to ingest.

    Args:
      n: vertex count; ingesting ids >= n raises ``ValueError``.
      cfg: sketch config; its type selects the family (``HLLConfig`` or
        ``ADSConfig``). Default: the family's default config.
      layout: register layout, "byte" (one register a byte) or "packed"
        (two 4-bit registers a byte, saturating at 15; HLL only, an ADS
        config raises ``ValueError``).
      family: "hll" or "ads", used when no ``cfg`` names one (default
        "hll"); a ``cfg`` of another family raises ``TypeError``.
      device: "cuda", "cpu" or a torch device; ``None`` means the card.
    """
    return LocalEngine.open(n, _resolve_cfg(cfg, family), layout=layout,
                            device=device)


def build(edges: np.ndarray, n: int | None = None, cfg=None, *,
          layout: str = "byte", family: str | None = None,
          device=None) -> LocalEngine:
    """Accumulate a sketch table (Algorithm 1) and return a query engine.

    ``open(n, cfg)`` plus one ``ingest(edges)``, so the registers are
    byte-identical to any block-streamed ingestion of the same edges.
    ``n`` defaults to ``edges.max() + 1``; the other arguments are
    :func:`open`'s.
    """
    edges = np.asarray(edges)
    if n is None:
        n = int(edges.max()) + 1 if len(edges) else 1
    return open(n, cfg, layout=layout, family=family,
                device=device).ingest(edges)


def load(path: str, *, step: int | None = None, layout: str | None = None,
         family: str | None = None, device=None) -> LocalEngine:
    """Restore a saved engine onto the local backend; queries answer as
    before the save, and ingestion resumes where it stopped.

    Reads checkpoints of this package and of the JAX package, whichever
    backend saved them: the register rows are canonical, so a sharded
    save loads onto one device. The manifest's ``impl`` and ``shards``
    say how the JAX package ran and are not needed here. A saved
    ``replica_ids`` leaf is installed through ``replicate`` and written
    back by the next ``save``.

    Args:
      path: the checkpoint directory (holding ``step_<k>``).
      step: the step to load; default the latest.
      layout: the register layout of the restored engine; default the
        saved one. On a mismatch the rows convert through
        ``kernels.packing.to_layout``: byte -> packed saturates registers
        above 15 (merge-exact), packed -> byte is exact.
      family: an assertion, not an override: a manifest of another family
        raises :class:`~repro_torch.ckpt.checkpoint.FamilyMismatch`
        naming both.
      device: as in :func:`open`; ``None`` means the card.

    Raises ``ValueError`` for a file that is no engine checkpoint, and
    for ``layout="packed"`` on an ADS checkpoint.
    """
    from repro_torch.ckpt.checkpoint import (latest_step, manifest_family,
                                             read_manifest, require_family,
                                             restore_checkpoint)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {path!r}")
    extra = read_manifest(path, step).get("extra") or {}
    if extra.get("format") != ENGINE_FORMAT:
        raise ValueError(
            f"{path!r} step {step} is not a sketch-engine checkpoint "
            f"(format={extra.get('format')!r})")
    fam_name = (require_family(extra, family, "load") if family is not None
                else manifest_family(extra))
    saved = packing.validate_layout(extra.get("layout", "byte"))
    layout = packing.validate_layout(layout or saved)
    tree = restore_checkpoint(path, step)
    cfg = registry.family(fam_name).config_from_dict(extra["cfg"])
    registry.resolve(cfg, layout)  # ADS on packed raises before any copy
    edges = (np.asarray(tree["edges"], dtype=np.int32).reshape(-1, 2)
             if "edges" in tree else None)
    regs = packing.to_layout(torch.from_numpy(
        np.asarray(tree["regs"], dtype=np.uint8)), saved, layout)
    eng = LocalEngine.from_regs(regs, int(extra["n"]), cfg, edges=edges,
                                layout=layout, device=device)
    if "replica_ids" in tree:
        eng.replicate(np.asarray(tree["replica_ids"], dtype=np.int64))
    return eng
