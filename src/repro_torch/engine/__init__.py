"""Public sketch query API: open / build / load a ``SketchEngine`` on the card.

    from repro_torch import engine

    eng = engine.build(edges, n)                   # hll, on the card
    deg = eng.degrees()
    loc, glob = eng.neighborhood(t_max=3)
    u = eng.union_size([ids_a, ids_b])              # batched |∪ N(x)|
    t = eng.intersection_size(edge_pairs)          # batched T̃(xy)
    out = eng.query_batch(degrees=True, vertex_sets=sets, pairs=edge_pairs)
    total, vals, top = eng.triangle_heavy_hitters(100, mode="edge")

    ads = engine.build(edges, n, family="ads")     # All-Distances Sketches
    hist, glob = ads.distance_histogram(6)         # HIP distance queries
    close = ads.closeness(6)
    eff = ads.effective_diameter(6, q=0.9)

    eng.merge(other)                               # register max
    eng.save(path)                                 # JAX package's format
    back = engine.load(path)

    snap = eng.snapshot()                          # read-only, O(1)
    eng.ingest(block)                              # snap keeps its answers
    eng.replicate(hot_ids)                         # hot-vertex replica set

    small = engine.build(edges, n, layout="packed")
    small.save(path)                               # half the register bytes
    as_byte = engine.load(path, layout="byte")     # exact unpack

    plain = engine.build(edges, n, impl="ref")    # no kernels

    big = engine.build(edges, n, backend="sharded", shards=4)  # 4 panels
    loc, glob = big.neighborhood(3, schedule="allgather")
    big.save(path)
    two = engine.load(path, shards=2)              # elastic reshard

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, which runs every kernel's plain PyTorch version); with
``device=None`` and no card they raise ``RuntimeError`` rather than
carry on on the CPU. Both register layouts are ported: "byte" (one
register a byte) and, for HLL, "packed" (two 4-bit registers a byte,
half the device bytes; registers saturate at 15, ``kernels.packing``).
Both backends are ported: ``backend="local"`` holds the panel as one
tensor on one device; ``backend="sharded"`` (``engine.sharded``) as
``shards`` blocks of rows, one tensor each, shard ``s`` on card ``s mod
device_count`` (one controller, as the JAX engine is one object over a
mesh), with the ring, double-buffered ring and all-gather propagate
schedules and a distributed triangle top-k. ``shards`` defaults to one
per visible card on the card and to one on the CPU. ``repro_torch.serve``
serves an engine of either backend to concurrent clients.
``engine.convert`` carries a JAX engine's state across as numpy arrays,
and checkpoints cross between the packages as files, in either layout
and from either backend; ``load(path, shards=S2)`` re-partitions the
saved rows with no edge replay.

``impl`` selects the kernel implementation (``kernels.registry``):
"cuda", the default, launches the CUDA kernels on the card (and runs
their plain versions on the CPU); "ref" runs the plain PyTorch versions
on whichever device and launches nothing. When the caller passes none,
``impl``, ``layout`` and ``family`` come from the ``REPRO_TORCH_IMPL``,
``REPRO_TORCH_LAYOUT`` and ``REPRO_TORCH_FAMILY`` environment variables,
read on each call (:func:`default_impl`, :func:`default_layout`,
:func:`default_family`). The port never reads the JAX package's
``REPRO_IMPL``, ``REPRO_LAYOUT`` and ``REPRO_FAMILY``: their values name
that package's kernels ("pallas") and its test legs, so a shell set up
for the JAX package leaves the port on its kernels. The JAX package's
default impl is "ref" because its Pallas kernels run in interpret mode
off a TPU; the port's is "cuda".
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.engine.base import (ENGINE_FORMAT, SketchEngine,
                                     UnsupportedQuery, resolve_device)
from repro_torch.engine.local import LocalEngine
from repro_torch.engine.sharded import ShardedEngine
from repro_torch.kernels import packing, registry

__all__ = ["SketchEngine", "LocalEngine", "ShardedEngine",
           "UnsupportedQuery", "open", "build", "load", "default_device",
           "default_impl", "default_layout", "default_family"]

_BACKENDS = ("local", "sharded")


def _validate_backend(backend: str, shards) -> None:
    """The JAX package's checks, before any allocation: a known backend,
    and ``shards`` only with the sharded one."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {sorted(_BACKENDS)}, "
                         f"got {backend!r}")
    if backend != "sharded" and shards is not None:
        raise ValueError("shards= only applies to backend='sharded'")


def default_device() -> torch.device:
    """The device entry points use when the caller passes none: the card.

    Raises ``RuntimeError`` when ``torch.cuda.is_available()`` is False.
    """
    return resolve_device(None)


def default_impl() -> str:
    """Kernel implementation used when callers pass no ``impl=``: the
    ``REPRO_TORCH_IMPL`` environment variable, read on each call, or
    "cuda"."""
    return os.environ.get("REPRO_TORCH_IMPL", "cuda")


def default_layout() -> str:
    """Register layout used when callers pass no ``layout=``: the
    ``REPRO_TORCH_LAYOUT`` environment variable, read on each call, or
    "byte". ``load`` takes the saved layout instead."""
    return os.environ.get("REPRO_TORCH_LAYOUT", "byte")


def default_family() -> str:
    """Sketch family used when callers pass neither ``family=`` nor a
    config: the ``REPRO_TORCH_FAMILY`` environment variable, read on each
    call, or "hll". ``load`` takes the saved family instead."""
    return os.environ.get("REPRO_TORCH_FAMILY", "hll")


def _resolve_cfg(cfg, family: str | None):
    """The config to build with, from what the caller passed.

    The config's type is authoritative: it picks its family, and a
    ``family`` that disagrees raises ``TypeError``. Without a config,
    ``family`` (default :func:`default_family`) picks its family's
    default config.
    """
    if cfg is None:
        return registry.family(family or default_family()).default_config()
    fam = registry.family_of(cfg)
    if family is not None and family != fam.name:
        want = registry.family(family).config_cls.__name__
        raise TypeError(
            f"config {type(cfg).__name__} does not belong to sketch family "
            f"{family!r} (expects {want})")
    return cfg


def open(n: int, cfg=None, *, layout: str | None = None,
         family: str | None = None, impl: str | None = None,
         device=None, backend: str = "local",
         shards: int | None = None) -> SketchEngine:
    """An empty engine over vertex universe [0, n), ready to ingest.

    Args:
      n: vertex count; ingesting ids >= n raises ``ValueError``.
      cfg: sketch config; its type selects the family
        (``registry.family_of``). Default: the family's default config.
      layout: register layout, "byte" (one register a byte) or "packed"
        (two 4-bit registers a byte, saturating at 15; HLL only, an ADS
        config raises ``ValueError``); default :func:`default_layout`.
      family: "hll" or "ads", used when no ``cfg`` names one (default
        :func:`default_family`); a ``cfg`` of another family raises
        ``TypeError``.
      impl: kernel implementation, "cuda" or "ref" (default
        :func:`default_impl`); any other name raises ``ValueError``
        before any allocation.
      device: "cuda", "cpu" or a torch device; ``None`` means the card.
      backend: "local" (one panel on one device) or "sharded" (``shards``
        row blocks, the vertex partition fixed now from ``(n, shards)``).
      shards: shard count of the sharded backend; default one per visible
        card on the card, one on the CPU. Passing it with another backend
        raises ``ValueError``.
    """
    _validate_backend(backend, shards)
    cfg = _resolve_cfg(cfg, family)
    kw = dict(layout=layout or default_layout(), impl=impl or default_impl(),
              device=device)
    if backend == "sharded":
        return ShardedEngine.open(n, cfg, shards=shards, **kw)
    return LocalEngine.open(n, cfg, **kw)


def build(edges: np.ndarray, n: int | None = None, cfg=None, *,
          layout: str | None = None, family: str | None = None,
          impl: str | None = None, device=None, backend: str = "local",
          shards: int | None = None) -> SketchEngine:
    """Accumulate a sketch table (Algorithm 1) and return a query engine.

    ``open(n, cfg)`` plus one ``ingest(edges)``, so the registers are
    byte-identical to any block-streamed ingestion of the same edges.
    ``n`` defaults to ``edges.max() + 1``; the other arguments are
    :func:`open`'s.
    """
    edges = np.asarray(edges)
    if n is None:
        n = int(edges.max()) + 1 if len(edges) else 1
    return open(n, cfg, layout=layout, family=family, impl=impl,
                device=device, backend=backend,
                shards=shards).ingest(edges)


def load(path: str, *, step: int | None = None, layout: str | None = None,
         family: str | None = None, impl: str | None = None,
         device=None, backend: str | None = None,
         shards: int | None = None) -> SketchEngine:
    """Restore a saved engine; queries answer as before the save, and
    ingestion resumes where it stopped.

    Reads checkpoints of this package and of the JAX package, whichever
    backend saved them. ``backend`` and ``shards`` default to the saved
    ones (a manifest without ``backend`` is local) and may be overridden:
    the register rows are canonical, so a local save loads sharded and a
    sharded one loads at any shard count or onto one device. Elastic
    reshard: ``shards=S2`` re-partitions the saved rows
    (``ShardedEngine.from_regs``) with no edge replay, and the routing
    plan is rebuilt from the saved edges when a query needs it. The
    manifest's ``impl`` (the JAX package's "ref" or "pallas") says how
    the JAX package ran and is ignored here: the engine takes ``impl``,
    or :func:`default_impl`. A saved ``replica_ids`` leaf is reinstalled
    through ``replicate`` (the id set is the durable decision; the rows
    come from the restored panel) and written back by the next ``save``.

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
      impl: as in :func:`open`.
      device: as in :func:`open`; ``None`` means the card.
      backend / shards: as in :func:`open`; default the saved ones.

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
    cfg = registry.family(fam_name).config_from_dict(extra["cfg"])
    impl = impl or default_impl()
    registry.resolve(cfg, layout, impl)  # fails before any file is read
    backend = backend or extra.get("backend", "local")
    _validate_backend(backend, shards)
    if backend == "sharded" and shards is None:
        shards = extra.get("shards")
    tree = restore_checkpoint(path, step)
    edges = (np.asarray(tree["edges"], dtype=np.int32).reshape(-1, 2)
             if "edges" in tree else None)
    regs = packing.to_layout(torch.from_numpy(
        np.asarray(tree["regs"], dtype=np.uint8)), saved, layout)
    kw = dict(edges=edges, layout=layout, impl=impl, device=device)
    if backend == "sharded":
        eng = ShardedEngine.from_regs(regs, int(extra["n"]), cfg,
                                      shards=shards, **kw)
    else:
        eng = LocalEngine.from_regs(regs, int(extra["n"]), cfg, **kw)
    if "replica_ids" in tree:
        eng.replicate(np.asarray(tree["replica_ids"], dtype=np.int64))
    return eng
