"""Deterministic autotune table of the CUDA kernels' launch shapes (port of
``repro.kernels.autotune``).

Every op of ``kernels.ops`` takes one block argument, named as in the JAX
package. On the card it is a launch shape of the hand-written kernel,
passed to its C launcher at run time:

=================== ============ ==================================== =====
op                  argument     launch shape                         grid
=================== ============ ==================================== =====
accumulate          edge_block   edges a warp's tile holds            64-512
propagate           edge_block   dst-sorted edges a group walks       256-2048
estimate            row_block    threads a block                      128-512
union_estimate      set_block    sets a block (one warp each)         4-16
intersection_stats  pair_block   most pairs a warp takes at once      1-8
ertl_stats          pair_block   pairs a block (one warp each)        4-32
hip_delta           row_block    threads a block                      128-512
=================== ============ ==================================== =====

:data:`FALLBACK` holds the constants the kernels shipped with, so a
process that never sweeps launches exactly those shapes; :data:`SWEEPS`
holds the candidates around each, the fallback among them. The values
differ from the JAX package's, whose blocks are Pallas grid tiles. The
two-panel merge (``propagate_into``) is not tuned: its run length
follows from the edge count and the SM count
(``hll_propagate.run_edges``), and the JAX table has no such op.

The right shape depends on the card, the precision ``p`` (the row
width), the layout and the size of the call: the same kernel prefers
another block at 2^20 rows than at 2^22. So :func:`sweep` times each
candidate of one op on the card, on the inputs the caller will run
(``inputs=``, in ``ops.<op>``'s order) or on the default shapes below,
and caches the winner under ``(device_kind, p, op, impl, layout,
size_class)``, where the size class is ``ceil(log2)`` of the call's work
count (:data:`WORK_ARG`: edges, rows, sets or pairs). A winner applies
only to calls of its own size class; every other call keeps the
fallback. A candidate wins only when it beats the fallback's time by
more than :data:`WIN_MARGIN`: shapes that time alike keep the fallback
instead of trading places from one sweep to the next. Determinism rules
(``tests/test_torch_autotune.py``):

* **Off the card nothing is timed.** Without a CUDA device, or for
  ``impl="ref"`` (whose plain versions ignore the shape), :func:`sweep`
  installs the :data:`FALLBACK` entry and :func:`drive_count` stays 0.
* **Cache wins are stable.** A second :func:`sweep` of the same key
  returns the cached winner and drives nothing.
* **Unknown entries degrade, never raise.** :func:`tuned_params` of an op
  in neither table returns ``{}``, :func:`resolve_block` ``None``.

Resolution order for a block argument: an explicit value, then the
cached winner of the call's size class over the fallback, then the
fallback (:func:`resolve_block`). Each kernel wrapper checks the value it
gets against its op's grid on every device (:func:`check_block`), so an
off-grid value fails on the CPU as on the card.

What is timed is the kernel's wrapper alone (the statistics' estimate,
the pair columns' copies and the like are prepared or left out), the
candidates in turn within each of :data:`SWEEP_REPS` rounds after a
warm-up round, each call after a write of twice the card's L2 and at
least :data:`FLUSH_BYTES` (no input is left in L2, and the host's launch
work is hidden behind it), the median of each candidate's CUDA-event
times kept. The default shapes,
at which the kernel rather than the launch sets the time, every panel
larger than the H100's 50 MB L2: a 2^20-row panel at the swept ``p``;
2^23 edges for accumulate (the engine's launch of 2 x ``INGEST_BLOCK``)
and for propagate (random, no self-edge, sorted by ``dst``); 2^18 pairs
for the pair kernels (the triangle queries' block); 4,096 sets of up to
64 lanes (the main path's union panel); two 2^20-row hop panels for
``hip_delta``. Their registers are seeded random values below 16 (any
nibble packed).
"""
from __future__ import annotations

import statistics
import threading

import torch

__all__ = ["FALLBACK", "SWEEPS", "device_kind", "cache_key", "tuned_params",
           "resolve_block", "sweep", "clear_cache", "drive_count",
           "check_block", "sweep_times", "size_class", "work_size",
           "pick_winner"]

#: the launch shape of each op when no swept winner exists (always off the
#: card): the constants the kernels shipped with
FALLBACK: dict[str, dict[str, int]] = {
    "accumulate": {"edge_block": 128},
    "propagate": {"edge_block": 1024},
    "estimate": {"row_block": 512},
    "union_estimate": {"set_block": 8},
    "intersection_stats": {"pair_block": 4},
    "ertl_stats": {"pair_block": 8},
    "hip_delta": {"row_block": 256},
}

#: candidate grid per op; the sweep times each and keeps the fastest. The
#: C launchers take exactly these values (others: cudaErrorInvalidValue).
SWEEPS: dict[str, list[dict[str, int]]] = {
    "accumulate": [{"edge_block": b} for b in (64, 128, 256, 512)],
    "propagate": [{"edge_block": b} for b in (256, 512, 1024, 2048)],
    "estimate": [{"row_block": b} for b in (128, 256, 512)],
    "union_estimate": [{"set_block": b} for b in (4, 8, 16)],
    "intersection_stats": [{"pair_block": b} for b in (1, 2, 4, 8)],
    "ertl_stats": [{"pair_block": b} for b in (4, 8, 16, 32)],
    "hip_delta": [{"row_block": b} for b in (128, 256, 512)],
}

#: the argument of ``ops.<op>`` whose leading length is the call's work
#: count: edges (accumulate's rows, propagate's src), rows (estimate,
#: ``hip_delta``, ``ertl_stats``' paired rows), sets or pairs
WORK_ARG = {"accumulate": 1, "propagate": 1, "estimate": 0,
            "union_estimate": 1, "intersection_stats": 1, "ertl_stats": 0,
            "hip_delta": 0}

#: the default shapes (module docstring)
SWEEP_ROWS = 1 << 20
SWEEP_EDGES = 1 << 23
SWEEP_PAIRS = 1 << 18
SWEEP_SETS, SWEEP_LANES = 4096, 64
#: the work count of each op's default shapes
_DEFAULT_WORK = {"accumulate": SWEEP_EDGES, "propagate": SWEEP_EDGES,
                 "estimate": SWEEP_ROWS, "hip_delta": SWEEP_ROWS,
                 "union_estimate": SWEEP_SETS,
                 "intersection_stats": SWEEP_PAIRS,
                 "ertl_stats": SWEEP_PAIRS}
#: timed rounds, each candidate once a round, after one warm-up round
SWEEP_REPS = 9
#: a candidate replaces the fallback only when its median is below the
#: fallback's by more than this share
WIN_MARGIN = 0.05
#: the least bytes written before each timed call: on the H100 about
#: 90 us of device time, more than a wrapper's host work (about 30 us),
#: so the kernel is enqueued before the start event runs
FLUSH_BYTES = 256 << 20

_CACHE: dict[tuple, dict[str, int]] = {}
_TIMES: dict[tuple, list[tuple[dict[str, int], float]]] = {}
_DRIVES = 0  # candidate timings actually run (stays 0 off the card)
_LOCK = threading.Lock()  # one sweep at a time: a key is driven once


def device_kind() -> str:
    """The current CUDA device's name (``torch.cuda.get_device_name()``),
    or ``"cpu"`` when there is no card."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()


def size_class(n: int) -> int:
    """The size class of a work count: ``ceil(log2(n))`` (0 for n <= 1)."""
    return max(int(n) - 1, 0).bit_length()


def work_size(op: str, inputs) -> int:
    """The work count of a call of ``ops.<op>`` on ``inputs`` (its tensor
    arguments in order): the leading length of its :data:`WORK_ARG`."""
    return int(inputs[WORK_ARG[op]].shape[0])


def cache_key(op: str, p: int, impl: str = "cuda", layout: str = "byte",
              size: int | None = None) -> tuple:
    """The autotune cache key: ``(device_kind, p, op, impl, layout,
    size_class)``, the class of the work count ``size`` (``None``: that
    of the op's default sweep shapes)."""
    if size is None:
        size = _DEFAULT_WORK.get(op, 1)
    return (device_kind(), int(p), op, impl, layout, size_class(size))


def tuned_params(op: str, *, p: int, impl: str = "cuda", layout: str = "byte",
                 size: int | None = None) -> dict[str, int]:
    """Best-known block parameters of ``(op, impl, layout)`` at ``p`` for a
    call of work count ``size`` (:func:`cache_key`): the swept winner of
    its size class over the fallback entry; ``{}`` for an op in neither."""
    base = dict(FALLBACK.get(op, {}))
    winner = _CACHE.get(cache_key(op, p, impl, layout, size))
    if winner:
        base.update(winner)
    return base


def resolve_block(op: str, name: str, value: int | None, *, p: int,
                  impl: str = "cuda", layout: str = "byte",
                  size: int | None = None) -> int | None:
    """One block argument: an explicit ``value`` wins; ``None`` takes
    :func:`tuned_params` (``None`` again for an unknown op or name)."""
    if value is not None:
        return value
    if not _CACHE:  # nothing swept: the fallback, without a device query
        return FALLBACK.get(op, {}).get(name)
    return tuned_params(op, p=p, impl=impl, layout=layout,
                        size=size).get(name)


def check_block(op: str, name: str, value: int | None) -> int:
    """``value`` checked against ``op``'s grid, or the fallback for
    ``None``: what a kernel wrapper passes to its launcher.
    ``ValueError`` naming the grid for any other value."""
    fallback = FALLBACK[op][name]
    if value is None or value == fallback:
        return fallback
    grid = [c[name] for c in SWEEPS[op]]
    if value not in grid:
        raise ValueError(f"{op}: {name}={value!r} is not in its grid {grid}")
    return value


def clear_cache() -> None:
    """Drop every cached winner and its timings."""
    with _LOCK:
        _CACHE.clear()
        _TIMES.clear()


def drive_count() -> int:
    """How many candidate timings have run in this process."""
    return _DRIVES


def sweep_times(op: str, *, p: int, impl: str = "cuda", layout: str = "byte",
                size: int | None = None) -> list[tuple[dict[str, int], float]]:
    """``(candidate, ms)`` of the sweep that filled this key, in grid
    order; ``[]`` when none was timed (off the card, a fallback entry, or
    no sweep)."""
    return list(_TIMES.get(cache_key(op, p, impl, layout, size), []))


def pick_winner(op: str, timed: list[tuple[dict[str, int], float]],
                ) -> dict[str, int]:
    """The fastest of ``timed`` (``(candidate, ms)``) when it beats the
    fallback's time by more than :data:`WIN_MARGIN`, else the fallback."""
    fallback = FALLBACK[op]
    fb_ms = next(ms for c, ms in timed if c == fallback)
    best, best_ms = min(timed, key=lambda t: t[1])
    return dict(best if best_ms < (1.0 - WIN_MARGIN) * fb_ms else fallback)


def _panel(gen, rows: int, p: int, layout: str) -> torch.Tensor:
    """A seeded random panel on the card: registers below 16 (byte), any
    nibble (packed)."""
    if layout == "packed":
        return torch.randint(0, 256, (rows, 1 << (p - 1)), generator=gen,
                             device="cuda", dtype=torch.uint8)
    return torch.randint(0, 16, (rows, 1 << p), generator=gen, device="cuda",
                         dtype=torch.uint8)


def _default_inputs(op: str, p: int, layout: str) -> tuple:
    """``ops.<op>``'s tensor arguments at the default shapes, on the card."""
    from repro_torch.kernels import hll_propagate

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = SWEEP_ROWS

    def ints(hi, size):
        return torch.randint(0, hi, size, generator=gen, device="cuda",
                             dtype=torch.int32)

    if op == "accumulate":
        return (_panel(gen, n, p, layout).zero_(), ints(n, (SWEEP_EDGES,)),
                ints(1 << 31, (SWEEP_EDGES,)).view(torch.uint32))
    if op == "propagate":
        src = ints(n, (SWEEP_EDGES,))
        dst = ints(n - 1, (SWEEP_EDGES,))
        dst += (dst >= src).to(torch.int32)  # no self-edge
        return (_panel(gen, n, p, layout),
                *hll_propagate.sort_routing(src, dst))
    if op == "estimate":
        return (_panel(gen, n, p, layout),)
    if op == "hip_delta":
        prev = _panel(gen, n, p, layout)
        return prev, torch.maximum(prev, _panel(gen, n, p, layout))
    if op == "union_estimate":
        size = torch.randint(2, SWEEP_LANES + 1, (SWEEP_SETS, 1),
                             generator=gen, device="cuda")
        return (_panel(gen, n, p, layout), ints(n, (SWEEP_SETS, SWEEP_LANES)),
                torch.arange(SWEEP_LANES, device="cuda") < size)
    if op == "intersection_stats":
        return _panel(gen, n, p, layout), ints(n, (SWEEP_PAIRS, 2))
    if op == "ertl_stats":
        return (_panel(gen, SWEEP_PAIRS, p, layout),
                _panel(gen, SWEEP_PAIRS, p, layout))
    raise KeyError(f"no autotune workload for op {op!r}")


def _runner(op: str, p: int, layout: str, inputs: tuple):
    """``(run, setup)``: ``run(params)`` calls ``op``'s kernel wrapper on
    ``inputs`` with those block parameters; ``setup()`` (untimed, or
    ``None``) restores what the call changes. The caller's tensors are
    never written: accumulate folds into a zeroed copy of the panel."""
    from repro_torch.core.hll import HLLConfig
    from repro_torch.kernels import ertl_stats, hip_delta, hll_accumulate
    from repro_torch.kernels import hll_estimate, hll_propagate
    from repro_torch.kernels import intersection_stats, union_estimate

    cfg = HLLConfig(p=p)
    kw = {"layout": layout}
    if op == "accumulate":
        regs, rows, keys = inputs
        scratch = torch.zeros_like(regs)
        return (lambda prm: hll_accumulate.hll_accumulate(
            scratch, rows, keys, p=p, seed=cfg.seed, **kw, **prm),
            scratch.zero_)
    if op == "propagate":
        regs, src, dst = inputs
        return (lambda prm: hll_propagate.hll_propagate(
            regs, src, dst, **kw, **prm), None)
    if op == "estimate":
        (regs,) = inputs
        return (lambda prm: hll_estimate.hll_estimate_stats(
            regs, **kw, **prm), None)
    if op == "hip_delta":
        prev, cur = inputs
        return (lambda prm: hip_delta.hip_delta_rows(prev, cur, **kw, **prm),
                None)
    if op == "union_estimate":
        regs, ids, mask = inputs
        return (lambda prm: union_estimate.union_estimate_stats(
            regs, ids, mask, **kw, **prm), None)
    if op == "intersection_stats":
        regs, pairs = inputs
        pa, pb = pairs[:, 0].contiguous(), pairs[:, 1].contiguous()
        return (lambda prm: intersection_stats.intersection_stats(
            regs, pa, pb, cfg.q, **kw, **prm), None)
    if op == "ertl_stats":
        a, b = inputs
        return (lambda prm: ertl_stats.ertl_stats(a, b, cfg.q, **kw, **prm),
                None)
    raise KeyError(f"no autotune workload for op {op!r}")


def _time_all(run, setup, candidates: list[dict[str, int]]) -> list[float]:
    """Each candidate's median CUDA-event ms of ``run(candidate)``, the
    candidates in turn within each round (module docstring)."""
    global _DRIVES
    _DRIVES += len(candidates)
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    flush = torch.empty(max(2 * getattr(props, "L2_cache_size", 0),
                            FLUSH_BYTES), dtype=torch.uint8, device="cuda")
    events: list[list] = [[] for _ in candidates]
    for rnd in range(SWEEP_REPS + 1):  # round 0 warms up
        for i, cand in enumerate(candidates):
            if setup is not None:
                setup()
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(cand)
            end.record()
            if rnd:
                events[i].append((start, end))
    torch.cuda.synchronize()
    return [statistics.median(s.elapsed_time(e) for s, e in ev)
            for ev in events]


def sweep(op: str, *, p: int, impl: str = "cuda", layout: str = "byte",
          force: bool = False, inputs: tuple | None = None) -> dict[str, int]:
    """Sweep the candidate grid of one ``(op, impl, layout, p)`` cell on
    the current card and cache the winner (:func:`pick_winner`) under
    :func:`cache_key`, in the size class of the call it was timed on.

    ``inputs``: ``ops.<op>``'s tensor arguments on the card, in order
    (``(regs, rows, keys)``, ``(regs, src, dst)`` dst-sorted,
    ``(regs,)``, ``(regs, ids, mask)``, ``(regs, pairs)``, ``(a, b)``,
    ``(prev, cur)``), at the shape the winner is meant for; ``None``
    builds the default shapes. Returns the resolved parameters
    (:func:`tuned_params`). A repeat sweep of the same key is a cache hit
    and drives nothing (``force=True`` sweeps again). Without a card, or
    for ``impl="ref"``, the fallback entry is installed without timing
    anything. An unknown op is a no-op returning ``{}``. A candidate that
    fails to launch raises.
    """
    with _LOCK:
        candidates = SWEEPS.get(op)
        if not candidates:
            return tuned_params(op, p=p, impl=impl, layout=layout)
        size = None if inputs is None else work_size(op, inputs)
        key = cache_key(op, p, impl, layout, size)
        resolved = dict(p=p, impl=impl, layout=layout, size=size)
        if key in _CACHE and not force:
            return tuned_params(op, **resolved)
        if impl == "ref" or not torch.cuda.is_available():
            _CACHE[key] = dict(FALLBACK[op])
            _TIMES.pop(key, None)
            return tuned_params(op, **resolved)
        if inputs is None:
            inputs = _default_inputs(op, p, layout)
        run, setup = _runner(op, p, layout, inputs)
        timed = list(zip(candidates, _time_all(run, setup, candidates)))
        _CACHE[key] = pick_winner(op, timed)
        _TIMES[key] = timed
        return tuned_params(op, **resolved)
