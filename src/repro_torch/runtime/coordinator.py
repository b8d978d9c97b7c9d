"""Multi-host failover coordinator (port of ``repro.runtime.coordinator``).

Supervised streaming ingest. *Hosts* are logical ingest workers, as in
the JAX package: they share the edge stream round-robin by block, and
with ``backend="sharded"`` the engine holds one register shard per live
host (shard ``s`` on card ``s mod device_count``, one process). The loop
composes three pieces:

* **durability**: ``engine.checkpoint_state()`` through
  ``ckpt.AsyncCheckpointer`` every ``ckpt_every`` blocks, so the writes
  overlap the next blocks' ingest (the host copy of the panel is taken
  on the calling thread);
* **elastic restore**: on a lost host, ``engine.load(..., shards=S-1)``
  re-hosts the newest *complete* manifest on the survivors (a step
  directory without a manifest is invisible to ``latest_step``);
* **resume**: ingest restarts from the restored ``m_ingested`` cursor,
  which is a block boundary because checkpoints are taken between
  blocks.

Loss detection is by heartbeat lease: every live host beats once a
block tick (unless the fault plan drops it), and a host whose last beat
is ``lease_blocks`` ticks stale is evicted exactly like a killed one.
``runtime.ft``'s retry and straggler machinery runs in the same loop: a
failed block is retried ``max_retries`` times (an ingest that raises
leaves ``m`` unchanged and register max is idempotent, so a retry counts
no edge twice), and each block's wall time, ending in a synchronize of
the engine's cards, feeds the warmup-aware ``StragglerWatchdog``.

``python -m repro_torch.runtime.coordinator --smoke`` runs the
kill-one-host demonstration on the card (``--device cpu`` on the CPU):
4 hosts, sharded, host 2 killed at block 8; the recovered engine's
answers must equal an uninterrupted local build's bit for bit.
"""
from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import engine
from repro_torch.ckpt.checkpoint import AsyncCheckpointer, latest_step
from repro_torch.runtime.faults import FaultInjector, HostLost
from repro_torch.runtime.ft import FTConfig, StragglerWatchdog

__all__ = ["CoordinatorConfig", "ClusterFailed", "Coordinator",
           "coordinator"]


class ClusterFailed(RuntimeError):
    """Unrecoverable: too few hosts survive, or recoveries exhausted."""


@dataclass(frozen=True)
class CoordinatorConfig:
    """Shape of the supervised ingest run (checkpoint, retry and
    straggler knobs are in :class:`repro_torch.runtime.ft.FTConfig`).

    ``hosts`` logical workers share the edge stream round-robin by block;
    with ``backend="sharded"`` the engine runs one register shard per
    live host and reshards to the survivor count on eviction. ``block``
    is the ingest granularity (edges per block), also the heartbeat
    tick. A host whose heartbeat is ``lease_blocks`` ticks old is
    evicted. ``ckpt_every`` counts blocks between async checkpoints.
    ``min_hosts`` and ``max_recoveries`` bound how much failure the run
    absorbs before raising :class:`ClusterFailed`.
    """

    hosts: int = 2
    block: int = 1024
    ckpt_every: int = 2
    lease_blocks: int = 2
    min_hosts: int = 1
    max_recoveries: int = 8


def _synchronize(eng) -> None:
    """Wait for the work queued on every CUDA device of ``eng``'s panel
    (each shard's card on the sharded backend); nothing on the CPU."""
    for dev in {d for d in getattr(eng, "devices", [eng.device])
                if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Coordinator:
    """Supervised streaming ingest with eviction and elastic recovery.

    Construct with the full edge array and the engine coordinates
    ``engine.build`` takes, then call :meth:`run`. Faults come from a
    :class:`repro_torch.runtime.faults.FaultInjector`; without one the
    loop is plain checkpointed ingest. ``replicate`` optionally installs
    a hot-row replica set before ingest; the id set rides the checkpoint
    leaf, so placement survives recovery. ``cfg`` is the sketch config,
    passed through to the engine. ``device`` is where every engine of the
    run lives (``None``: the card, which must be present).
    """

    def __init__(self, edges, n: int, cfg=None, *, ft: FTConfig,
                 config: CoordinatorConfig | None = None,
                 faults: FaultInjector | None = None,
                 backend: str = "local", impl: str | None = None,
                 layout: str | None = None, family: str | None = None,
                 replicate=None, device=None):
        self.edges = np.asarray(edges)
        self.n = int(n)
        self.cfg = cfg
        self.ft = ft
        self.cc = config or CoordinatorConfig()
        self.injector = faults or FaultInjector()
        self.backend = backend
        self.impl = impl
        self.layout = layout
        self.family = family
        self.replicate_ids = replicate
        self.device = device
        self.alive = list(range(self.cc.hosts))
        self.evicted: list[int] = []
        self.ckpt = AsyncCheckpointer(ft.ckpt_dir, keep=ft.keep)
        self.watchdog = StragglerWatchdog(
            factor=ft.straggler_factor, alpha=ft.ewma_alpha,
            warmup=ft.warmup_steps, on_straggler=self._on_straggler)
        self._last_beat: dict[int, int] = {}
        self.stats = {
            "hosts": self.cc.hosts, "hosts_alive": self.cc.hosts,
            "hosts_evicted": [], "heartbeats_seen": 0, "evictions": 0,
            "recoveries": 0, "last_recovery_ms": None,
            "checkpoints_written": 0, "blocks_done": 0,
            "blocks_replayed": 0, "straggler_steps": 0, "retries": 0,
        }

    # ------------------------------------------------------------ pieces
    def _on_straggler(self, dt: float, ewma: float) -> None:
        """Watchdog callback: count the slow block (eviction stays
        lease-based: slowness is not loss)."""
        self.stats["straggler_steps"] += 1

    def _engine_kwargs(self) -> dict:
        """Engine coordinates for the *current* live-host count."""
        kw = {"backend": self.backend, "impl": self.impl,
              "layout": self.layout, "family": self.family,
              "device": self.device}
        if self.backend == "sharded":
            kw["shards"] = len(self.alive)
        return kw

    def _fresh_engine(self):
        """Empty engine (no usable checkpoint to restore from)."""
        eng = engine.open(self.n, self.cfg, **self._engine_kwargs())
        if self.replicate_ids is not None:
            eng.replicate(self.replicate_ids)
        return eng

    def _checkpoint(self, eng, step: int) -> None:
        """Initiate one async engine-format checkpoint at ``step``."""
        tree, extra = eng.checkpoint_state()
        self.ckpt.save(step, tree, extra=extra)
        self.stats["checkpoints_written"] += 1

    def _reset_leases(self, block: int) -> None:
        """Fresh lease for every survivor as of ``block``."""
        self._last_beat = {h: block - 1 for h in self.alive}

    def _beat(self, block: int) -> None:
        """Collect this tick's heartbeats, then enforce leases."""
        for h in self.alive:
            if self.injector.heartbeat_visible(h, block):
                self._last_beat[h] = block
                self.stats["heartbeats_seen"] += 1
        for h in self.alive:
            if block - self._last_beat[h] >= self.cc.lease_blocks:
                raise HostLost(h, block, reason="lease expired")

    def _apply(self, eng, chunk: np.ndarray, host: int, block: int) -> None:
        """Ingest one block, retrying a failure ``ft.max_retries`` times.

        An ingest that raises leaves ``eng.m`` unchanged (the edge chunk
        is recorded after its launches) and register max is idempotent,
        so a retry counts no edge twice. ``HostLost`` is never retried.
        """
        for attempt in range(self.ft.max_retries + 1):
            try:
                eng.ingest(chunk)
                return
            except HostLost:
                raise
            except Exception:
                if attempt == self.ft.max_retries:
                    raise
                self.stats["retries"] += 1

    # ------------------------------------------------------- control loop
    def _ingest_from(self, eng, cursor: int):
        """Drive blocks [cursor/block, end); raises HostLost on failures."""
        block = self.cc.block
        total = math.ceil(len(self.edges) / block) if len(self.edges) else 0
        b = cursor // block
        while b < total:
            owner = self.alive[b % len(self.alive)]
            self.injector.tick(b)
            if self.injector.is_dead(owner):
                raise HostLost(owner, b, reason="killed")
            t0 = time.monotonic()
            d = self.injector.delay(owner, b)
            if d:  # injected straggle is part of the observed step time
                time.sleep(d)
            self._apply(eng, self.edges[b * block:(b + 1) * block],
                        owner, b)
            _synchronize(eng)  # time the block's work, not its launches
            self.watchdog.observe(time.monotonic() - t0)
            self._beat(b)
            self.stats["blocks_done"] += 1
            if (b + 1) % self.cc.ckpt_every == 0:
                self._checkpoint(eng, step=b)
            b += 1
        return eng

    def _restore(self):
        """``(engine, cursor)`` from the newest complete checkpoint, or a
        fresh engine at cursor 0 when there is none."""
        step = latest_step(self.ft.ckpt_dir)
        if step is None:
            return self._fresh_engine(), 0
        eng = engine.load(self.ft.ckpt_dir, step=step,
                          **self._engine_kwargs())
        return eng, eng.m

    def _recover(self, err: HostLost):
        """Evict, restore the newest complete manifest, return (eng, cursor)."""
        t0 = time.monotonic()
        self.ckpt.wait()  # an in-flight complete write may be the newest
        dead = [h for h in self.alive if self.injector.is_dead(h)]
        if err.host in self.alive and err.host not in dead:
            dead.append(err.host)  # lease-expired, not fault-killed
        for h in dead:
            self.alive.remove(h)
            self.evicted.append(h)
            self.injector.fence(h)
        self.stats["evictions"] += len(dead)
        self.stats["hosts_alive"] = len(self.alive)
        self.stats["hosts_evicted"] = list(self.evicted)
        self.stats["recoveries"] += 1
        if len(self.alive) < self.cc.min_hosts:
            raise ClusterFailed(
                f"{len(self.alive)} hosts survive, need {self.cc.min_hosts}")
        if self.stats["recoveries"] > self.cc.max_recoveries:
            raise ClusterFailed(
                f"exceeded max_recoveries={self.cc.max_recoveries}")
        eng, cursor = self._restore()
        self._reset_leases(cursor // self.cc.block)
        self.stats["blocks_replayed"] += max(
            0, err.block - cursor // self.cc.block)
        self.stats["last_recovery_ms"] = (time.monotonic() - t0) * 1e3
        return eng, cursor

    def run(self):
        """Ingest the whole stream under supervision; return the engine.

        Restores the newest checkpoint on entry (restart-exact), then
        loops ingest -> recover until the stream is exhausted, and ends
        with a final checkpoint, waited for, so the result is durable.
        ``self.stats`` holds the runtime counters.
        """
        eng, cursor = self._restore()
        self._reset_leases(cursor // self.cc.block)
        while True:
            try:
                self._ingest_from(eng, cursor)
                break
            except HostLost as e:
                eng, cursor = self._recover(e)
        last_block = max(0, math.ceil(len(self.edges) / self.cc.block) - 1)
        self._checkpoint(eng, step=last_block)
        self.ckpt.wait()
        self.stats["straggler_steps"] = self.watchdog.straggler_steps
        return eng


def coordinator(edges, n: int, cfg=None, *, ft: FTConfig,
                config: CoordinatorConfig | None = None,
                faults: FaultInjector | None = None, backend: str = "local",
                impl: str | None = None, layout: str | None = None,
                family: str | None = None, replicate=None, device=None):
    """Run a supervised ingest end to end; returns ``(engine, stats)``.

    See :class:`Coordinator` for the protocol and the arguments.
    """
    c = Coordinator(edges, n, cfg, ft=ft, config=config, faults=faults,
                    backend=backend, impl=impl, layout=layout,
                    family=family, replicate=replicate, device=device)
    eng = c.run()
    return eng, c.stats


def _smoke(device=None) -> int:
    """Kill-one-host smoke: recover and match an uninterrupted build.

    A seeded random graph (300 vertices, 4,096 edges) on 4 hosts,
    sharded; host 2 is killed at block 8 of 16. The recovered engine (3
    shards) must equal a local build of the same edges on ``device`` bit
    for bit: registers, degrees, a union and ``neighborhood(3)`` under
    every schedule; the replica set must be intact. Prints the stats
    and ``FAILOVER_SMOKE_OK``.
    """
    import json
    import tempfile

    from repro_torch.runtime.faults import KillHost

    rng = np.random.default_rng(7)
    n, m = 300, 4096
    edges = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    with tempfile.TemporaryDirectory() as d:
        ft = FTConfig(ckpt_dir=f"{d}/ckpt", keep=3)
        cc = CoordinatorConfig(hosts=4, block=256, ckpt_every=2)
        eng, stats = coordinator(
            edges, n, ft=ft, config=cc, backend="sharded",
            faults=FaultInjector(faults=(KillHost(host=2, at_block=8),)),
            replicate=[0, 1, 2, 3], device=device)
    ref = engine.build(edges, n, device=device)
    want = ref.neighborhood(3)
    checks = {
        "one recovery and one eviction": (stats["recoveries"] == 1
                                          and stats["evictions"] == 1),
        "3 shards and every edge": eng.shards == 3 and eng.m == m,
        "registers": torch.equal(eng.regs[:n].cpu(), ref.regs[:n].cpu()),
        "degrees": np.array_equal(eng.degrees(), ref.degrees()),
        "union": np.array_equal(eng.union_size([[0, 1, 2]]),
                                ref.union_size([[0, 1, 2]])),
        "replica ids": np.array_equal(eng.replicated_ids, [0, 1, 2, 3]),
    }
    for sched in ("ring", "ring_overlap", "allgather"):
        got = eng.neighborhood(3, schedule=sched)
        checks[f"neighborhood({sched})"] = all(
            np.array_equal(x, y) for x, y in zip(got, want))
    failed = [what for what, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"failover smoke: {failed} differ from an "
                           f"uninterrupted local build; stats {stats}")
    print(json.dumps(stats, indent=2))
    print("FAILOVER_SMOKE_OK")
    return 0


def _main(argv: list[str]) -> int:
    """``--smoke [--device DEV]``: run :func:`_smoke`; else print the
    module's docstring."""
    if "--smoke" not in argv:
        print(__doc__)
        return 0
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    return _smoke(device)


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
