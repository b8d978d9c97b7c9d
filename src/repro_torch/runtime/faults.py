"""Deterministic fault injection for the failover runtime (copy of
``repro.runtime.faults``, DESIGN.md §14).

Faults are declared up front as a plan keyed on *(host, global block
index)* — never on wall-clock time or randomness — so every test and
benchmark run replays the identical failure schedule. The multi-host
coordinator (``repro_torch.runtime.coordinator``) consults it per ingest
block, and the failover-aware ``repro_torch.serve.ContinuousServer``
writer per applied ingest block.

Three fault kinds mirror the failure modes the source paper's YGM-style
deployment has to survive:

* :class:`KillHost` — the host process dies at a block. Its death
  surfaces synchronously (``HostLost``) when the dead host owns the
  block, or via missed heartbeats -> lease expiry otherwise.
  ``at_visit`` lets a kill fire only on the *n*-th time a block index is
  replayed, which is how tests stage a second failure during recovery.
* :class:`DropHeartbeat` — the host stays alive but its heartbeats are
  lost for ``count`` consecutive blocks; if that exceeds the lease the
  coordinator evicts it exactly as if it had died.
* :class:`SlowHost` — a straggler: block application is delayed by
  ``delay_s`` seconds, exercising the EWMA watchdog without eviction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HostLost", "KillHost", "DropHeartbeat", "SlowHost",
           "FaultInjector"]


class HostLost(RuntimeError):
    """A host is gone (killed, or its heartbeat lease expired).

    Carries ``host`` (logical host id), ``block`` (global block index at
    which the loss was detected) and ``reason`` (``"killed"`` or
    ``"lease expired"``). The failover writer catches this, restores the
    newest complete checkpoint and resumes from the ``m_ingested``
    cursor.
    """

    def __init__(self, host: int, block: int, reason: str = "killed"):
        super().__init__(f"host {host} lost at block {block} ({reason})")
        self.host = host
        self.block = block
        self.reason = reason


@dataclass(frozen=True)
class KillHost:
    """Host ``host`` dies when block ``at_block`` is visited.

    ``at_visit`` = 1 fires on the first pass over that block index;
    ``at_visit`` = 2 fires only when the block is *replayed* (i.e. during
    recovery from an earlier failure), modelling a double failure before
    recovery completes. Once fired the host stays dead for the rest of
    the run.
    """

    host: int
    at_block: int
    at_visit: int = 1


@dataclass(frozen=True)
class DropHeartbeat:
    """Heartbeats from ``host`` are lost for blocks [at_block, at_block+count).

    The host itself keeps working; whether it gets evicted depends on
    the coordinator's ``lease_blocks`` — drops shorter than the lease
    are absorbed, longer ones are indistinguishable from death.
    """

    host: int
    at_block: int
    count: int = 1


@dataclass(frozen=True)
class SlowHost:
    """Block application on ``host`` is delayed by ``delay_s`` seconds
    for blocks [at_block, at_block+count) — a deterministic straggler."""

    host: int
    at_block: int
    delay_s: float = 0.05
    count: int = 1


@dataclass
class FaultInjector:
    """Replays a declared fault plan against (host, block) probes.

    Stateful across a run: ``killed`` accumulates dead (or fenced —
    lease-evicted) hosts, ``visits`` counts how many times each block
    index has been ticked (for ``at_visit``), and ``fired`` records the
    faults that actually triggered, in order, for assertions.
    """

    faults: tuple = ()
    killed: set = field(default_factory=set)
    visits: dict = field(default_factory=dict)
    fired: list = field(default_factory=list)

    def tick(self, block: int) -> None:
        """Advance to ``block``: fire any KillHost due on this visit.

        Call exactly once per block attempt (including replays) before
        probing ``is_dead`` — visit counting is what lets a second
        failure target the recovery pass itself.
        """
        visit = self.visits.get(block, 0) + 1
        self.visits[block] = visit
        for f in self.faults:
            if (isinstance(f, KillHost) and f.at_block == block
                    and f.at_visit == visit and f.host not in self.killed):
                self.killed.add(f.host)
                self.fired.append(f)

    def is_dead(self, host: int) -> bool:
        """True once ``host`` has been killed (or fenced by the caller)."""
        return host in self.killed

    def fence(self, host: int) -> None:
        """Mark an evicted host dead-to-us even if its process survives.

        Eviction must be sticky: a lease-expired host that comes back is
        not allowed to rejoin mid-run (its blocks were reassigned).
        """
        self.killed.add(host)

    def heartbeat_visible(self, host: int, block: int) -> bool:
        """Would ``host``'s heartbeat for ``block`` reach the coordinator?

        Dead hosts never beat; live hosts miss exactly the blocks their
        DropHeartbeat windows cover.
        """
        if host in self.killed:
            return False
        for f in self.faults:
            if (isinstance(f, DropHeartbeat) and f.host == host
                    and f.at_block <= block < f.at_block + f.count):
                return False
        return True

    def delay(self, host: int, block: int) -> float:
        """Seconds of injected straggle for ``host`` applying ``block``."""
        return sum(f.delay_s for f in self.faults
                   if isinstance(f, SlowHost) and f.host == host
                   and f.at_block <= block < f.at_block + f.count)
