"""Snapshot rotation: the policy and the atomic holder readers serve from
(port of ``repro.serve.snapshot``).

The continuous-serving subsystem (DESIGN.md §3d) splits one engine into a
**writer** (ingests continuously, owned by one thread) and read-only
**snapshots** (frozen ``SketchEngine.snapshot()`` views readers query).
This module owns the rotation side of that split:

* :class:`RotationPolicy` — *when* the writer publishes a fresh snapshot:
  after every N ingested blocks and/or once ingested-but-unpublished data
  is older than a staleness budget.
* :class:`SnapshotSlot` — *how* it publishes: an atomic pointer swap.
  A snapshot's panel is never written (the writer clones a leased panel
  before its next in-place write, ``SketchEngine._release_lease``), so
  the swap itself never copies and never stalls a reader — a drain that
  started on the old snapshot finishes on it, the next drain picks up
  the new one.

``SnapshotFrozen`` (the error a mutating call on a snapshot raises) is
re-exported here from ``repro_torch.engine.base`` so serving code
imports every snapshot-related name from one place.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from repro_torch.engine.base import SketchEngine, SnapshotFrozen

__all__ = ["RotationPolicy", "SnapshotSlot", "SnapshotFrozen"]


@dataclass(frozen=True)
class RotationPolicy:
    """When the writer publishes a new snapshot (DESIGN.md §3d).

    Attributes:
      every_blocks: rotate once this many ingest blocks have accumulated
        since the last rotation (default 1: publish after every drained
        ingest batch — minimal staleness, one potential panel clone per
        batch).
      max_staleness: optional seconds budget — rotate when the *oldest*
        ingested-but-unpublished block is older than this, even if fewer
        than ``every_blocks`` blocks arrived. ``None`` disables the timer
        (rotation is purely block-counted). A policy never rotates when
        nothing was ingested: readers already serve the newest state.
    """

    every_blocks: int = 1
    max_staleness: float | None = None

    def __post_init__(self):
        """Validate the knobs up front (clear errors beat a stuck writer)."""
        if self.every_blocks < 1:
            raise ValueError(
                f"every_blocks must be >= 1, got {self.every_blocks}")
        if self.max_staleness is not None and self.max_staleness <= 0:
            raise ValueError(
                f"max_staleness must be > 0 seconds (or None), got "
                f"{self.max_staleness}")

    def due(self, blocks_pending: int, oldest_pending_age: float) -> bool:
        """Should the writer rotate now?

        Args:
          blocks_pending: ingest blocks applied since the last rotation.
          oldest_pending_age: seconds since the oldest such block was
            applied (ignored when nothing is pending).
        """
        if blocks_pending <= 0:
            return False
        if blocks_pending >= self.every_blocks:
            return True
        return (self.max_staleness is not None
                and oldest_pending_age >= self.max_staleness)

    def timeout(self, blocks_pending: int, oldest_pending_age: float,
                ) -> float | None:
        """Seconds until the staleness timer forces a rotation, or None.

        The writer uses this as its condition-wait timeout so a trickle
        of blocks below ``every_blocks`` still publishes within the
        staleness budget instead of waiting for the next arrival.
        """
        if blocks_pending <= 0 or self.max_staleness is None:
            return None
        return max(0.0, self.max_staleness - oldest_pending_age)


class SnapshotSlot:
    """Atomic holder of the snapshot readers currently serve from.

    Rotation is :meth:`swap`: a pointer assignment under a lock, plus
    staleness bookkeeping — never a copy (the panels inside a snapshot
    are never written; the old snapshot stays valid for drains already
    in flight and is garbage-collected when the last reader drops it,
    which also ends its lease on the writer's panel).
    """

    def __init__(self, snap: SketchEngine):
        self._lock = threading.Lock()
        self._snap = snap
        self._rotated_at = time.monotonic()
        self._rotations = 0

    def get(self) -> SketchEngine:
        """The current read-only snapshot (consistent pointer read)."""
        with self._lock:
            return self._snap

    def swap(self, snap: SketchEngine) -> SketchEngine:
        """Publish ``snap`` as current; returns the previous snapshot."""
        with self._lock:
            old, self._snap = self._snap, snap
            self._rotated_at = time.monotonic()
            self._rotations += 1
        return old

    @property
    def rotations(self) -> int:
        """Number of :meth:`swap` calls since construction."""
        with self._lock:
            return self._rotations

    @property
    def age_seconds(self) -> float:
        """Seconds since the current snapshot was published."""
        with self._lock:
            return time.monotonic() - self._rotated_at

    def stats(self, writer_version: int | None = None) -> dict:
        """Rotation/staleness snapshot for the serving stats surface.

        ``version`` is the engine version the current snapshot serves;
        ``version_lag`` (when ``writer_version`` is given) counts the
        ingest/merge steps the writer has applied beyond it —
        the data-freshness gap admission-controlled readers accept in
        exchange for never stalling (DESIGN.md §3d).
        """
        with self._lock:
            out = {
                "version": self._snap.version,
                "rotations": self._rotations,
                "age_seconds": time.monotonic() - self._rotated_at,
            }
        if writer_version is not None:
            out["writer_version"] = writer_version
            out["version_lag"] = writer_version - out["version"]
        return out
