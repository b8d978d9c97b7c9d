"""The failover writer's checkpoint cadence (the ``FTConfig`` of
``repro.runtime.ft``).

The failover-aware ``ContinuousServer`` writer is the port's only
fault-tolerant runtime so far, and it reads three knobs: where
checkpoints go, how often (in applied ingest blocks) and how many are
kept. The JAX package's retry and straggler knobs, its watchdog, its
training loop and its multi-host coordinator are not ported yet
(ROADMAP Queue A item 11), so their fields are absent here.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["FTConfig"]


@dataclass
class FTConfig:
    """Checkpoint cadence of the failover writer.

    Attributes:
      ckpt_dir: directory of the asynchronous checkpoint stream.
      ckpt_every: applied ingest blocks between checkpoints.
      keep: newest checkpoints kept on disk.
    """

    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    keep: int = 3
