"""Carry engine state between the JAX package and the port, as numpy.

Neither package imports the other: a JAX engine's registers
(``np.asarray(jax_engine.regs)``), vertex count, config fields and edge
list cross as plain numpy arrays and dicts. ``from_numpy_state`` builds
the port's engine from them; ``to_numpy_state`` goes back.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hll import HLLConfig
from repro_torch.engine.local import LocalEngine

__all__ = ["from_numpy_state", "to_numpy_state"]


def from_numpy_state(regs: np.ndarray, n: int, cfg_fields: dict,
                     edges: np.ndarray | None, *, device=None) -> LocalEngine:
    """A port engine over a register table ``uint8[>=n, r]``.

    ``cfg_fields`` holds ``p``/``seed``/``estimator``; ``device=None``
    means the card.
    """
    cfg = HLLConfig(**cfg_fields)
    return LocalEngine.from_regs(np.asarray(regs, dtype=np.uint8), n, cfg,
                                 edges=edges, device=device)


def to_numpy_state(engine: LocalEngine,
                   ) -> tuple[np.ndarray, int, dict, np.ndarray | None]:
    """(registers uint8[n, r], n, config fields, edges) of a port engine."""
    cfg = engine.cfg
    regs = engine.regs[: engine.n].cpu().numpy()
    fields = {"p": cfg.p, "seed": cfg.seed, "estimator": cfg.estimator}
    return regs, engine.n, fields, engine.edges
