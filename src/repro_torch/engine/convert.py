"""Carry engine state between the JAX package and the port, as numpy.

Neither package imports the other: a JAX engine's registers
(``np.asarray(jax_engine.regs)``), vertex count, sketch family, register
layout, config fields and edge list cross as plain numpy arrays and
dicts.
``from_numpy_state`` builds the port's engine from them;
``to_numpy_state`` goes back. Checkpoints (``engine.load`` and
``SketchEngine.save``) carry the same state as files.
"""
from __future__ import annotations

import numpy as np

from repro_torch.engine.local import LocalEngine
from repro_torch.kernels import registry

__all__ = ["from_numpy_state", "to_numpy_state"]


def from_numpy_state(regs: np.ndarray, n: int, cfg_fields: dict,
                     edges: np.ndarray | None, *, device=None) -> LocalEngine:
    """A port engine over a register table ``uint8[>=n, r]``.

    ``cfg_fields`` holds ``p``/``seed``/``estimator`` and, beside them,
    the sketch ``family`` ("hll" when absent) and the register ``layout``
    of ``regs`` ("byte" when absent; a "packed" table is ``uint8[>=n,
    r/2]``); ``device=None`` means the card.
    """
    fields = dict(cfg_fields)
    fam = registry.family(fields.pop("family", "hll"))
    layout = fields.pop("layout", "byte")
    return LocalEngine.from_regs(np.asarray(regs, dtype=np.uint8), n,
                                 fam.config_from_dict(fields), edges=edges,
                                 layout=layout, device=device)


def to_numpy_state(engine: LocalEngine,
                   ) -> tuple[np.ndarray, int, dict, np.ndarray | None]:
    """(registers uint8[n, w], n, family, layout and config fields, edges)
    of a port engine."""
    regs = engine.regs[: engine.n].cpu().numpy()
    fields = {"family": engine.family.name, "layout": engine.layout,
              **engine.family.config_dict(engine.cfg)}
    return regs, engine.n, fields, engine.edges
