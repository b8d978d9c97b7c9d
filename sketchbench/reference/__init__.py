"""The plain reference the benchmark holds the program's answers against.

Plain PyTorch, independent of the program: it imports nothing of the
program's package (or of the JAX package) and takes nothing the program
made. From the same edge list and the deployment's stated sketch it
works out the registers, the t-hop panels and their estimates, and the
intersection MLE itself. :class:`Reference` keeps what it has computed,
so several checks of one run share the panels. ``dtype`` is the
precision of every float it computes; a lower one makes the control.
"""
from __future__ import annotations

import numpy as np
import torch

from sketchbench.reference import mle, sketch

#: registers of the packed layout saturate here
PACKED_SATURATION = 15


class Reference:
    """Reference answers for one graph and one sketch deployment."""

    def __init__(self, edges: np.ndarray, n: int, config: dict, device,
                 dtype: torch.dtype = torch.float32):
        self.edges = edges
        self.n = int(n)
        self.p = int(config["sketch"]["p"])
        self.seed = int(config["sketch"].get("seed", 0))
        self.q = 64 - self.p
        self.layout = config["layout"]
        self.device = torch.device(device)
        self.dtype = dtype
        self._panel = None
        self._hops: list[torch.Tensor] = []
        self._pairs: dict = {}

    def lower(self, dtype: torch.dtype) -> "Reference":
        """The same reference computing its floats in ``dtype``, sharing
        the register panels (which are exact in any precision)."""
        other = Reference.__new__(Reference)
        other.__dict__.update(self.__dict__)
        other.dtype = dtype
        other._pairs = {}
        return other

    def panel(self) -> torch.Tensor:
        """Registers after accumulating every edge, uint8[n, 2^p], one a
        byte (clamped to 15 for the packed layout)."""
        if self._panel is None:
            e = torch.from_numpy(self.edges).to(self.device)
            sat = PACKED_SATURATION if self.layout == "packed" else None
            self._panel = sketch.accumulate(e, self.n, self.p, self.seed, sat)
            self._hops = [self._panel]
        return self._panel

    def hop_panels(self, t_max: int) -> list[torch.Tensor]:
        """D^1..D^t_max: D^1 the accumulated panel, each later one a pass of
        Algorithm 2 over the one before."""
        self.panel()
        if len(self._hops) < t_max:
            routing = sketch.Routing(
                torch.from_numpy(self.edges).to(self.device), self.n)
            while len(self._hops) < t_max:
                self._hops.append(routing.propagate(self._hops[-1]))
            del routing
        return self._hops[:t_max]

    def hop_estimates(self, t_max: int) -> torch.Tensor:
        """Per-vertex estimates of each hop, [t_max, n] in ``dtype``."""
        return torch.stack([sketch.estimates(h, self.dtype)
                            for h in self.hop_panels(t_max)])

    def pair_mle(self, pairs: np.ndarray, iters: int,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(T̃, |A ∪ B| estimate, whether the ascent settled) of every pair
        int[B, 2], in ``dtype``; kept for the last pairs array asked
        for."""
        key = (id(pairs), iters)
        if key not in self._pairs:
            regs = self.panel()
            idx = torch.from_numpy(np.asarray(pairs, dtype=np.int64)).to(
                self.device)
            self._pairs = {key: mle.intersection(
                regs[idx[:, 0]], regs[idx[:, 1]], self.q, iters, self.dtype)}
        return self._pairs[key]

    def free(self) -> None:
        """Drop every panel computed so far."""
        self._panel = None
        self._hops = []
        self._pairs = {}
