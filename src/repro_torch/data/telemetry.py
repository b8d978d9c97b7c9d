"""Sketch telemetry: DegreeSketch applied to a model's streams (port of
``repro.data.telemetry``).

* :class:`RoutingSketch`: one HLL per expert over the distinct token ids
  routed to it. A mixture-of-experts layer's (expert <- token)
  assignments are a bipartite edge stream, and this is Algorithm 1 with
  the expert as the table row. Queries: per-expert coverage (the degree
  estimate), the pairwise overlap ``|N(e1) ∩ N(e2)|`` by the Ertl MLE,
  and the pairwise Jaccard matrix that flags routing collapse (two
  experts seeing nearly the same tokens).
* :class:`NGramSketch`: the distinct n-gram count of a token stream in
  one pass, merged across data shards with the closed union.

State lives on the card unless the caller asks for the CPU
(``init(device="cpu")``). An update is one ``hll_accumulate`` launch
(``hll.insert_table`` / ``hll.insert``) and returns a new table; the
coverage and the pair statistics are one ``hll_estimate_stats`` launch a
panel and one ``ertl_stats`` launch for every pair at once. Registers
equal the JAX package's byte for byte, and the n-gram window hashes bit
for bit (``uint32`` arithmetic held in ``int64``, ``core.hashing``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import hll, intersection
from repro_torch.core.hashing import MASK32, fmix32, mul32
from repro_torch.core.hll import HLLConfig
from repro_torch.kernels.inputs import resolve_device

__all__ = ["RoutingSketch", "NGramSketch"]

_GOLD = 0x9E3779B9  # the n-gram roll's odd multiplier


def _int64_on(x, device: torch.device) -> torch.Tensor:
    """Integer ids (a tensor or an array) as an int64 tensor on
    ``device``, each taken mod 2^32 as the JAX package's ``uint32`` cast
    takes it."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(device=device, dtype=torch.int64) & MASK32


def _window_hashes(toks: torch.Tensor, n: int) -> torch.Tensor:
    """The rolled hash of every length-``n`` window of the int64-held
    ``uint32`` ids ``toks`` [..., L]: int64-held ``uint32`` values of
    shape ``(..., L - n + 1)``, on ``toks``' device."""
    width = toks.shape[-1] - n + 1
    h = fmix32(toks[..., :width])
    for i in range(1, n):
        h = fmix32(h ^ mul32(toks[..., i:width + i], _GOLD))
    return h


@dataclass
class RoutingSketch:
    """Per-expert HLL sketches of the token ids routed to each expert."""

    num_experts: int
    cfg: HLLConfig = field(default_factory=lambda: HLLConfig(p=8))

    def init(self, device=None) -> torch.Tensor:
        """The empty table ``uint8[num_experts, r]`` on ``device``
        (``None``: the card, which must be present)."""
        return hll.empty_table(self.num_experts, self.cfg,
                               device=resolve_device(device))

    def update(self, table: torch.Tensor, expert_ids,
               token_ids) -> torch.Tensor:
        """Insert each token into the sketches of the experts it was routed
        to; returns a new table.

        ``expert_ids``: int[T, k] (top-k assignments); ``token_ids``:
        int[T]. One ``hll_accumulate`` launch over the T x k assignments.
        """
        experts = _int64_on(expert_ids, table.device)
        t, k = experts.shape
        keys = _int64_on(token_ids, table.device).reshape(t)
        return hll.insert_table(table, experts.reshape(t * k),
                                keys.repeat_interleave(k), self.cfg)

    def coverage(self, table: torch.Tensor) -> torch.Tensor:
        """Estimated distinct tokens routed to each expert, float32[E]."""
        return hll.estimate(table, self.cfg)

    def overlap(self, table: torch.Tensor, e1: int, e2: int) -> float:
        """|N(e1) ∩ N(e2)| by the Ertl MLE (Eq. 10 on the routing graph)."""
        return float(intersection.mle_intersection(
            table[e1][None], table[e2][None], self.cfg)[0])

    def collapse_score(self, table: torch.Tensor) -> np.ndarray:
        """Pairwise Jaccard estimates, float64[E, E] with a zero diagonal;
        high off-diagonal values flag routing collapse.

        Every pair ``i < j`` comes from one MLE call over all pairs (one
        ``ertl_stats`` launch), each pair as :meth:`overlap` answers it:
        ``inter / max(cov_i + cov_j - inter, 1)``.
        """
        e = self.num_experts
        cov = self.coverage(table).cpu().numpy().astype(np.float64)
        i, j = np.triu_indices(e, k=1)
        idx = torch.from_numpy(np.stack([i, j])).to(table.device)
        inter = intersection.mle_intersection(
            table[idx[0]], table[idx[1]], self.cfg).cpu().numpy()
        inter = inter.astype(np.float64)
        out = np.zeros((e, e))
        out[i, j] = inter / np.maximum(cov[i] + cov[j] - inter, 1.0)
        out[j, i] = out[i, j]
        return out


@dataclass
class NGramSketch:
    """One HLL sketch of the distinct length-``n`` windows of a token
    stream."""

    n: int = 2
    cfg: HLLConfig = field(default_factory=lambda: HLLConfig(p=12))

    def init(self, device=None) -> torch.Tensor:
        """The empty sketch ``uint8[r]`` on ``device`` (``None``: the card,
        which must be present)."""
        return hll.empty(self.cfg, device=device)

    def update(self, sketch: torch.Tensor, tokens) -> torch.Tensor:
        """Insert every length-``n`` window of ``tokens`` int[B, L]; returns
        a new sketch (one ``hll_accumulate`` launch)."""
        h = _window_hashes(_int64_on(tokens, sketch.device), self.n)
        return hll.insert(sketch, h.reshape(-1), self.cfg)

    def distinct(self, sketch: torch.Tensor) -> float:
        """Estimated number of distinct windows inserted."""
        return float(hll.estimate(sketch, self.cfg))

    def merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Cross-shard union (the paper's closed union operator)."""
        return hll.merge(a, b)
