"""Deterministic synthetic token pipeline (restart-exact, shard-aware);
a copy of ``repro.data.pipeline``, numpy only.

``batch_for_step(step)`` is a pure function of (seed, step, shard) — the
fault-tolerance contract: a restarted trainer regenerates exactly the
batches it would have seen (no data-loader state to checkpoint). The
corpus is a seeded order-1 Markov chain over the vocab with Zipf marginals
— enough structure that a model's loss visibly decreases within a few
hundred steps, while staying offline-generable. Batches are host numpy
arrays equal to the JAX package's for any seed, step, shard and shard
count; ``train_loop``'s ``to_device`` moves them onto the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SyntheticCorpus", "batch_for_step"]


@dataclass
class SyntheticCorpus:
    """A seeded order-1 Markov token stream with Zipf marginals.

    ``batch(step)`` is this shard's ``global_batch // num_shards`` rows
    of ``seq_len`` tokens, a pure function of ``(seed, step, shard)``.
    """

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_shards: int = 1
    shard: int = 0
    zipf_a: float = 1.3
    state_period: int = 64

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipf marginal over a permuted vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        probs /= probs.sum()
        self._perm = rng.permutation(v)
        self._probs = probs
        # order-1 structure: next token depends on current token's bucket
        self._shift = rng.integers(1, v, size=self.state_period)

    def _sample(self, rng: np.random.Generator, shape) -> np.ndarray:
        flat = rng.choice(self.vocab_size, size=int(np.prod(shape)),
                          p=self._probs)
        toks = self._perm[flat].reshape(shape).astype(np.int64)
        # markov-ify: even positions perturb the next token deterministically
        out = toks.copy()
        for t in range(1, shape[-1]):
            bucket = out[..., t - 1] % self.state_period
            mix = (out[..., t - 1] + self._shift[bucket]) % self.vocab_size
            take_prev = (out[..., t] % 4) == 0   # 25%: predictable continuation
            out[..., t] = np.where(take_prev, mix, out[..., t])
        return out

    def batch(self, step: int) -> dict:
        """Shard-local slice of the global batch for ``step``."""
        per_shard = self.global_batch // self.num_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard)
        toks = self._sample(rng, (per_shard, self.seq_len + 1))
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": np.ones((per_shard, self.seq_len), np.float32),
        }


def batch_for_step(corpus: SyntheticCorpus, step: int) -> dict:
    """``corpus.batch(step)``: the batch a (re)started trainer sees."""
    return corpus.batch(step)
