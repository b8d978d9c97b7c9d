"""Check: the T̃(xy) values the last intersection call returned.

A pair's gap is the distance between the program's T̃ and the reference's
MLE, as a share of the reference's estimate of |N(x) ∪ N(y)| (at least
1): the estimator's error scales with the union. The pair statistics,
the estimates that start the MLE and the Newton iterations are judged.

The estimator runs a fixed 50 damped Newton steps. Where the
intersection is small against the union, below the sketch's resolution
(1.04 / sqrt(2^p) of the union, 6.5% at p=8), the likelihood is flat
along it and the iterate wanders: its last value depends on rounding, and
two sound computations (the program on the CPU and on the card, or the
reference on either) land far apart on about 0.1% of pairs. So two
numbers are compared:

* ``pair_gap``: the widest gap over the pairs the reference resolves:
  its T̃ at least ``RESOLVED`` of the union and its ascent settled
  (decided by the reference alone, so a program's answer cannot take
  its pair out);
* ``pair_wide_share``: the share of all pairs whose gap is over
  ``WIDE`` (a share, so that a test's small request reads as a run's).
"""
from __future__ import annotations

import numpy as np
import torch

#: a pair is resolved when the reference's T̃ is at least this share of
#: the union and its ascent settled
RESOLVED = 0.15
#: a gap counted by ``pair_wide_share``
WIDE = 1e-3


def _pairs_iters(record):
    return record.args[0], int(record.kwargs["iters"])


def capture(record, engine):
    """The answers float32[B] as the call returned them."""
    return np.asarray(record.result)


def control(record, ref):
    """The low-precision reference's answers for the same pairs."""
    got, _, _ = ref.pair_mle(*_pairs_iters(record))
    return got.to(torch.float64).cpu().numpy()


def gaps(got, record, ref):
    """(gap, reference T̃, reference union, resolved), [B] each."""
    want, union, settled = ref.pair_mle(*_pairs_iters(record))
    want = want.to(torch.float64)
    union = torch.clamp(union.to(torch.float64), min=1.0)
    got = torch.from_numpy(np.asarray(got, dtype=np.float64)).to(want.device)
    return ((got - want).abs() / union, want, union,
            settled & (want >= RESOLVED * union))


def compare(got, record, ref) -> dict:
    """{"pair_gap": widest gap over resolved pairs, "pair_wide_share":
    share of pairs whose gap is over ``WIDE``}; both infinite if a gap is
    not a number."""
    gap, _, _, resolved = gaps(got, record, ref)
    if not bool(torch.isfinite(gap).all()):
        return {"pair_gap": float("inf"), "pair_wide_share": float("inf")}
    widest = float(gap[resolved].max()) if bool(resolved.any()) else 0.0
    return {"pair_gap": widest,
            "pair_wide_share": float((gap > WIDE).double().mean())}
