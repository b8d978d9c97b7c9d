"""The frozen roofline counts."""
from __future__ import annotations

import pytest

from sketchbench.costs import rooflines


def test_propagate_bound_at_scale_22_byte():
    # 4,194,304 rows of 256 bytes read and written, 128,302,398 directed
    # edges of two int32 ids: 3.17 GB, 0.9474 ms at 3.35 TB/s
    need = rooflines.propagate_bytes(1 << 22, 256, 128_302_398)
    assert need == pytest.approx(3.174e9, rel=1e-3)
    bw = rooflines.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    assert need / bw * 1e3 == pytest.approx(0.9474, abs=5e-5)


def test_pairstats_bytes_by_hand():
    # 3 pairs over 4 distinct rows of 128 bytes at q = 56: the rows once,
    # 8 bytes of ids a pair, 5 x 58 + 6 float32 out a pair
    assert rooflines.pairstats_bytes(3, 4, 128, 56) == (
        4 * 128 + 3 * 8 + 3 * 4 * (5 * 58 + 6))


def test_no_peaks_for_an_unknown_chip():
    with pytest.raises(KeyError):
        rooflines.peak("cpu")
