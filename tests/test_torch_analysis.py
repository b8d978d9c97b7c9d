"""The port's sketch cost model (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): ``sketch_op_costs`` and ``roofline_terms``
equal exactly (the same float dicts) on a grid of shapes, the same
errors, the dominance checks of ``tests/test_analysis.py`` with the
port's default ``HW``, and that default: the H100 SXM's data-sheet
figures."""
import itertools

import pytest

from repro.analysis import flops as jax_flops
from repro.analysis import roofline as jax_roofline
from repro_torch.analysis import HW, roofline_terms, sketch_op_costs
from repro_torch.analysis import flops

LARGE = {"n": 1 << 22, "edges": 1 << 23, "sets": 4096, "set_size": 64,
         "pairs": 1 << 18}


def test_sketch_ops_and_hash_cost_match():
    assert flops.SKETCH_OPS == jax_flops.SKETCH_OPS
    assert flops._HASH_FLOPS == jax_flops._HASH_FLOPS


@pytest.mark.parametrize("layout", ["byte", "packed"])
@pytest.mark.parametrize("shapes", [{}, LARGE], ids=["default", "large"])
def test_sketch_op_costs_equal_the_jax_model(layout, shapes):
    for op, p in itertools.product(flops.SKETCH_OPS, range(4, 17)):
        got = sketch_op_costs(op, p=p, layout=layout, **shapes)
        want = jax_flops.sketch_op_costs(op, p=p, layout=layout, **shapes)
        assert got == want, (op, p)
        assert flops._lane_width(p, layout) == jax_flops._lane_width(
            p, layout)


def test_sketch_op_costs_errors_match():
    for bad_op in ("ertl_stats", "hip_delta", "nope"):
        with pytest.raises(ValueError, match="op must be one of"):
            sketch_op_costs(bad_op, p=8)
        with pytest.raises(ValueError, match="op must be one of"):
            jax_flops.sketch_op_costs(bad_op, p=8)
    with pytest.raises(ValueError, match="unknown layout"):
        sketch_op_costs("estimate", p=8, layout="nibble")
    with pytest.raises(ValueError, match="unknown layout"):
        jax_flops.sketch_op_costs("estimate", p=8, layout="nibble")


def test_roofline_terms_equal_the_jax_function():
    """The same fields and values for the same ``HW`` on both sides."""
    rates = [(197e12, 819e9, 50e9), (989e12, 3.35e12, 25e9), (1.0, 2.0, 3.0)]
    amounts = [0.0, 1.0, 3.5e9, 2.0e12, 7.9e15]
    for (peak, hbm, link), f, b, w in itertools.product(rates, amounts,
                                                        amounts, amounts):
        got = roofline_terms(f, b, w, HW(peak, hbm, link))
        want = jax_roofline.roofline_terms(
            f, b, w, jax_roofline.HW(peak, hbm, link))
        assert got == want


def test_roofline_dominance():
    hw = HW()
    r = roofline_terms(hw.peak_flops, 0.0, 0.0, hw)  # exactly 1 s compute
    assert r["dominant"] == "compute" and r["compute_fraction"] == 1.0
    r = roofline_terms(1.0, hw.hbm_bw * 2, 0.0, hw)  # 2 s of HBM
    assert r["dominant"] == "memory" and r["bound_s"] == pytest.approx(2.0)
    r = roofline_terms(1.0, 1.0, hw.link_bw * 3, hw)  # 3 s on one link
    assert r["dominant"] == "collective"
    assert roofline_terms(0.0, 0.0, 0.0)["compute_fraction"] == 0.0


def test_default_hw_is_the_h100_sxm():
    """989 TFLOP/s dense bf16, 3.35 TB/s HBM3, one NVLink 4 link one way
    (900 GB/s over 18 links, both directions)."""
    assert HW() == HW(peak_flops=989e12, hbm_bw=3.35e12, link_bw=25e9)
    assert HW().link_bw * 18 * 2 == 900e9


def test_sketch_bounds_are_memory_bound_on_the_h100():
    """At the sweep's shapes every modeled op is bound by device memory."""
    for op, layout in itertools.product(flops.SKETCH_OPS,
                                        ("byte", "packed")):
        c = sketch_op_costs(op, p=8, layout=layout, **LARGE)
        r = roofline_terms(c["flops"], c["hbm_bytes"], 0.0)
        assert r["dominant"] == "memory"
        assert r["bound_s"] == c["hbm_bytes"] / 3.35e12
