"""Analytic cost model of the sketch kernels (port of the sketch half of
``repro.analysis``): the H100's roofline terms (``roofline``) and the
per-op HBM-byte and FLOP models (``flops``). The model half of the JAX
package (per-cell FLOPs of its language models, HLO collective parsing)
waits for the port's model substrate."""
from repro_torch.analysis.flops import SKETCH_OPS, sketch_op_costs  # noqa: F401
from repro_torch.analysis.roofline import HW, roofline_terms  # noqa: F401
