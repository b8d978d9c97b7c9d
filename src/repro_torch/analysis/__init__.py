"""Analytic cost model (port of ``repro.analysis``): the H100's roofline
terms and the model FLOPs of the 6*N*D rule (``roofline``), the
language models' per-cell FLOPs and bytes and the sketch kernels'
per-op byte and FLOP models (``flops``), and collective parsing and
per-device wire bytes (``hlo``)."""
from repro_torch.analysis.flops import (  # noqa: F401
    SKETCH_OPS, CellCosts, cell_bytes, cell_costs, cell_flops,
    sketch_op_costs)
from repro_torch.analysis.hlo import (  # noqa: F401
    Collective, collective_wire_bytes, parse_collectives)
from repro_torch.analysis.roofline import (  # noqa: F401
    HW, active_params, model_flops, roofline_terms)
