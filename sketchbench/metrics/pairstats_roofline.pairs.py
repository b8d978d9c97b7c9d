"""pairstats_roofline.pairs: the frozen bytes bound of the profiled
requests' pair statistics (``costs.rooflines.pairstats_bytes`` over
HBM's peak) over the device time of the ``intersection_stats`` kernels,
%. A request's rows are the distinct vertices of its pairs."""
import numpy as np

from sketchbench.costs import rooflines

#: the pair-statistics kernels, by the names the trace gives them
KERNELS = ("intersection_stats_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not tr.n_steps:
        return None
    busy = tr.device_s(KERNELS, ("kernel",))
    if busy <= 0:
        return None
    cfg = run.ctx.config
    r = 1 << cfg["sketch"]["p"]
    row = r // 2 if cfg["layout"] == "packed" else r
    need = 0
    for s in run.profiled:
        for c in s.calls:
            if c.spec["call"] == "intersection_size":
                pairs = np.asarray(c.args[0])
                need += rooflines.pairstats_bytes(
                    len(pairs), np.unique(pairs).size, row,
                    64 - cfg["sketch"]["p"])
    bound = need / rooflines.peak(run.device["kind"])["hbm_bytes_per_s"]
    return 100.0 * bound / busy
