"""propagate_roofline.hops: the frozen bytes bound of a job's Algorithm 2
passes (``costs.rooflines.propagate_bytes`` over HBM's peak) over the
device time of the propagate kernels, %.

The passes of a job are its ``neighborhood(t_max)``'s t_max - 1; the
panel has the graph's n rows of the layout's row bytes; the routing
holds both orientations of every edge."""
from sketchbench.costs import rooflines

#: the propagate kernels, by the names the trace gives them
KERNELS = ("hll_propagate_kernel",)


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
    calls = [c for s in run.profiled for c in s.calls
             if c.spec["call"] == "neighborhood"]
    passes = sum(int(c.args[0]) - 1 for c in calls)
    need = passes * rooflines.propagate_bytes(run.ctx.n, row,
                                              2 * len(run.ctx.edges))
    bound = need / rooflines.peak(run.device["kind"])["hbm_bytes_per_s"]
    return 100.0 * bound / busy
