"""launches_per_req.pairs: device kernel launches a request, counted in
the profiled requests' trace."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_steps:
        return None
    return tr.count("kernel") / tr.n_steps or None
