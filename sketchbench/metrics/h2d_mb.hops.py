"""h2d_mb.hops: host-to-device bytes a job, MB, from the memory copies of
the profiled jobs' trace."""


def read(run):
    tr = run.trace
    if tr is None or not tr.n_steps:
        return None
    moved = tr.copy_bytes("HtoD")
    return moved / tr.n_steps / 1e6 if moved else None
