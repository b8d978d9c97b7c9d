"""pair_rate: pairs answered in the window over the window's length (its
start to the end of its last request)."""


def read(run):
    return sum(s.work for s in run.steps if not s.failed) / run.window_s
