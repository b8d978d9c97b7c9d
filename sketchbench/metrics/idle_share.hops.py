"""The device's idle share of the profiled steps, %: one minus the union
of its operations' intervals over the traced window."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
