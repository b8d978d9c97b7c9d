"""newton_device_ms.pairs: device time of the operations launched inside
the program's ``intersection.newton`` span (the Newton tail's kernels,
also those that run after the span has ended), ms, averaged over the
profiled requests."""
from sketchbench import spans


def read(run):
    return spans.device_ms(run, "intersection.newton")
