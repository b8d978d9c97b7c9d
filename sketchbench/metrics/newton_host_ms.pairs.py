"""newton_host_ms.pairs: the program's ``intersection.newton`` span (the
host's time to enqueue the Newton tail of one request), ms, averaged
over the profiled requests."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "intersection.newton")
