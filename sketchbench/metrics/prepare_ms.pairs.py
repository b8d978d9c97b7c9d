"""prepare_ms.pairs: the program's ``pairs.prepare`` spans (the host's
numpy work on a request's pairs: their id checks, split and padding),
summed a request, ms, averaged over the profiled requests."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "pairs.prepare")
