"""routing_ms.hops: the program's ``routing.build`` spans (the edge list
copied to the card and turned into the dst-sorted propagate routing
there, slice by slice), summed a job, ms, averaged over the profiled
jobs."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "routing.build")
