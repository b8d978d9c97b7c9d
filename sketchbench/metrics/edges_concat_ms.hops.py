"""edges_concat_ms.hops: the program's ``engine.edges`` spans (the host's
concatenation of the ingested edge chunks into one list), summed a job,
ms, averaged over the profiled jobs."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "engine.edges")
