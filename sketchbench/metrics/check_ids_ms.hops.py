"""check_ids_ms.hops: the program's ``engine.check_ids`` spans (the host's
min/max over an edge block and its int32 cast), summed a job, ms,
averaged over the profiled jobs."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "engine.check_ids")
