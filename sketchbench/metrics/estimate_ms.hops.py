"""estimate_ms.hops: the program's ``engine.estimate`` spans (each hop's
row estimates, their blocking copy back, the host sum and the row
written into the answer), summed over a job's 8 hops, ms, averaged over
the profiled jobs."""
from sketchbench import spans


def read(run):
    return spans.host_ms(run, "engine.estimate")
