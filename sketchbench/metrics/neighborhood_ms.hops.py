"""neighborhood_ms.hops: the benchmark's span around ``neighborhood``
(a host clock ending in a device synchronize), ms, averaged over the
profiled jobs."""


def read(run):
    spans = [s.spans["neighborhood"] for s in run.profiled
             if "neighborhood" in s.spans]
    return 1e3 * sum(spans) / len(spans) if spans else None
