"""The sharded backend's primitives: the routing plan, the propagate
schedules over per-shard panels, the sharded triangle queries
(``sketch_dist``) and the distributed top-k (``topk``)."""
from repro_torch.distributed.sketch_dist import (  # noqa: F401
    DistPlan, build_plan, dist_accumulate, dist_propagate_allgather,
    dist_propagate_ring, dist_triangle_heavy_hitters, vertex_partition,
)
from repro_torch.distributed.topk import distributed_topk  # noqa: F401
