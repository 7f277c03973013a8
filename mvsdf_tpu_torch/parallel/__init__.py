"""Data parallelism over ``torch.distributed`` (port of
``mvsdf_tpu/parallel/``): one process per GPU, the per-image ray axis P
split over the processes, everything else replicated."""
from .mesh import DATA_AXIS, barrier, init_distributed, rank, world_size
from .sharding import (host_ray_slice, shard_bounds, sum_counts, sum_,
                       validate_ray_divisibility)
