"""The ray layout of a data-parallel step (port of
``mvsdf_tpu/parallel/sharding.py``).

Layout contract, as in the JAX package: per-ray arrays are (B, P, ...)
with the per-image ray axis P split over the ranks; everything per image
(poses, intrinsics, depth maps, feature maps, MVS cams) is replicated. Under
XLA that layout is all it takes: the compiler inserts the loss and gradient
all-reduce. Here the step does it by hand with the two reductions below:
every loss divides its rank's numerator by a count summed over all ranks
(``sum_counts``, no gradient), so the ranks' losses add up to the
single-process loss, and their gradients are then summed (``sum_``).

Both count what they all-reduce, on the host, where they run: ``ALLREDUCES``
the collectives, ``ALLREDUCE_BYTES`` their bytes. A CUDA graph that
captured them replays the collectives without the Python, so the graph's
owner carries the counts through replays as it carries kernel launches
(``tracing/kernels/counts``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..tracing.kernels.counts import HostCount
from .mesh import DATA_AXIS, rank, world_size

ALLREDUCES, ALLREDUCE_BYTES = HostCount(), HostCount()


def _all_reduce(t: torch.Tensor) -> None:
    ALLREDUCES.launches += 1
    ALLREDUCE_BYTES.launches += t.numel() * t.element_size()
    dist.all_reduce(t)


def validate_ray_divisibility(num_pixels: int,
                              world: Optional[int] = None) -> None:
    """Fail loud on a silent remainder drop: the per-image ray axis must
    split evenly over the ranks."""
    n = world_size() if world is None else world
    if num_pixels % n != 0:
        raise ValueError(
            f"num_pixels={num_pixels} is not divisible by the world size "
            f"{n}: the ray axis cannot shard evenly over '{DATA_AXIS}' "
            f"({num_pixels % n} rays per image would be dropped)")


def host_ray_slice(num_pixels: int) -> slice:
    """This rank's slice of the per-image ray axis (the pixel subset itself
    is drawn identically on every rank)."""
    validate_ray_divisibility(num_pixels)
    per = num_pixels // world_size()
    r = rank()
    return slice(r * per, (r + 1) * per)


def shard_bounds(n: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's share of an axis of n entries that need not
    divide evenly (the P // 2 eikonal and depth-surface samples)."""
    w, r = world_size(), rank()
    return n * r // w, n * (r + 1) // w


def sum_counts(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, detached: the global count a loss
    divides by. One process: ``t`` itself."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    _all_reduce(out)
    return out


def sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, in one all-reduce of their
    flat concatenation (all on one device and of one dtype). Under CUDA
    graph capture the flat buffer comes from the graph's pool, at one
    address for every replay."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n
