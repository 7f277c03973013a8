"""Bytes of the data-parallel training step's gradient all-reduce, and the
link peak of one card, in ``flops.py``'s style.

The step sums, over the ranks, every parameter's gradient and its metric
shares (the six loss terms and the hit fraction) in one float32
all-reduce (``mvsdf_tpu_torch/parallel/sharding.sum_``). A ring
all-reduce of S bytes over n cards moves 2 (n - 1) / n x S bytes through
each card's links (NCCL's bus bandwidth counts the same).

Peak: one H100 SXM card of the four-card host the benchmark's
data-parallel cell runs on (NVIDIA H100 80GB HBM3, 700 W), whose
``nvidia-smi nvlink -s`` lists 18 NVLink links of 26.562 GB/s each:
478.1 GB/s, the most one card's links carry in one direction
(``nvidia-smi topo -m`` did not run there).
"""
from __future__ import annotations

from .weights import implicit_shapes, render_shapes

NVLINK_LINKS = 18
NVLINK_LINK_BYTES_S = 26.562e9
NVLINK_BYTES_S = NVLINK_LINKS * NVLINK_LINK_BYTES_S
# the metric shares summed with the gradients: six loss terms, hit_frac
METRIC_SHARES = 7


def parameters(model: dict) -> int:
    """The model's parameters: each weight-normed layer's ``v`` (d_in x
    d_out), ``g`` and bias (d_out each), both networks."""
    shapes = implicit_shapes(model["implicit"]) + \
        render_shapes(model["render"])
    return sum(i * o + 2 * o for i, o in shapes)


def gradient_allreduce_bytes(model: dict) -> int:
    """Bytes of the step's gradient all-reduce: float32 gradients and
    metric shares."""
    return 4 * (parameters(model) + METRIC_SHARES)


def bus_bytes(model: dict, world: int) -> float:
    """Bytes each card's links move in that all-reduce over ``world``
    cards (ring): 2 (n - 1) / n of it."""
    return 2 * (world - 1) / world * gradient_allreduce_bytes(model)
