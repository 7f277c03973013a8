"""The gradient all-reduce's share of its roofline: the bytes each card's
links move in it (``collectives.bus_bytes``: 2 (n - 1) / n of the float32
gradients and metric shares) over rank 0's all-reduce time
(``allreduce_ms_per_step.train``), as a share of one card's NVLink peak
in one direction (``collectives.NVLINK_BYTES_S``)."""
from portbench.collectives import NVLINK_BYTES_S, bus_bytes


def read(ctx):
    d = ctx.get("ddp")
    if d is None or not d["allreduce_ms"] > 0:
        return None
    return bus_bytes(d["model"], d["world"]) / (d["allreduce_ms"] / 1e3) / \
        NVLINK_BYTES_S * 100
