"""The activation's bf16 entries' share of their roofline at the step's
rows: one launch of each, as a hidden layer launches them, at a layer's
rows a step (the ``bf16_gemm_rows`` counter over the window, over the SDF
network's layers) x 512; the bounds (``flops_bf16.act_bf16_cost``,
``flops.bound_s``) over the CUDA-event times (``drivers/train_bf16``)."""
from portbench.flops_bf16 import act_bf16_cost, share


def read(ctx):
    k = ctx.get("act_bf16")
    if k is None or ctx.get("train_window") is None:
        return None
    entries = list(k["ms"])
    return share([act_bf16_cost(e, k["rows"], k["cols"]) for e in entries],
                 [k["ms"][e] for e in entries])
