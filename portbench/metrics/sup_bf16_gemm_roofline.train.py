"""The supervised SDF network's bf16 products' share of their roofline at
the step's rows: the model's nine layer shapes at a layer's rows a step
(the ``bf16_gemm_rows`` counter over the window, over the layers); the
bounds (``flops_bf16.bf16_gemm_cost``, ``flops.bound_s``: the bf16 peak or
the bytes, whichever binds) over the CUDA-event times
(``drivers/train_bf16``)."""
from portbench.flops_bf16 import bf16_gemm_cost, share


def read(ctx):
    k = ctx.get("bf16_gemm")
    if k is None or ctx.get("train_window") is None:
        return None
    return share([bf16_gemm_cost(k["rows"], K, N) for K, N in k["shapes"]],
                 k["ms"])
