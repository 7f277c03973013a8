"""``sdf_mlp``'s share of its roofline at the train cells' launch shape:
the bound (``flops.sdf_mlp_cost``, ``flops.bound_s``) over the kernel's
mean time over many launches by CUDA events."""
from portbench.flops import bound_s, sdf_mlp_cost


def read(ctx):
    k = ctx.get("sdf_mlp")
    if k is None or ctx.get("train_window") is None:
        return None
    return bound_s(*sdf_mlp_cost(k["icfg"], k["rows"])) * 1e3 / k["ms"] * 100
