"""The training step's model operations (``flops.step_flops``, its data-
dependent counts from the plain reference trace on the state at the
window's end) over the window's seconds per step, as a share of one
H100's bf16 peak."""
from portbench.flops import PEAK_BF16, step_flops


def read(ctx):
    w, c = ctx.get("train_window"), ctx.get("step_counts")
    if w is None or c is None or not w["steps"]:
        return None
    ops = step_flops(c["icfg"], c["rcfg"], c["B"], c["P"], c["trace_rows"],
                     c["hits"], c["dsurf"], c["detach_geometry"])
    return ops / (w["seconds"] / w["steps"]) / PEAK_BF16 * 100
