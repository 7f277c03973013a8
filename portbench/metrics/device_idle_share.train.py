"""The share of a profiled window of whole chunks in which no operation
ran on the device: 1 - the union of the device events' intervals over the
window."""


def read(ctx):
    p = ctx.get("profile")
    if p is None or ctx.get("train_window") is None:
        return None
    return (1 - p["busy_s"] / p["window_s"]) * 100
