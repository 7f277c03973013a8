"""Rays of the training steps completed in the window over its wall time
(host clock; the window is whole chunks, ended by a device sync)."""


def read(ctx):
    w = ctx.get("train_window")
    return None if w is None else w["rays"] / w["seconds"]
