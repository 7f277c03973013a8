"""Host milliseconds a training step spends in the trainer's chunk planning
(``Trainer._plan_chunk``: each epoch's pixel subset and image order, the
plan rows), while the device runs what is queued or waits: the benchmark's
host-clock spans around those calls in the traced window."""


def read(ctx):
    w = ctx.get("train_window")
    if w is None or w["plan_s"] is None or not w["steps"]:
        return None
    return w["plan_s"] / w["steps"] * 1e3
