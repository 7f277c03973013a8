"""Host milliseconds a training step spends in the trainer's dispatch
(``Trainer._dispatch``) outside the replay calls, in which the graph's
launch can block on a full launch queue: the benchmark's host-clock spans
around those calls in the traced window."""


def read(ctx):
    w = ctx.get("train_window")
    if w is None or w["dispatch_s"] is None or not w["steps"]:
        return None
    return w["dispatch_s"] / w["steps"] * 1e3
