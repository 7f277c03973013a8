"""The median over the traced replays of a data-parallel cell of the
spread, over the ranks, of each rank's device milliseconds from its step's
start to its gradient all-reduce's entry (the stamp after
``autograd.grad``): how long the first rank there waits for the last.
Durations on each card's own clock, since the cards' clocks are not one."""


def read(ctx):
    d = ctx.get("ddp")
    return None if d is None else d["rank_skew_ms"]
