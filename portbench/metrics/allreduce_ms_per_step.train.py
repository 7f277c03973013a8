"""Rank 0's device milliseconds a step from the stamp after the gradients
(``autograd.grad``) to the stamp after their all-reduce (``sum_``), the
median over the traced chunks' replays of a data-parallel cell: the
collective, and the wait for the slowest rank to reach it."""


def read(ctx):
    d = ctx.get("ddp")
    return None if d is None else d["allreduce_ms"]
