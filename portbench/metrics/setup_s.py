"""Seconds from the process's start to the window's (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
