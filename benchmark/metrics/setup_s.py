"""Seconds from the process's start to the window's first call (host clock)."""


def read(ctx):
    return ctx.setup_s
