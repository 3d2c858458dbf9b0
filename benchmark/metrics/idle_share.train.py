"""Percent of the profiled train stretch with nothing running on the device."""

from benchmark.metrics import idle_share


def read(ctx):
    return idle_share(ctx, "train")
